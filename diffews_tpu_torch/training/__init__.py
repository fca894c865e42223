"""Training: the train state and step, optimizer, LR schedules and EMA."""
