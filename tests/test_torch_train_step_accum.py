"""Port parity: two training steps with gradient accumulation (gas 2) and
the attn-mask conditioning variant against the JAX `make_train_step`; the
checks are `test_torch_train_step.check_two_steps`'s."""

from test_torch_train_step import check_two_steps
from test_torch_training import models  # noqa: F401
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_two_accumulated_train_steps_match_jax(models):
    check_two_steps(models, gas=2, variant=True)
