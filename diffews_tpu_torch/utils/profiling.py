"""Tracing and profiling hooks (port of `diffews_tpu/utils/profiling.py`).

  - `trace(logdir)`: a `torch.profiler` capture of the CPU and, where a card
    is present, CUDA activity, written as a Chrome trace into `logdir`
    (open it in chrome://tracing or Perfetto);
  - `annotate(name)`: a `record_function` range, visible in the trace;
  - `StageTimer`: host-side stage timing that waits for the device at the
    end of each stage, for per-stage latency breakdowns in harness logs.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the body; the trace lands in `logdir/trace_<pid>_<ns>.json`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)


class StageTimer:
    """Per-stage wall totals.  `sync` waits for `device` (a CUDA device; the
    current one when None and a card is present) at the end of each
    stage, so a stage's time includes the device work it queued."""

    def __init__(self, sync: bool = True, device=None):
        self.sync = sync
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _wait(self):
        if self.device is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        elif torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # count the stage even when its body raises: a crashing stage
            # still spent the time, and losing it skews the breakdown
            if self.sync:
                self._wait()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            rows.append(f"{name}: {tot:.3f}s total, {tot / n * 1e3:.1f} ms/call x{n}")
        return "\n".join(rows)
