"""Tracing and profiling hooks (port of `diffews_tpu/utils/profiling.py`).

  - `annotate(name)`: the port's span.  Off (the default) it is one shared
    null context after a single read of a module global: no allocation,
    no string formatting, no torch call.  On (`spans_on()`) it is a
    `torch.profiler.record_function(name)` range, so a span lands in the
    profiler's trace on the same clock as the CUDA activity it launched;
  - `spans_on()`: spans on for the body, then back as they were;
  - `trace(logdir)`: a `torch.profiler` capture of the CPU and, where a card
    is present, CUDA activity, with spans on, written as a Chrome trace
    into `logdir` (open it in chrome://tracing or Perfetto);
  - `launch_counts()`: the port's kernel launch counters by kernel;
  - `StageTimer`: host-side stage timing that waits for the device at the
    end of each stage, for per-stage latency breakdowns in harness logs.

Span names are constant strings `diffews.<module>.<part>`: the pipeline's
stages (`pipeline.py`), the models' blocks and modules (`models/unet.py`,
`models/vae.py`) and the training step's parts (`training/state.py`,
`training/optim.py`).  No kernel wrapper opens a span per launch: the
launch counters count those.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_SPANS = False
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named `name` while spans are on, else the shared null
    context."""
    if not _SPANS:
        return _OFF
    return record_function(name)


@contextlib.contextmanager
def spans_on() -> Iterator[None]:
    """Spans on for the body (on every thread, the autograd engine's too),
    then as they were before."""
    global _SPANS
    before, _SPANS = _SPANS, True
    try:
        yield
    finally:
        _SPANS = before


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the body with spans on; the trace lands in
    `logdir/trace_<pid>_<ns>.json`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    with spans_on():
        prof.start()
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(
                os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def launch_counts() -> Dict[str, int]:
    """Launches since the process started (or the counter was last
    zeroed) of each of the port's CUDA kernels, read from the counters the
    kernel wrappers keep (`<wrapper>.launches`); `int_mm` counts the int8
    linears' `torch._int_mm` calls, `adamw_layout_copies` the gradients
    the optimizer kernels first copied into their master's layout."""
    from diffews_tpu_torch.ops import adamw, downsample, fused_resnet, groupnorm, quant
    from diffews_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.dq_launches,
            "flash_attention_bwd_dkv": flash_attention_bwd.dkv_launches,
            "gn_stats": groupnorm.gn_stats_kernel.launches,
            "gn_apply": groupnorm.gn_apply_kernel.launches,
            "fused_gn_silu_conv3x3": fused_resnet.gn_silu_conv3x3.launches,
            "downsample_conv2x": downsample.downsample_conv2x.launches,
            "quantize_s8": quant.quantize_s8.launches,
            "conv2d_int8": quant.conv2d_int8.launches,
            "int_mm": quant.linear_int8.launches,
            "adamw_norm": adamw.norm_pass.launches,
            "adamw_finalise": adamw.finalise_pass.launches,
            "adamw_apply": adamw.apply_pass.launches,
            "adamw_layout_copies": adamw.match_layouts.layout_copies}


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
