"""The traced stretch: `torch.profiler` over a few steps of the window,
reduced in memory to what the per-layer readers need.

Ranges: the harness opens `record_function` ranges around its own calls
("bench.step" around each step of the loop, "bench.enqueue" around the
call that queues a batch, "bench.result" around the wait for one, and
"bench.vae" / "bench.unet" around the pipeline's calls into its models).
A device op belongs to a range when the host op that launched it started
inside that range.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import torch

RANGES = ("bench.step", "bench.enqueue", "bench.result", "bench.vae", "bench.unet")
_CLASSES = json.loads((Path(__file__).parent / "kernel_classes.json").read_text())


def kernel_class(name: str) -> str:
    n = name.lower()
    for key, cls in _CLASSES["rules"]:
        if key in n:
            return cls
    return _CLASSES["other"]


@dataclass
class Trace:
    """A traced stretch of `steps` loop steps (each queues one batch).

    window: (start, end) µs in the profiler's time base, from the first
      device op to the end of the last step;
    ops: device ops inside the window, (name, start µs, end µs);
    launched: per range name, (device op name, µs) of the ops launched
      from inside it;
    gaps: the device's idle gaps in the window, (what the host was doing,
      µs)."""

    steps: int
    window: Tuple[float, float]
    ops: List[Tuple[str, float, float]]
    launched: Dict[str, List[Tuple[str, float]]]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which some device op ran (overlaps counted once)."""
        busy, end = 0.0, self.window[0]
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, end), min(e, self.window[1])
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def class_s_per_step(self, range_name: str = "bench.enqueue") -> Dict[str, float]:
        """Device seconds per step by kernel class, of the ops launched in
        `range_name`."""
        out: Dict[str, float] = {}
        for name, us in self.launched.get(range_name, []):
            c = kernel_class(name)
            out[c] = out.get(c, 0.0) + us / 1e6 / self.steps
        return out

    def range_s_per_step(self, range_name: str) -> float:
        return sum(us for _, us in self.launched.get(range_name, [])) / 1e6 / self.steps

    def top_ops(self, k: int = 10) -> list:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name[:160]] = by.get(name[:160], 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> list:
        by: Dict[str, float] = {}
        for label, us in self.gaps:
            by[label] = by.get(label, 0.0) + us / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _inside(intervals, t) -> bool:
    i = bisect.bisect_right(intervals[0], t) - 1
    return i >= 0 and t <= intervals[1][i]


def reduce_events(events, steps: int) -> Trace:
    """A `Trace` from profiler events that offer `name`, `device_type`
    ("cpu" or "cuda"), `start`, `end` (µs) and, on host ops, `kernels`
    ((name, µs) of the device ops they launched)."""
    ranges: Dict[str, list] = {r: [] for r in RANGES}
    host, ops, launchers = [], [], []
    for e in events:
        if e["device_type"] == "cuda":
            if e["name"] not in ranges:
                ops.append((e["name"], e["start"], e["end"]))
            continue
        if e["name"] in ranges:
            ranges[e["name"]].append((e["start"], e["end"]))
        else:
            host.append(e)
        if e.get("kernels"):
            launchers.append(e)
    spans = {r: ([s for s, _ in sorted(v)], [t for _, t in sorted(v)]) for r, v in ranges.items()}
    launched: Dict[str, list] = {r: [] for r in RANGES}
    for e in launchers:
        for r in RANGES:
            if _inside(spans[r], e["start"]):
                launched[r].extend(e["kernels"])
    steps_end = max((t for _, t in ranges["bench.step"]), default=0.0)
    first = min((s for _, s, _ in ops), default=steps_end)
    window = (first, max(steps_end, first))
    ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    return Trace(steps, window, ops, launched, _gaps(ops, window, host, spans))


def _gaps(ops, window, host, spans, keep: int = 200):
    """The longest idle gaps, each named by the bench range and the
    innermost host op that was running when the device fell idle."""
    gaps, end = [], window[0]
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    if window[1] > end:
        gaps.append((end, window[1] - end))
    gaps = sorted(gaps, key=lambda g: -g[1])[:keep]
    host = sorted(host, key=lambda e: e["start"])
    starts = [e["start"] for e in host]
    out = []
    for t, us in gaps:
        outer = next((r for r in ("bench.vae", "bench.unet", "bench.enqueue", "bench.result")
                      if _inside(spans[r], t)), "bench.step" if _inside(spans["bench.step"], t)
                     else "outside steps")
        op = "python"
        for j in range(bisect.bisect_right(starts, t) - 1, max(-1, bisect.bisect_right(starts, t) - 4000), -1):
            if host[j]["end"] >= t:
                op = host[j]["name"]
                break
        out.append((f"{outer}/{op}", us))
    return out


def profiler_events(prof) -> list:
    """`prof.events()` as plain dicts for `reduce_events`."""
    out = []
    for e in prof.events():
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        out.append({"name": e.name, "device_type": "cuda" if cuda else "cpu",
                    "start": float(e.time_range.start), "end": float(e.time_range.end),
                    "kernels": [] if cuda else [(k.name, float(k.duration)) for k in e.kernels]})
    return out


@contextlib.contextmanager
def ranges_on(pipe):
    """`bench.vae` / `bench.unet` ranges around the pipeline's calls into
    its models, set on the instances and taken off again."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    targets = [(pipe.vae, "encode_mean_latent", "bench.vae"), (pipe.vae, "decode", "bench.vae"),
               (pipe.unet, "forward", "bench.unet")]
    for obj, attr, name in targets:
        setattr(obj, attr, wrap(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, _ in targets:
            delattr(obj, attr)
