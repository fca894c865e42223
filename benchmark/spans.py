"""The port's program spans (`diffews.*` `record_function` ranges, which
`diffews_tpu_torch.utils.profiling.spans_on()` turns on) reduced from the
same profiler events as `trace.reduce_events`, on the same clock.

For each span name, per loop step of the traced stretch:
  - calls;
  - host ms, inclusive, and self: the span's time less what its child
    spans cover;
  - device ms of the ops launched inside it, inclusive, and of those
    launched in its self part: a device op belongs to the innermost span
    whose interval holds the start of the host op that launched it, on any
    thread (the autograd engine's thread launches the backward);
  - CUDA launch calls that start inside it, on any thread;
  - its self device ms by kernel class (`kernel_classes.json`).

Spans nest (the autograd thread's lie inside the main thread's
`diffews.train.backward`, which waits for them), so each span's parent is
the innermost span that holds it.

The profiler also puts a copy of each `record_function` range on the
device's timeline, over the kernels launched inside it; `trace.py` leaves
out those of its own ranges (`trace.RANGES`), and `without_device_spans`
those of the program's, which would otherwise count as device ops: busy
time, top ops and idle gaps.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from benchmark import trace as trace_lib

PREFIX = "diffews."
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaGraphLaunch"))


def without_device_spans(events) -> list:
    """`events` without the program spans' copies on the device's
    timeline."""
    return [e for e in events if e["device_type"] != "cuda" or not e["name"].startswith(PREFIX)]


class Spans:
    """The program spans of a list of profiler events (the plain dicts of
    `trace.profiler_events`)."""

    def __init__(self, events):
        ev = sorted((e for e in events if e["device_type"] == "cpu"
                     and e["name"].startswith(PREFIX)), key=lambda e: (e["start"], -e["end"]))
        self.events = ev
        self.starts = [e["start"] for e in ev]
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, e in enumerate(ev):
            while stack and ev[stack[-1]]["end"] <= e["start"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)
        self.launchers = [e for e in events if e["device_type"] == "cpu"
                          and (e.get("kernels") or e["name"] in LAUNCH_CALLS)]

    def innermost_index(self, t: float) -> Optional[int]:
        """The innermost span open at host time `t`, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if self.events[i]["end"] >= t:
                return i
            i = self.parent[i]
        return None

    def innermost(self, t: float) -> Optional[str]:
        i = self.innermost_index(t)
        return None if i is None else self.events[i]["name"]

    def where(self, i: int) -> str:
        """The span event `i` named with its parent's name:
        `<parent>/<span>`."""
        p = self.parent[i]
        name = self.events[i]["name"]
        return name if p is None else f"{self.events[p]['name']}/{name}"

    def top_kernels(self, steps: int, k: int = 10) -> list:
        """The `k` device kernels (by name) with the most device ms per
        step launched inside any span: [name, ms, {`where` of the
        innermost span: ms}]."""
        by: Dict[str, dict] = {}
        for h in self.launchers:
            i = self.innermost_index(h["start"])
            if i is None:
                continue
            for name, us in h.get("kernels") or ():
                at = by.setdefault(name[:160], {})
                at[self.where(i)] = at.get(self.where(i), 0.0) + us / 1e3 / steps
        top = sorted(by.items(), key=lambda kv: -sum(kv[1].values()))[:k]
        return [[n, sum(at.values()), dict(sorted(at.items(), key=lambda kv: -kv[1]))]
                for n, at in top]

    def _names_up(self, i: Optional[int]) -> set:
        names = set()
        while i is not None:
            names.add(self.events[i]["name"])
            i = self.parent[i]
        return names

    def table(self, steps: int) -> Dict[str, dict]:
        """Per span name, per step: calls, host_ms, self_ms, device_ms,
        self_device_ms, launches and self_device_ms_by_class."""
        rows: Dict[str, dict] = {}
        row = lambda n: rows.setdefault(n, {"calls": 0.0, "host_ms": 0.0, "self_ms": 0.0,
                                            "device_ms": 0.0, "self_device_ms": 0.0,
                                            "launches": 0.0, "self_device_ms_by_class": {}})
        children: Dict[int, list] = {}
        for i, p in enumerate(self.parent):
            if p is not None:
                children.setdefault(p, []).append(i)
        for i, e in enumerate(self.events):
            r = row(e["name"])
            r["calls"] += 1
            r["host_ms"] += e["end"] - e["start"]
            covered, end = 0.0, e["start"]
            for c in sorted(children.get(i, ()), key=lambda c: self.events[c]["start"]):
                s, t = max(self.events[c]["start"], end), min(self.events[c]["end"], e["end"])
                if t > s:
                    covered += t - s
                    end = t
            r["self_ms"] += e["end"] - e["start"] - covered
        for h in self.launchers:
            i = self.innermost_index(h["start"])
            if i is None:
                continue
            us = sum(d for _, d in h.get("kernels") or ())
            for name in self._names_up(i):
                r = row(name)
                r["device_ms"] += us
                r["launches"] += h["name"] in LAUNCH_CALLS
            r = row(self.events[i]["name"])
            r["self_device_ms"] += us
            by = r["self_device_ms_by_class"]
            for k, d in h.get("kernels") or ():
                c = trace_lib.kernel_class(k)
                by[c] = by.get(c, 0.0) + d
        for r in rows.values():
            for k in ("host_ms", "self_ms", "device_ms", "self_device_ms"):
                r[k] /= 1e3 * steps
            r["calls"] /= steps
            r["launches"] /= steps
            r["self_device_ms_by_class"] = {c: v / 1e3 / steps for c, v in sorted(
                r["self_device_ms_by_class"].items(), key=lambda kv: -kv[1])}
        return dict(sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"]))


def idle_gaps(events, tr: trace_lib.Trace, spans: Spans, k: int = 10) -> list:
    """The device's idle gaps in the traced window, in seconds summed by
    label, the `k` largest: `<bench range>/<innermost diffews span>/<host
    op>` where a program span is open as the device falls idle, else
    `<bench range>/<host op>` as `trace.Trace.top_gaps` labels them."""
    ranges: Dict[str, list] = {r: [] for r in trace_lib.RANGES}
    host = []
    for e in events:
        if e["device_type"] != "cpu":
            continue
        if e["name"] in ranges:
            ranges[e["name"]].append((e["start"], e["end"]))
        elif not e["name"].startswith(PREFIX):
            host.append(e)
    spans_of = {r: ([s for s, _ in sorted(v)], [t for _, t in sorted(v)])
                for r, v in ranges.items()}
    host.sort(key=lambda e: e["start"])
    starts = [e["start"] for e in host]
    gaps, end = [], tr.window[0]
    for _, s, e in sorted(tr.ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    if tr.window[1] > end:
        gaps.append((end, tr.window[1] - end))
    by: Dict[str, float] = {}
    for t, us in gaps:
        outer = next((r for r in ("bench.vae", "bench.unet", "bench.enqueue", "bench.result")
                      if trace_lib._inside(spans_of[r], t)),
                     "bench.step" if trace_lib._inside(spans_of["bench.step"], t)
                     else "outside steps")
        op = "python"
        j = bisect.bisect_right(starts, t) - 1
        for j in range(j, max(-1, j - 4000), -1):
            if host[j]["end"] >= t:
                op = host[j]["name"]
                break
        span = spans.innermost(t)
        label = f"{outer}/{op}" if span is None else f"{outer}/{span}/{op}"
        by[label] = by.get(label, 0.0) + us / 1e6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
