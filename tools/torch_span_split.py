"""The port's program spans in one benchmark cell: where a batch's (or a
training step's) host and device time goes, by stage and module.

    python3 tools/torch_span_split.py --workload <cell> --seed <n> --seconds <s> \\
        [--pairs 2] [--out spans.<cell>.json]

Runs the cell as `python3 benchmark/run.py --trace 1` does (set-up, the
measured window, the check against the reference, the result line), with
one difference: its traced stretch is `--pairs` pairs of stretches of the
benchmark's length, each pair one with the port's spans off and one with
them on (`utils/profiling.spans_on()`).  The result line's per-layer
metrics are read from the last stretch with spans on.  Then one JSON line
(written whole to `--out`) holds, per stretch, the host ms of the
harness's `bench.enqueue` range per step and the device's idle share (the
spans' cost when on), and of the last stretch with spans on: the span
table (`benchmark/spans.py`: calls, host, self, device and launch calls
per step), the idle gaps labelled by the innermost span, the port's
kernel launches per step (`profiling.launch_counts()`) and the sums that
hold the spans against the harness's own ranges.

`--tiny` runs the cell's tiny CPU version (`benchmark/tests/tiny.py`), to
check the tool without a card; its numbers mean nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# the caches where `benchmark/run.py` keeps them
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import core, spans as spans_lib, trace as trace_lib  # noqa: E402
from benchmark.kinds import train as train_kind  # noqa: E402
from diffews_tpu_torch.utils import profiling  # noqa: E402

STRETCHES: list = []


def _stretch(run_steps, steps: int, on: bool, dev) -> trace_lib.Trace:
    """One traced stretch of `steps` loop steps, spans `on` or off; kept
    in STRETCHES."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    before = profiling.launch_counts()
    with profiling.spans_on() if on else contextlib.nullcontext():
        with profile(activities=acts) as prof:
            run_steps()
    after = profiling.launch_counts()
    events = spans_lib.without_device_spans(trace_lib.profiler_events(prof))
    tr = trace_lib.reduce_events(events, steps)
    enq = [e["end"] - e["start"] for e in events
           if e["device_type"] == "cpu" and e["name"] == "bench.enqueue"]
    STRETCHES.append({"spans": on, "events": events if on else None, "trace": tr,
                      "enqueue_ms": sum(enq) / len(enq) / 1e3,
                      "device_idle_pct": (100.0 * (1.0 - tr.busy_s / tr.window_s)
                                          if tr.window_s > 0 else None),
                      "port_launches": {k: (after[k] - before[k]) / steps for k in after
                                        if after[k] != before[k]}})
    return tr


def _pairs(run_steps, steps: int, dev, pairs: int) -> trace_lib.Trace:
    """Off, on, on, off, ... (a drift over the stretches falls on both);
    the last stretch with spans on is returned."""
    last = None
    for k in range(pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            tr = _stretch(run_steps, steps, on, dev)
            last = tr if on else last
    return last


def traced_stretch(loop, pipe, dev, pairs: int):
    """`core.traced_stretch` over `pairs` pairs of stretches."""
    def run_steps():
        for _ in range(core.TRACE_STEPS):
            loop.step()

    loop.ranges = True
    with trace_lib.ranges_on(pipe):
        tr = _pairs(run_steps, core.TRACE_STEPS, dev, pairs)
    loop.ranges = False
    return tr


def traced_steps(trainer, feed, i0: int, dev, pairs: int):
    """`kinds/train.py::traced_steps` over `pairs` pairs of stretches."""
    from torch.profiler import record_function

    nxt = [i0]

    def run_steps():
        for _ in range(train_kind.TRACE_STEPS):
            with record_function("bench.step"), record_function("bench.enqueue"):
                trainer.step(*feed.get(nxt[0]))
            nxt[0] += 1
        core._sync(dev)

    return _pairs(run_steps, train_kind.TRACE_STEPS, dev, pairs)


def summary(train: bool, steps: int) -> dict:
    """The last stretch with spans on: its span table and what holds the
    spans against the harness's ranges; every stretch's cost figures."""
    last = next(s for s in reversed(STRETCHES) if s["spans"])
    sp = spans_lib.Spans(last["events"])
    table = sp.table(steps)
    host = lambda n: table.get(n, {}).get("host_ms", 0.0)
    dev_ms = lambda n: table.get(n, {}).get("device_ms", 0.0)
    tr = last["trace"]
    if train:
        parts = ("latents", "forward", "backward", "optimizer")
        checks = {"train_parts_host_ms": sum(host(f"diffews.train.{p}") for p in parts),
                  "train_step_host_ms": host("diffews.train.step")}
    else:
        outer = ("diffews.pipeline.predict" if "diffews.pipeline.predict" in table
                 else "diffews.pipeline.predict_cached")
        checks = {"predict_host_ms": host(outer), "bench_enqueue_ms": last["enqueue_ms"],
                  "encode_plus_decode_device_ms": dev_ms("diffews.pipeline.encode")
                  + dev_ms("diffews.pipeline.decode"),
                  "bench_vae_device_ms": tr.range_s_per_step("bench.vae") * 1e3}
    return {"stretches": [{k: s[k] for k in ("spans", "enqueue_ms", "device_idle_pct")}
                          for s in STRETCHES],
            "checks": checks, "port_launches": last["port_launches"],
            "idle_gaps": spans_lib.idle_gaps(last["events"], tr, sp),
            "top_kernels": sp.top_kernels(steps), "spans": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    if args.tiny:
        from benchmark.tests import tiny
        cell, dev = tiny.cell(args.workload), "cpu"
    else:
        cell, dev = core.load_cell(ROOT, args.workload), "cuda"
        torch.set_num_threads(4)
        torch.cuda.init()
    core.traced_stretch = lambda loop, pipe, d: traced_stretch(loop, pipe, d, args.pairs)
    train_kind.traced_steps = lambda t, f, i, d: traced_steps(t, f, i, d, args.pairs)
    line, _ = core.run_cell(cell, args.seed, args.seconds, True, dev, T_START)
    print(json.dumps(line), flush=True)
    train = cell.traffic["mode"] == "train"
    out = summary(train, train_kind.TRACE_STEPS if train else core.TRACE_STEPS)
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name() if dev == "cuda" else "cpu")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    brief = dict(out, spans={n: {k: round(v, 3) for k, v in r.items()
                                 if k != "self_device_ms_by_class"}
                             for n, r in list(out["spans"].items())[:40]})
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
