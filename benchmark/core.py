"""One run of one cell: set-up, the measured window, the optional traced
stretch, the check against the reference, and the result line.

Everything a cell is made of is found by name: the cell's entry in
`BENCHMARK.json` names its configuration (the file it gives) and its
traffic (`benchmark/traffic/<traffic>.json`), whose `mode` names the kind
that runs it (`benchmark/kinds/<mode>.py`); its limits are in
`benchmark/workloads/<cell>.json`; each metric it reports is read by
`benchmark/metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import checks, generator, trace as trace_lib, weights as weights_lib, work as work_lib
from benchmark.reference import model as M

FORBIDDEN = ("jax", "jaxlib", "flax", "diffews_tpu")
WARM_STEPS = 3          # loop steps before the window: every shape, allocator and pinned pool warm
TRACE_STEPS = 6         # loop steps in the traced stretch


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, name: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "workloads" / f"{name}.json").read_text())["limits"]
    mine = lambda m: name in m.get("workloads", [name])
    return Cell(root, name, cell["chips"], config, traffic, limits,
                [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: the port's name begins with it)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------


def port_bundle(cfg: dict, wts: dict):
    """The port's `PipelineBundle` of every model the configuration names
    (`unet`, `vae` and each text tower of `M.TOWERS`), each built by the
    port from its dict through the port's config class and loaded strictly
    with the benchmark's weights (the tensors themselves, on their device).
    A field or a model the port does not know is refused by the port."""
    from diffews_tpu_torch import checkpoint as ckpt_lib
    from diffews_tpu_torch import configs
    from diffews_tpu_torch.models.clip_text import CLIPTextModel
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL

    classes = {"unet": (UNet2DConditionModel, configs.UNetConfig),
               "vae": (AutoencoderKL, configs.VAEConfig),
               **{k: (CLIPTextModel, configs.CLIPTextConfig) for k in M.TOWERS}}
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    parts = {}
    for key in ["unet", "vae"] + [k for k in M.TOWERS if k in cfg]:
        cls, conf = classes[key]
        c = conf(**tup(cfg[key]))
        with torch.device("meta"):
            m = cls(c)
        m.load_state_dict(wts[key], strict=True, assign=True)
        parts[key], parts[f"{key}_cfg"] = m, c
    return ckpt_lib.PipelineBundle(scheduler_cfg=configs.SchedulerConfig.diffews(), **parts)


def port_training_text(bundle, device) -> torch.Tensor:
    """The training step's text conditioning, as the port computes it from
    the bundle's text tower on `device`."""
    from diffews_tpu_torch.training import state as st

    return st.training_text_embed(bundle.text.to(device), bundle.text_cfg)


def build_program(cfg: dict, wts: dict, device):
    """The port's pipeline on `device` with the benchmark's weights."""
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    return DiffewsPipeline(port_bundle(cfg, wts), device=device,
                           compute_dtype=getattr(torch, cfg["compute_dtype"]),
                           attn_impl=cfg["attn_impl"], vae_impl=cfg["vae_impl"],
                           unet_int8=cfg["unet_int8"])


def serve_options(traffic: dict) -> dict:
    """The pipeline's keyword options that the traffic file sets."""
    return dict(r_threshold=traffic["r_threshold"], mask_on_device=traffic["mask_on_device"])


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------


@dataclass
class Done:
    index: int
    submitted: float
    finished: float
    enqueue_s: float


class Loop:
    """A closed loop with `depth` batches in flight: each step queues the
    next batch, then waits for the oldest once `depth` are queued."""

    def __init__(self, submit, depth: int, ranges: bool = False):
        self.submit, self.depth, self.ranges = submit, depth, ranges
        self.pending: deque = deque()
        self.done: list = []
        self.outputs: dict = {}
        self.i = 0

    def _range(self, name):
        return torch.profiler.record_function(name) if self.ranges else contextlib.nullcontext()

    def step(self) -> None:
        with self._range("bench.step"):
            t0 = time.perf_counter()
            with self._range("bench.enqueue"):
                p = self.submit(self.i)
            self.pending.append((self.i, t0, time.perf_counter() - t0, p))
            self.i += 1
            if len(self.pending) >= self.depth:
                with self._range("bench.result"):
                    self._finish_one()

    def _finish_one(self) -> None:
        i, t0, enq, p = self.pending.popleft()
        out = p.result()
        self.done.append(Done(i, t0, time.perf_counter(), enq))
        self.outputs[i] = out

    def drain(self) -> None:
        while self.pending:
            self._finish_one()


@dataclass
class Window:
    """What the measured window recorded (host clock)."""

    seconds: float
    items_per_batch: int
    done: list                      # batches submitted and finished inside the window
    submitted: int                  # batches submitted inside the window
    rate_items_per_s: float = 0.0
    opened: float = 0.0             # host clock at the window's start
    first: int = 0                  # index of the window's first batch

    @property
    def latencies_s(self):
        return [d.finished - d.submitted for d in self.done]


def measure(loop: Loop, seconds: float, items_per_batch: int) -> Window:
    start = len(loop.done)
    first = loop.i
    t_open = time.perf_counter()
    t_close = t_open + seconds
    while time.perf_counter() < t_close:
        loop.step()
    done = [d for d in loop.done[start:] if d.index >= first and d.finished <= t_close]
    w = Window(seconds, items_per_batch, done, loop.i - first, opened=t_open, first=first)
    w.rate_items_per_s = len(done) * items_per_batch / seconds
    return w


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """Everything a metric reader may read."""

    cell: Cell
    setup_s: float
    window: Window
    work: object                     # work_lib / reference Work of one batch
    trace: Optional[trace_lib.Trace] = None
    kernels_s: float = 0.0           # of setup_s: building or finding the port's kernels


def read_metric(run: Run, name: str):
    path = run.cell.root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: Optional[float] = None, program=None) -> tuple:
    """One run, by the cell's traffic kind: returns the result line as a
    dict, and every number of the check (those without a limit too).
    `program` replaces the kind's program (the fault tests plant faults
    through it)."""
    from benchmark import kinds

    t_start = time.perf_counter() if t_start is None else t_start
    kind = kinds.load(cell.traffic["mode"], cell.root)
    return kind.run(cell, seed, seconds, traced, torch.device(device), t_start, program)


def serve(cell: Cell, seed: int, seconds: float, traced: bool, dev, t_start: float, program,
          submitter, reference) -> tuple:
    """A run of a closed-loop serving kind: the pipeline (`program`, or
    `build_program`) fed through the kind's `submitter`, a sample of the
    window's outputs checked against the kind's `reference`."""
    phases = Phases(time.perf_counter())  # run.py prints the imports and CUDA's start
    cfg, traffic = cell.config, cell.traffic
    kernels_s = build_kernels(dev)
    phases.mark("kernels")
    wts = weights_lib.make(cfg, seed, dev)
    phases.mark("weights")
    pipe = (program or build_program)(cfg, wts, dev)
    del wts
    phases.mark("program")
    inputs = generator.make(traffic, seed, cfg["resolution"], dev, root=cell.root)
    submit, cache = submitter(pipe, traffic, inputs)
    phases.mark("inputs")
    loop = Loop(submit, traffic["dispatch_ahead"])
    for _ in range(WARM_STEPS):
        loop.step()
    loop.drain()
    _sync(dev)
    phases.mark("warm")
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    window = measure(loop, seconds, traffic["batch"])
    phases.mark("window")
    thirds = np.histogram([d.finished - window.opened for d in window.done], bins=3,
                          range=(0.0, seconds))[0] * traffic["batch"] / (seconds / 3)
    print("window thirds items/s: " + " ".join(f"{x:.3f}" for x in thirds)
          + f"; enqueue ms mean {1e3 * np.mean([d.enqueue_s for d in window.done]):.2f}"
          + "; host load " + " ".join(f"{x:.2f}" for x in os.getloadavg()), file=sys.stderr)
    run = Run(cell, setup_s, window, work_lib.batch_work(cfg, traffic, cell.root),
              kernels_s=kernels_s)
    if traced:
        run.trace = traced_stretch(loop, pipe, dev)
        phases.mark("trace")
    loop.drain()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # what the window produced, and the sample the reference checks: of
    # every batch submitted in the window, those that finished after its
    # close too (late is not wrong; drained above)
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    due = list(range(window.first, window.first + window.submitted))
    k = min(traffic["compare_batches"], len(due))
    picked = sorted(rng.choice(due, size=k, replace=False).tolist())
    produced = {i: loop.outputs[i] for i in picked}
    del loop, pipe, cache, submit
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = checks.compare(cfg, traffic, seed, inputs, produced, dev, reference)
    phases.mark("reference")

    return result_line(cell, run, numbers, peak, window.submitted * traffic["batch"], dev)


def result_line(cell: Cell, run: Run, numbers: dict, peak: int, attempted: int, dev) -> tuple:
    """The result line (the numbers compared last, each beside its limit),
    and every number of the check."""
    correct = checks.within(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if run.trace is not None else cell.end_to_end):
        v = read_metric(run, m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted, "failed": 0,
            "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.top_gaps()}
    line["setup_kernels_s"] = run.kernels_s
    line["checked"] = {n: {"value": numbers.get(n), "limit": lim} for n, lim in cell.limits.items()}
    return line, numbers


class Phases:
    """Host seconds of each part of a run, printed to standard error."""

    def __init__(self, t0: float):
        self.t = t0

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.2f} s", file=sys.stderr, flush=True)
        self.t = now


def traced_stretch(loop: Loop, pipe, dev) -> trace_lib.Trace:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    loop.ranges = True
    with trace_lib.ranges_on(pipe), profile(activities=acts) as prof:
        for _ in range(TRACE_STEPS):
            loop.step()
    loop.ranges = False
    return trace_lib.reduce_events(trace_lib.profiler_events(prof), TRACE_STEPS)


def build_kernels(dev) -> float:
    """Builds the port's CUDA kernels that the checkout's kernel cache
    (`build/kernels/`, the port's `ops/_build.py`) lacks, all at once, and
    returns the seconds it took: the compile on a checkout's first run, a
    look at the cache after.  Part of `setup_s`, and reported apart."""
    if dev.type != "cuda":
        return 0.0
    from diffews_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    return time.perf_counter() - t0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
