"""Training: the port's training step driven back to back, its first
steps checked against the plain reference.

Set-up builds one trainer (the port's step with its model and optimizer
state) and drives it from the seed through its first `compare_steps`
steps, through the same call and feed as the window, on batches whose rows
all differ; those steps are the warm-up too.  The window then runs further
steps until `--seconds` have passed on the host and waits for the device:
the rate is over all the steps and all the time to the device's end.

The check, once the program is gone (`numbers`), against step 1 of the
float32 reference: the first step's loss and gradient norm; per leaf, the
norm of the first gradient as the optimizer took it (from the first
moment after step 1: ‖mu‖ / (1 − β1)), by the worst leaf, and its
direction.  Against the reference at the configuration's precision: each
compared step's loss, and the norm of the parameters' change after the
compared steps (before the window's first step overwrites them), by the
median and the worst leaf.  Each leaf's gap is relative to its reference
norm or the median leaf's, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's move by rounding alone
and are left out.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import core, generator, trace as trace_lib, weights as weights_lib, work as work_lib
from benchmark.reference import episode as ref_lib
from benchmark.reference import model as M
from benchmark.reference import train as ref_train

TRACE_STEPS = 2
NOUGHT = 1e-3
NUMBERS = ("loss_gap", "grad_norm_gap", "grad_gap", "grad_direction_gap", "step_loss_gap",
           "update_gap", "update_gap_worst")


def draw(d: generator.Draws, traffic: dict, latent) -> dict:
    """The episodes, then each batch's query mask and posterior-sample
    noise: "q_mask" (B, H, W) and "noise" (1, images, h, w, latent) in
    stream order (query, query mask, supports, support masks)."""
    out = generator.episodes(d, traffic)
    b, n, pool = traffic["batch"], traffic["shots"], traffic["pool"]
    qm = d.masks(pool, b)
    h = d.size // latent[0]
    noise = d.normal(pool, 1, 2 * b + 2 * b * n, h, h, latent[1])
    for i, batch in enumerate(out["batches"]):
        batch["q_mask"], batch["noise"] = qm[i], noise[i]
    return out


def count(s) -> None:
    """The four image streams' posterior samples (no gradient), then the
    joint UNet forward and its backward (two products per forward
    product); remat's recomputed forward is not the model's work."""
    uc, vc, b, n, r, h = s.cfg["unet"], s.cfg["vae"], s.b, s.n, s.r, s.h
    M.vae_moments(s.vae, vc, s.meta(2 * b + 2 * b * n, 3, r, r))
    uw = M.Work(elt=s.work.elt)
    ctx, added = work_lib.conditioning(s.cfg, padded=True)
    M.unet(M.Net(work=uw), uc, s.meta(b, uc["in_channels"], h, h), s.t, ctx,
           ref=s.meta(b, n, uc["ref_in_channels"], h, h), added=added)
    s.work.flops += 3 * uw.flops
    s.work.attention += uw.attention
    s.work.attention_bwd += uw.attention


class PortTrainer:
    """The port's training step (`training/state.py`) over the cell's
    configuration, with the benchmark's weights."""

    def __init__(self, cfg: dict, traffic: dict, wts: dict, dev):
        from diffews_tpu_torch.training import state as st

        t = traffic["trainer"]
        dt = getattr(torch, cfg["compute_dtype"])
        self.tcfg = st.TrainerConfig(
            learning_rate=t["learning_rate"], adam_beta1=t["adam_beta1"],
            adam_beta2=t["adam_beta2"], adam_epsilon=t["adam_epsilon"],
            adam_weight_decay=t["adam_weight_decay"], max_grad_norm=t["max_grad_norm"],
            lr_power=t["lr_power"], max_train_steps=t["max_train_steps"],
            gradient_accumulation_steps=t["gradient_accumulation_steps"],
            train_timestep=t["train_timestep"], compute_dtype=dt,
            adam_mu_dtype=getattr(torch, t["first_moment_dtype"]), attn_impl=cfg["attn_impl"],
            remat=t["remat"])
        fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
        bundle = core.port_bundle(cfg, wts)
        self.text_embed = core.port_training_text(bundle, dev)
        self.vae = bundle.vae.to(device=dev, dtype=dt, memory_format=fmt).requires_grad_(False)
        unet = bundle.unet.to(device=dev, dtype=torch.float32, memory_format=fmt)
        del bundle
        self.state = st.init_state(self.tcfg, dict(unet.named_parameters()), device=dev)
        self.step_fn = st.make_train_step(self.tcfg, unet)
        self.names = list(self.state.params)

    def step(self, batch: dict, noise: torch.Tensor):
        """One optimizer step; returns its loss and pre-clip gradient norm
        (device tensors)."""
        self.state, metrics = self.step_fn(self.state, batch, noise, self.vae, self.text_embed)
        return metrics["loss"], metrics["grad_norm"]

    def first_moments(self) -> dict:
        return self.state.opt_state.mu

    @torch.no_grad()
    def change_norms(self, p0: dict) -> torch.Tensor:
        return torch.stack([(self.state.params[n] - p0[n].float()).norm() for n in self.names])


class Feed:
    """The pool on pinned host memory, each step's batch uploaded without
    waiting for the device, in the step's layout (leading gas axis of 1)."""

    def __init__(self, inputs: dict, dev):
        pin = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        self.dev, self.batches = dev, []
        for b in inputs["batches"]:
            host = {"query": pin(b["query"][None]), "q_mask3": pin(b["q_mask"][None]),
                    "supports": pin(b["supports"][None]), "s_mask3": pin(b["masks"][None]),
                    "shot_mask": torch.ones(b["masks"].shape[:2], dtype=torch.bool)[None],
                    "noise": pin(b["noise"])}
            if dev.type == "cuda":
                host = {k: v.pin_memory() for k, v in host.items()}
            self.batches.append(host)

    def get(self, i: int):
        host = self.batches[i % len(self.batches)]
        dev = {k: v.to(self.dev, non_blocking=True) for k, v in host.items()}
        return {k: v for k, v in dev.items() if k != "noise"}, dev["noise"]


def run(cell, seed: int, seconds: float, traced: bool, dev, t_start: float,
        program=None) -> tuple:
    phases = core.Phases(time.perf_counter())  # run.py prints the imports and CUDA's start
    cfg, traffic = cell.config, cell.traffic
    if dev.type == "cuda" and traffic.get("cudnn_deterministic"):
        torch.backends.cudnn.deterministic = True
    kernels_s = core.build_kernels(dev)
    phases.mark("kernels")
    wts = weights_lib.make(cfg, seed, dev)
    p0 = {n: t.clone() for n, t in wts["unet"].items()}
    phases.mark("weights")
    trainer = (program or PortTrainer)(cfg, traffic, wts, dev)
    del wts
    phases.mark("program")
    vc = cfg["vae"]
    inputs = generator.make(traffic, seed, cfg["resolution"], dev,
                            latent=(2 ** (len(vc["block_out_channels"]) - 1), vc["latent_channels"]),
                            root=cell.root)
    feed = Feed(inputs, dev)
    phases.mark("inputs")

    k_cmp = traffic["compare_steps"]
    losses, gnorms, g_norms = [], [], None
    for k in range(k_cmp):
        loss, gnorm = trainer.step(*feed.get(k))
        losses.append(loss.detach().float().clone())
        gnorms.append(gnorm.detach().float().clone())
        if k == 0:
            # the first gradient as the optimizer took it: mu / (1 - beta1);
            # its vectors wait on the host for the reference's
            mu = trainer.first_moments()
            g_norms = torch.stack([mu[n].float().norm() for n in trainer.names])
            g_norms = g_norms / (1.0 - traffic["trainer"]["adam_beta1"])
            mu1 = {n: mu[n].detach().to("cpu", copy=True) for n in trainer.names}
    d_norms = trainer.change_norms(p0)
    del p0
    core._sync(dev)
    phases.mark("warm")
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    done, i = [], k_cmp
    t_open = time.perf_counter()
    while time.perf_counter() < t_open + seconds:
        t0 = time.perf_counter()
        trainer.step(*feed.get(i))
        done.append(core.Done(i, t0, math.nan, time.perf_counter() - t0))
        i += 1
    core._sync(dev)
    span = time.perf_counter() - t_open
    window = core.Window(span, traffic["batch"], done, len(done),
                         len(done) * traffic["batch"] / span)
    phases.mark("window")
    run = core.Run(cell, setup_s, window, work_lib.batch_work(cfg, traffic, cell.root),
                   kernels_s=kernels_s)
    if traced:
        run.trace = traced_steps(trainer, feed, i, dev)
        phases.mark("trace")
    core._sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog = {"loss": [float(x) for x in losses], "grad_norm": [float(x) for x in gnorms],
            "grad": g_norms.cpu().numpy(), "mu1": mu1,
            "change": d_norms.cpu().numpy(), "names": list(trainer.names)}
    del trainer, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(cfg, traffic, seed, inputs, prog, dev)
    phases.mark("reference")
    return core.result_line(cell, run, numbers, peak, window.submitted * traffic["batch"], dev)


def traced_steps(trainer, feed, i0: int, dev) -> trace_lib.Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(i0, i0 + TRACE_STEPS):
            with record_function("bench.step"), record_function("bench.enqueue"):
                trainer.step(*feed.get(i))
        core._sync(dev)
    return trace_lib.reduce_events(trace_lib.profiler_events(prof), TRACE_STEPS)


def _reference_steps(ref, inputs, dev, steps: int, first=None) -> tuple:
    """`ref`'s first `steps` steps on the run's batches: (losses, pre-clip
    norms); `first(grads, taken)` sees step 1's gradients."""
    losses, gnorms = [], []
    t = lambda a: generator.as_tensor(a, dev)
    for k in range(steps):
        b = inputs["batches"][k]
        batch = {"query": t(b["query"]), "q_mask": t(b["q_mask"]), "supports": t(b["supports"]),
                 "s_mask": t(b["masks"])}
        loss, grads = ref.loss_and_grads(batch, t(b["noise"][0]))
        gnorm, took = ref.update(grads)
        if k == 0 and first is not None:
            first(grads, took)
        losses.append(loss)
        gnorms.append(gnorm)
        del grads
    return losses, gnorms


def reference_readings(cfg, traffic, seed, inputs, dev, prog_mu1: dict) -> dict:
    """Step 1 of the float32 reference: its loss and pre-clip norm, per
    leaf the norms of the first gradient as the optimizer takes it and of
    the raw gradient, and the cosine of each leaf's first gradient with the
    program's first moment `prog_mu1`.  Then the compared steps of the
    reference at the configuration's precision (`ReferenceTrainer`'s
    `low`: every convolution's and linear's operands rounded to the compute
    type, float32 sums; the float32 reference itself where that is
    float32): each step's loss and the norms of the change after them."""
    ref_lib.plain_float32()
    w0 = weights_lib.as_float32(weights_lib.make(cfg, seed, dev))
    low = compute_precision(cfg)
    k_cmp = traffic["compare_steps"]
    out = {}

    def first(grads, took):
        names = list(grads)
        out.update(names=names, grad=np.array([took[n] for n in names]),
                   raw_grad=np.array([float(grads[n].norm()) for n in names]),
                   cos=np.array([_cosine(prog_mu1[n].to(dev).float(), grads[n]) for n in names]))

    ref = ref_train.TrainReference(cfg, traffic["trainer"], w0, dev)
    losses, gnorms = _reference_steps(ref, inputs, dev, 1 if low is not None else k_cmp, first)
    out.update(loss=losses[0], grad_norm=gnorms[0])
    if low is not None:
        del ref
        gc.collect()
        ref = ref_train.TrainReference(cfg, traffic["trainer"], w0, dev, low=low)
        losses, _ = _reference_steps(ref, inputs, dev, k_cmp)
    out["steps_loss"] = losses
    out["change"] = np.array([float((ref.params[n].detach() - w0["unet"][n]).norm())
                              for n in out["names"]])
    return out


def compute_precision(cfg: dict):
    """The operand type of the reference at the configuration's precision:
    None where the configuration computes in float32."""
    dt = getattr(torch, cfg["compute_dtype"])
    return None if dt == torch.float32 else dt


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """cos(a, b) over all elements; 0 where either is all zero."""
    na, nb = float(a.norm()), float(b.norm())
    return float((a.flatten() @ b.flatten()) / (na * nb)) if na > 0 and nb > 0 else 0.0


def compare(cfg, traffic, seed, inputs, prog: dict, dev) -> dict:
    ref = reference_readings(cfg, traffic, seed, inputs, dev, prog.pop("mu1"))
    return numbers(prog, ref)


def numbers(prog: dict, ref: dict) -> dict:
    """Against step 1 of the float32 reference: loss_gap, the first step's
    loss, relative; grad_norm_gap, its pre-clip global gradient norm as the
    step reports it, relative; grad_gap, the worst leaf's first-gradient
    norm; grad_direction_gap, the worst leaf's 1 − cos between the
    program's first moment and the reference's first gradient.  Against
    the compared steps of the reference at the configuration's precision:
    step_loss_gap, the worst step's loss, relative; update_gap and
    update_gap_worst, the median and the worst leaf's change norm after
    the steps.  (Past step 1 the float32 reference itself is no yardstick
    of a bf16 run: Adam's first step moves every element by the learning
    rate, under half a bf16 ulp of most weights, which start on the bf16
    grid, so the bf16 casts of three quarters of the masters stay put and
    the later steps start from another model; PERF.md, the training look.)"""
    if set(prog["names"]) != set(ref["names"]):
        raise ValueError("the program's leaves are not the reference's")
    at = [ref["names"].index(n) for n in prog["names"]]
    r = {k: np.asarray(ref[k])[at] for k in ("grad", "raw_grad", "change", "cos")}
    keep = r["raw_grad"] >= NOUGHT * np.median(r["raw_grad"])
    gaps = lambda p, q: np.abs(p[keep] - q[keep]) / np.maximum(q[keep], np.median(q[keep]))
    change = gaps(np.asarray(prog["change"]), r["change"])
    rel = lambda a, b: abs(a - b) / abs(b)
    return {"loss_gap": rel(prog["loss"][0], ref["loss"]),
            "grad_norm_gap": rel(prog["grad_norm"][0], ref["grad_norm"]),
            "grad_gap": float(np.max(gaps(np.asarray(prog["grad"]), r["grad"]))),
            "grad_direction_gap": float(np.max(1.0 - r["cos"][keep])),
            "step_loss_gap": max(rel(a, b) for a, b in zip(prog["loss"], ref["steps_loss"])),
            "update_gap": float(np.median(change)),
            "update_gap_worst": float(np.max(change))}


# the control and the planted faults (`benchmark/control.py`, the fault tests)


class ReferenceTrainer:
    """The reference's training step with every convolution's and linear's
    operands rounded to `low`, behind the harness's trainer interface."""

    def __init__(self, cfg, traffic, wts, device, low):
        ref_lib.plain_float32()
        self.ref = ref_train.TrainReference(cfg, traffic["trainer"], weights_lib.as_float32(wts),
                                            device, low=low)
        self.names = list(self.ref.params)

    def step(self, batch, noise):
        b = {"query": batch["query"][0], "q_mask": batch["q_mask3"][0],
             "supports": batch["supports"][0], "s_mask": batch["s_mask3"][0]}
        loss, grads = self.ref.loss_and_grads(b, noise[0])
        gnorm, _ = self.ref.update(grads)
        return torch.tensor(loss), torch.tensor(gnorm)

    def first_moments(self):
        return self.ref.mu

    def change_norms(self, p0):
        with torch.no_grad():
            return torch.stack([(self.ref.params[n] - p0[n].float()).norm()
                                      for n in self.names])


class Unchanged:
    """A training step that returns its state unchanged: the step runs,
    then the masters and moments are put back."""

    def __init__(self, trainer):
        self.t = trainer

    def __getattr__(self, name):
        return getattr(self.t, name)

    def step(self, batch, noise):
        st = self.t.state
        saved = ({n: p.detach().clone() for n, p in st.params.items()},
                 {n: m.clone() for n, m in st.opt_state.mu.items()})
        loss = self.t.step(batch, noise)
        with torch.no_grad():
            for n, p in st.params.items():
                p.copy_(saved[0][n])
                st.opt_state.mu[n].copy_(saved[1][n])
        return loss


class HalfBatch:
    """Half of the batch left out: the step's mean over the other half."""

    def __init__(self, trainer):
        self.t = trainer

    def __getattr__(self, name):
        return getattr(self.t, name)

    def step(self, batch, noise):
        h = batch["query"].shape[1] // 2
        b, n = batch["supports"].shape[1:3]
        half = {k: v[:, :h] for k, v in batch.items()}
        # the noise's images in stream order: query, query mask, supports, support masks
        parts = noise.split([b, b, b * n, b * n], dim=1)
        keep = [parts[0][:, :h], parts[1][:, :h], parts[2][:, :h * n], parts[3][:, :h * n]]
        return self.t.step(half, torch.cat(keep, dim=1))


FAULTS = {"state_unchanged": Unchanged, "half_batch": HalfBatch}


def control_program(cell):
    """bf16 compute: the control is the reference with fp8 operands."""
    return lambda c, t, wts, dev: ReferenceTrainer(c, t, wts, dev, torch.float8_e4m3fn)


FAULT_PROGRAMS = {"half_batch": lambda c, t, wts, dev: HalfBatch(PortTrainer(c, t, wts, dev))}
