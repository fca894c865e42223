"""Where the training cell's later steps part from the reference (not part
of a run).

    python3 benchmark/train_look.py --workload sd21.train-1shot-b4 --seeds 1,2,3

For each seed, four trainers take the cell's first compared steps from
the same weights on the same batches and noise: the program as the
configuration states it (bf16 compute, bf16 first moment), the program in
float32 (float32 compute and first moment, TF32 off: another path of the
same code), the float32 reference, and the reference with every
convolution's and linear's operands rounded to bfloat16 (the
configuration's precision, float32 sums).  One JSON line per seed gives,
for pairs of them: each step's relative loss and gradient-norm gaps, the
change gaps by leaf after step 1 and after the compared steps (median and
worst), and the share of each leaf's elements whose first update has the
other sign (Adam's first step moves every element by the learning rate
times the sign of its gradient).  It also gives the share of the masters'
bf16 casts that changed after step 1, and the reference's learning rate
and bias corrections at each step.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import core, generator, weights as weights_lib  # noqa: E402
from benchmark.kinds import train  # noqa: E402
from benchmark.reference import episode as ref_lib  # noqa: E402

PAIRS = [("program", "reference"), ("reference_bf16", "reference"),
         ("program_f32", "reference"), ("program", "reference_bf16"),
         ("program", "program_f32")]


def _params(tr) -> dict:
    return tr.state.params if hasattr(tr, "state") else tr.ref.params


def _trainers(cell, dev):
    cfg, traffic = cell.config, cell.traffic
    f32 = {**cfg, "compute_dtype": "float32"}
    t32 = {**traffic, "trainer": {**traffic["trainer"], "first_moment_dtype": "float32"}}
    return {
        "program": lambda w: train.PortTrainer(cfg, traffic, w, dev),
        "program_f32": lambda w: train.PortTrainer(f32, t32, w, dev),
        "reference": lambda w: train.ReferenceTrainer(cfg, traffic, w, dev, None),
        "reference_bf16": lambda w: train.ReferenceTrainer(cfg, traffic, w, dev, torch.bfloat16),
    }


@torch.no_grad()
def _changes(params: dict, p0: dict, names) -> np.ndarray:
    return np.array([float((params[n].detach().float() - p0[n].float()).norm()) for n in names])


def drive(make, wts, feed, p0, k_steps, dev) -> dict:
    """The trainer's first `k_steps` steps and what the look reads."""
    tr = make(wts)
    names = sorted(tr.names)
    out = {"loss": [], "grad_norm": []}
    for k in range(k_steps):
        loss, gnorm = tr.step(*feed.get(k))
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(gnorm))
        if k == 0:
            ps = _params(tr)
            with torch.no_grad():
                out["sign1"] = {n: torch.sign(ps[n].detach().float() - p0[n].float())
                                .to(torch.int8).cpu() for n in names}
                cast = sum(int((ps[n].detach().to(p0[n].dtype) != p0[n]).sum()) for n in names)
            out["cast_changed"] = cast / sum(p0[n].numel() for n in names)
            out["change1"] = _changes(ps, p0, names)
            mu = tr.first_moments()
            out["mu1"] = np.array([float(mu[n].float().norm()) for n in names])
    out["change"] = _changes(_params(tr), p0, names)
    out["names"] = names
    if hasattr(tr, "ref"):
        r = tr.ref
        out["lr"] = [r.lr(c) for c in range(k_steps)]
        b1, b2 = r.t["adam_beta1"], r.t["adam_beta2"]
        out["bias_corrections"] = [[1 - b1 ** (c + 1), 1 - b2 ** (c + 1)] for c in range(k_steps)]
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(a: dict, b: dict, keep: np.ndarray) -> dict:
    rel = lambda x, y: [abs(p - q) / abs(q) for p, q in zip(x, y)]
    gap = lambda p, q: np.abs(p[keep] - q[keep]) / np.maximum(q[keep], np.median(q[keep]))
    flips = np.array([float((a["sign1"][n] != b["sign1"][n]).float().mean()) for n in a["names"]])
    g1, g3 = gap(a["change1"], b["change1"]), gap(a["change"], b["change"])
    return {"loss_gaps": rel(a["loss"], b["loss"]), "grad_norm_gaps": rel(a["grad_norm"], b["grad_norm"]),
            "change1_gap_median": float(np.median(g1)), "change1_gap_worst": float(np.max(g1)),
            "change_gap_median": float(np.median(g3)), "change_gap_worst": float(np.max(g3)),
            "flip_share_median": float(np.median(flips[keep])),
            "flip_share_worst": float(np.max(flips[keep]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sd21.train-1shot-b4")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = core.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if cell.traffic.get("cudnn_deterministic"):
        torch.backends.cudnn.deterministic = True
    ref_lib.plain_float32()
    k_steps = cell.traffic["compare_steps"]
    vc = cell.config["vae"]
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        wts = weights_lib.make(cell.config, seed, dev)
        p0 = {n: t.clone() for n, t in wts["unet"].items()}
        inputs = generator.make(cell.traffic, seed, cell.config["resolution"], dev,
                                latent=(2 ** (len(vc["block_out_channels"]) - 1),
                                        vc["latent_channels"]))
        feed = train.Feed(inputs, dev)
        runs = {k: drive(make, wts, feed, p0, k_steps, dev)
                for k, make in _trainers(cell, dev).items()}
        mu = runs["reference"]["mu1"]
        keep = mu >= train.NOUGHT * np.median(mu)
        line = {"seed": seed, "leaves": int(keep.sum()),
                "loss": {k: r["loss"] for k, r in runs.items()},
                "grad_norm": {k: r["grad_norm"] for k, r in runs.items()},
                "bf16_casts_changed_after_step_1": {k: r["cast_changed"] for k, r in runs.items()},
                "reference_lr": runs["reference"]["lr"],
                "reference_bias_corrections": runs["reference"]["bias_corrections"],
                "pairs": {f"{a} vs {b}": compare(runs[a], runs[b], keep) for a, b in PAIRS},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del wts, p0, feed, runs
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
