"""Turnkey reference-parity verification of the port (port of
`diffews_tpu/cli/verify_parity.py`).

The reference's only integration check is its seeded eval protocol
(`evaluation_util/main_oss.py:84-171`): a deterministic episode stream,
the relative threshold, the 2-bin histc mIoU.  BASELINE.md sets the bar at
COCO-20i fold0 1-shot mIoU within 0.3 of the reference checkpoint's run.
This command runs it as one job on the port:

  python -m diffews_tpu_torch.cli.verify_parity \\
      --checkpoint /path/sd21-ref8 --unet_ckpt_path /path/trained/unet \\
      --datapath /path/FSSBench --ref_miou <reference-run mIoU> \\
      [--golden golden.npz | --skip_golden] [--device cpu]

Phases:
  A. golden activations: the port's loaders and forwards against a
     `golden.npz` of THIS checkpoint (the plain UNet, the `conv_in_ref`
     two-pass ref branch, the VAE encode mean and the decode), at the
     5e-3 bar of `tests/test_golden.py`.  The npz comes from `--golden`,
     or else from `tools/make_golden.py` run as a subprocess (diffusers
     where installed, else its torch-only `--oracle` state-dict path, whose
     ref branch is `tests/helpers/torch_oracle.unet_two_pass`).  The
     generator reads checkpoints through the JAX package, so a host without
     JAX passes `--golden` or `--skip_golden`.
  B. the seeded protocol: the fold's eval through the port's
     `cli/evaluate.py` with the reference script's flags
     (`scripts/eval_coco2014_rthres_1shot_nosample.sh:14-30`: seed-0
     stream, r_threshold 0.25, threshold 0, denoise_steps 1).
  C. verdict: |mIoU - ref_miou| <= tolerance (0.3).  Without --ref_miou
     the run records its own number (exit 0).

Writes <out>/parity_report.json and prints it as one JSON line; exit code
1 iff a phase failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_TOL = 5e-3  # tests/test_golden.py: f32 forwards, reassociated sums


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "DiffewS port reference parity runbook", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="diffusers-layout base checkpoint dir")
    p.add_argument("--unet_ckpt_path", default=None,
                   help="trained unet dir (the reference's --unet_ckpt_path)")
    p.add_argument("--scheduler_load_path", default=None)
    p.add_argument("--datapath", required=True)
    p.add_argument("--benchmark", default="coco")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--r_threshold", type=float, default=0.25)
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("--ref_miou", type=float, default=None,
                   help="the reference run's mIoU on the same protocol; "
                        "omit to just record ours")
    p.add_argument("--tolerance", type=float, default=0.3,
                   help="BASELINE.md bar: |mIoU - ref| <= this")
    p.add_argument("--bsz", type=int, default=1,
                   help="a throughput lever; the metrics do not depend on it")
    p.add_argument("--dispatch_ahead", type=int, default=2)
    p.add_argument("--half_precision", action="store_true",
                   help="bf16 compute (default f32: the parity setting)")
    p.add_argument("--attn_impl", default="auto")
    p.add_argument("--max_episodes", type=int, default=0,
                   help="0 = the full seeded protocol")
    p.add_argument("--out", default="./parity_logs")
    p.add_argument("--golden", default=None,
                   help="a golden.npz of this checkpoint for phase A (default: "
                        "generate one with tools/make_golden.py)")
    p.add_argument("--skip_golden", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of both phases (default: the CUDA card)")
    return p


def _have_diffusers() -> bool:
    return importlib.util.find_spec("diffusers") is not None


def _generate_golden(args) -> tuple[str | None, dict]:
    """`tools/make_golden.py` on the checkpoint, as a subprocess: (npz path
    or None, its record)."""
    golden_dir = os.path.join(args.out, "golden")
    cmd = [sys.executable, os.path.join(_REPO, "tools", "make_golden.py"),
           "--checkpoint", args.checkpoint, "--out", golden_dir]
    oracle = not _have_diffusers()
    if oracle:
        cmd.append("--oracle")
    gen = subprocess.run(cmd, capture_output=True, text=True)
    rec = {"generator": "oracle" if oracle else "diffusers+oracle"}
    if gen.returncode != 0:
        return None, {**rec, "status": "fail", "detail": gen.stderr[-1000:]}
    return os.path.join(golden_dir, "golden.npz"), rec


def golden_errors(checkpoint: str, data, device) -> dict:
    """Max |port − golden| of each golden array, the port's modules loaded
    from `checkpoint` in f32 on `device`."""
    from diffews_tpu_torch import checkpoint as C
    from diffews_tpu_torch.configs import UNetConfig, load_json_config
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.utils.init import build_module

    put = lambda a, *perm: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.asarray(a, np.float32).transpose(*perm))).to(device)
    err = lambda got, want, *perm: float(np.abs(  # noqa: E731
        got.float().cpu().numpy() - np.asarray(want).transpose(*perm)).max())
    unet_dir = os.path.join(checkpoint, "unet")
    state = C.load_unet_state(unet_dir)
    if "conv_in_ref.weight" not in state:
        # a stock checkpoint: the generator fabricated the surgery weights,
        # so apply the same rule to the loaded ones
        state = C.make_ref_conv_surgery(state)
    ucfg = UNetConfig.from_diffusers_dict(dict(
        load_json_config(os.path.join(unet_dir, "config.json")),
        ref_in_channels=state["conv_in_ref.weight"].shape[1]))
    unet = build_module(UNet2DConditionModel, ucfg, device=device).eval()
    unet.load_state_dict(state, strict=True)
    vae, _ = C.load_vae(os.path.join(checkpoint, "vae"), device=device)
    vae.eval()
    errs = {}
    with torch.inference_mode():
        sample, ctx = put(data["sample"], 0, 2, 3, 1), put(data["ctx"], 0, 1, 2)
        errs["unet_max_abs"] = err(unet(sample, 1, ctx), data["unet_out"], 0, 2, 3, 1)
        if "unet_ref_out" in data:
            ref = put(data["ref_sample"], 0, 1, 3, 4, 2)
            errs["unet_ref_max_abs"] = err(unet(sample, 1, ctx, ref_sample=ref),
                                           data["unet_ref_out"], 0, 2, 3, 1)
        else:
            errs["unet_ref_max_abs"] = None  # a golden.npz without the ref branch
        img = put(data["img"], 0, 2, 3, 1)
        errs["vae_enc_max_abs"] = err(vae.encode_mean_latent(img), data["vae_mean"], 0, 2, 3, 1)
        dec = vae.decode(put(data["vae_mean"], 0, 2, 3, 1))
        errs["vae_dec_max_abs"] = err(dec, data["vae_dec"], 0, 2, 3, 1)
    return errs


def run_golden_phase(args, device) -> dict:
    """Phase A: golden activations of THIS checkpoint against the port's
    forwards (plain UNet and VAE, and the conv_in_ref/KV-fusion ref branch,
    the part most likely to diverge)."""
    if args.golden:
        path, rec = args.golden, {"generator": "given", "golden": args.golden}
    else:
        path, rec = _generate_golden(args)
        if path is None:
            return rec
    errs = golden_errors(args.checkpoint, np.load(path), device)
    ok = all(v is None or v < GOLDEN_TOL for v in errs.values())
    return {"status": "pass" if ok else "fail", **rec, **errs}


def eval_argv(args) -> list[str]:
    """Phase B's argv of the port's eval CLI."""
    argv = [
        "--checkpoint", args.checkpoint,
        "--datapath", args.datapath,
        "--benchmark", args.benchmark,
        "--fold", str(args.fold), "--nshot", str(args.nshot),
        "--img-size", str(getattr(args, "img_size")),
        "--denoise_steps", "1", "--ensemble_size", "1",
        "--threshold", str(args.threshold),
        "--r_threshold", str(args.r_threshold),
        "--log-root", os.path.join(args.out, "eval"),
        "--bsz", str(args.bsz),
        "--dispatch_ahead", str(args.dispatch_ahead),
        "--attn_impl", args.attn_impl,
        "--max_episodes", str(args.max_episodes),
    ]
    if args.unet_ckpt_path:
        argv += ["--unet_ckpt_path", args.unet_ckpt_path]
    if args.scheduler_load_path:
        argv += ["--scheduler_load_path", args.scheduler_load_path]
    if args.half_precision:
        argv += ["--half_precision"]
    if args.device:
        argv += ["--device", args.device]
    return argv


def main(argv=None) -> int:
    from diffews_tpu_torch.cli.evaluate import main as eval_main
    from diffews_tpu_torch.pipeline import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    report = {"checkpoint": args.checkpoint, "device": str(device),
              "protocol": {
                  "benchmark": args.benchmark, "fold": args.fold,
                  "nshot": args.nshot, "img_size": args.img_size,
                  "r_threshold": args.r_threshold,
                  "threshold": args.threshold,
                  "max_episodes": args.max_episodes,
                  "compute": "bf16" if args.half_precision else "f32"}}
    if args.skip_golden:
        report["golden"] = {"status": "skipped", "detail": "--skip_golden"}
    else:
        report["golden"] = run_golden_phase(args, device)

    miou, fb_iou = eval_main(eval_argv(args))
    report["miou"] = round(float(miou), 4)
    report["fb_iou"] = round(float(fb_iou), 4)

    if args.ref_miou is None:
        report["verdict"] = "recorded (no --ref_miou given)"
        ok = report["golden"]["status"] != "fail"
    else:
        delta = abs(float(miou) - args.ref_miou)
        report["ref_miou"] = args.ref_miou
        report["delta"] = round(delta, 4)
        report["tolerance"] = args.tolerance
        bar_ok = delta <= args.tolerance
        report["verdict"] = "PASS" if bar_ok else "FAIL"
        ok = bar_ok and report["golden"]["status"] != "fail"

    with open(os.path.join(args.out, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
