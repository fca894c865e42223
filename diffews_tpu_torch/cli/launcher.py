"""Batch evaluation launcher (port of `diffews_tpu/cli/launcher.py`).

Emits `python -m diffews_tpu_torch.cli.evaluate` commands, which run on the
CUDA card unless `--device` says otherwise (passed through when given).
Counterpart of the reference's SLURM job generators
(`cl_launcher_eval.py` / `cl_launcher_cd.py` / `cl_launcher_list.py`, which
are hardcoded to the authors' cluster).  Generates one eval invocation per
(checkpoint, fold) pair and either runs them sequentially on this host or
emits sbatch files for a SLURM cluster.  `get_free_port.py` has no JAX
equivalent: a single-device eval needs no process-group rendezvous.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def build_parser():
    p = argparse.ArgumentParser("DiffewS port batch eval launcher")
    p.add_argument("--checkpoints", nargs="*", default=[],
                   help="model dirs (each containing unet/)")
    p.add_argument("--scan_logs", type=str, default=None,
                   help="scan this logs dir for experiment folders instead of "
                        "listing --checkpoints (cl_launcher_*.py behavior)")
    p.add_argument("--match", type=str, default="",
                   help="with --scan_logs: substring filter on experiment names")
    p.add_argument("--iter", type=int, default=20000,
                   help="with --scan_logs: checkpoint step to evaluate")
    p.add_argument("--folds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--benchmark", type=str, default="coco")
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--datapath", type=str, default="FSSBench")
    p.add_argument("--base_checkpoint", type=str, required=True)
    p.add_argument("--scheduler_load_path", type=str, default="./scheduler_1.0_1.0")
    p.add_argument("--r_threshold", type=float, default=0.25)
    p.add_argument("--log-root", dest="log_root", type=str, default="logs/batch_eval")
    p.add_argument("--mode", choices=["local", "slurm"], default="local")
    p.add_argument("--slurm_partition", type=str, default="tpu")
    p.add_argument("--slurm_dir", type=str, default="slurm_jobs")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="passed to each eval command (its default: the CUDA card)")
    return p


def eval_command(args, ckpt: str, fold: int) -> list[str]:
    name = os.path.basename(os.path.normpath(ckpt))
    log = os.path.join(args.log_root, f"{name}_fold{fold}_{args.nshot}shot")
    return [
        sys.executable, "-m", "diffews_tpu_torch.cli.evaluate",
        "--checkpoint", args.base_checkpoint,
        "--unet_ckpt_path", os.path.join(ckpt, "unet"),
        "--scheduler_load_path", args.scheduler_load_path,
        "--datapath", args.datapath,
        "--benchmark", args.benchmark,
        "--fold", str(fold),
        "--nshot", str(args.nshot),
        "--img-size", "512",
        "--denoise_steps", "1",
        "--ensemble_size", "1",
        "--threshold", "0",
        "--r_threshold", str(args.r_threshold),
        "--half_precision",
        "--log-root", log,
    ] + (["--device", args.device] if args.device else [])


def main(argv=None):
    args = build_parser().parse_args(argv)
    checkpoints = list(args.checkpoints)
    if args.scan_logs:
        # cl_launcher_eval/cd/list behavior: pick experiments by substring,
        # evaluate their checkpoint-{iter} (`cl_launcher_eval.py:10-16`)
        for exp in sorted(os.listdir(args.scan_logs)):
            if args.match in exp and "eval" not in exp:
                ckpt = os.path.join(args.scan_logs, exp, f"checkpoint-{args.iter}")
                if os.path.isdir(os.path.join(ckpt, "unet")):
                    checkpoints.append(ckpt)
        print(f"scan: {len(checkpoints)} checkpoint(s) matched")
    if not checkpoints:
        raise SystemExit("no checkpoints: pass --checkpoints or --scan_logs")
    jobs = [(c, f) for c in checkpoints for f in args.folds]
    if args.mode == "local":
        for ckpt, fold in jobs:
            cmd = eval_command(args, ckpt, fold)
            print("+", " ".join(cmd))
            if not args.dry_run:
                subprocess.run(cmd, check=True)
    else:
        os.makedirs(args.slurm_dir, exist_ok=True)
        for i, (ckpt, fold) in enumerate(jobs):
            cmd = " ".join(eval_command(args, ckpt, fold))
            path = os.path.join(args.slurm_dir, f"eval_{i:03d}.sbatch")
            with open(path, "w") as f:
                f.write(
                    "#!/bin/bash\n"
                    f"#SBATCH --job-name=diffews-eval-{i}\n"
                    f"#SBATCH --partition={args.slurm_partition}\n"
                    "#SBATCH --ntasks=1\n"
                    f"{cmd}\n"
                )
            print("wrote", path)
        print(f"submit with: for f in {args.slurm_dir}/*.sbatch; do sbatch $f; done")


if __name__ == "__main__":
    main()
