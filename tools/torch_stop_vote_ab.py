#!/usr/bin/env python3
"""What the preemption vote of the train CLI costs a step, on the card.

Under a mesh the train CLI's ranks agree on the step to stop at after a
signal (`parallel/mesh.py::StopVote`): each step casts its vote as a MAX
all_reduce on the device and reads the previous step's result, so no step
waits for the device.  This tool times the CLI's step three ways, in turns
(A B C C B A), at full width (seeded SD-2.1 / SD-VAE / ViT-H weights, bf16,
512px, 1-shot b1, a synthetic COCO tree):

  - "lagged": `--num_data_shards 1 --fsdp` at world size 1 over NCCL, as
    the CLI runs;
  - "synced": the same with the vote read back at once (a host sync each
    step: what the CLI did before the vote was lagged);
  - "none": the plain CLI, no process group, no vote.

Each run takes `--steps` steps and logs only the first and the last, so
no other host read falls between them; its step wall is the mean over the
steps after the first.  Run on a host with a CUDA card (a few minutes):

    python3 tools/torch_stop_vote_ab.py [--steps 12] [--out stop_vote_ab.json]

The last line of its output is the report as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

ORDER = ("lagged", "synced", "none", "none", "synced", "lagged")
_WORLD_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
              "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _synced_vote():
    """`StopVote` with the vote read back in the step that cast it."""
    import torch
    import torch.distributed as dist

    from diffews_tpu_torch.parallel import mesh as mesh_lib

    class SyncedVote(mesh_lib.StopVote):
        def __call__(self, flag: bool) -> bool:
            t = torch.full((1,), int(flag), dtype=torch.int32, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
            return bool(t.item())

    return SyncedVote


def run_once(variant: str, ckpt: str, data: str, out: str, steps: int) -> dict:
    """One CLI run of `steps` steps; returns its mean step wall."""
    from diffews_tpu_torch.cli import train as TT
    from diffews_tpu_torch.parallel import mesh as mesh_lib

    argv = ["--pretrained_model_name_or_path", ckpt, "--datapath", data, "--benchmark",
            "coco", "--fold", "0", "--nshot", "1", "--resolution", "512",
            "--train_batch_size", "1", "--gradient_accumulation_steps", "1",
            "--max_train_steps", str(steps), "--logging_steps", str(steps),
            "--checkpointing_steps", str(10 * steps), "--seed", "0", "--output_dir", out,
            "--device", "cuda"]
    for k in _WORLD_ENV:
        os.environ.pop(k, None)
    if variant != "none":
        argv += ["--num_data_shards", "1", "--fsdp"]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                          GROUP_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(_free_port()))
    vote = mesh_lib.StopVote
    if variant == "synced":
        mesh_lib.StopVote = _synced_vote()
    try:
        report = TT.main(argv)
    finally:
        mesh_lib.StopVote = vote
        for k in _WORLD_ENV:
            os.environ.pop(k, None)
        shutil.rmtree(out, ignore_errors=True)
    walls = {r["step"]: r["wall_s"] for r in report["log"]}
    return {"variant": variant, "step_wall_s": (walls[steps] - walls[1]) / (steps - 1),
            "loss_last": report["log"][-1]["loss"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--workdir", default=None, help="default: a temporary directory")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_stop_vote_ab: needs a CUDA card")
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig, UNetConfig,
                                           VAEConfig)
    from helpers.port_checkpoint import write_checkpoint
    from helpers.synthetic_data import make_coco

    work = args.workdir or tempfile.mkdtemp(prefix="stop_vote_ab_")
    try:
        ckpt = write_checkpoint(os.path.join(work, "ckpt"), UNetConfig.sd21(), VAEConfig.sd(),
                                CLIPTextConfig.sd21(), SchedulerConfig.diffews(), seed=0,
                                safetensors=True, device="cuda")
        torch.cuda.empty_cache()
        data = make_coco(os.path.join(work, "data"))
        runs = [run_once(v, ckpt, data, os.path.join(work, f"run{i}"), args.steps)
                for i, v in enumerate(ORDER)]
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    report = {"card": _card(), "torch": torch.__version__, "steps": args.steps,
              "runs": runs,
              "median_step_wall_s": {v: statistics.median(r["step_wall_s"] for r in runs
                                                          if r["variant"] == v)
                                     for v in dict.fromkeys(ORDER)}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
