"""Turnkey baseline-throughput measurement (port of
`diffews_tpu/cli/measure_baseline.py`).

The `reference` and `reference-train` subjects build the same commands as
the JAX package's; `self` and `self-train` time the port's CLIs
(`diffews_tpu_torch.cli.evaluate`, `diffews_tpu_torch.cli.train`) on the
device `--device` names (their default: the CUDA card).  The marker
parsing, the warm-up exclusion and the watchdog are the JAX package's.

BASELINE.md says the reference's wall clock "must be measured, not
cited": this command measures it, and the port's, under one protocol (the
throughput counterpart of `cli/verify_parity.py`).

Modes (--subject):
  reference  — constructs the reference's exact eval command
               (the reference's `scripts/eval_coco2014_rthres_1shot_nosample.sh:14-30`:
               main_oss.py, bsz 1, 512px, denoise 1, threshold 0,
               r_threshold 0.25, seed-0 stream) from --reference_repo /
               --checkpoint / --unet_ckpt_path / --datapath and times it.
               Run this on the CUDA host; fold/nshot are flags.
  self       — times the port's `cli/evaluate.py` under the same protocol
               flags: a dry run on a synthetic checkpoint and synthetic
               COCO (`--device cpu`), and the card's counterpart on real
               data.
  reference-train — constructs the reference's canonical TRAINING command
               (`scripts/train_cocofold0_4090_nocrop_lr1_nearest_fold1_7shot_ori_v3.sh:3-12,18-49`:
               accelerate fp16, bs 1, gas 4, 512px, nshot flagged) and
               times its tqdm "Steps" progress over >= --min_steps
               optimizer steps (warmup/compile excluded).  Replaces the
               BASELINE.md REF_4090_TRAIN_STEPS_S derivation with a
               measurement the day a CUDA host exists.
  self-train — times the port's `cli/train.py` step logs under the same
               protocol knobs, on the card (or `--device cpu`).
  cmd        — escape hatch: time any command (--cmd "...") that logs the
               meter's progress markers (or, with --train_markers, either
               stack's training step markers).

Methodology: both stacks print `[Batch: NNNN/NNNN]` progress markers every
50 batches (reference `evaluation_util/main_oss.py:156` via
`common/logger.py:69-73`; ours `evaluation/meter.py:56-63`).  The harness
timestamps each marker AS IT ARRIVES on the subprocess pipe and computes

    qps = bsz * (last_marker_batch - first_marker_batch)
          / (t_last_marker - t_first_marker)

i.e. startup, checkpoint load, compile and warmup before the first marker
are excluded; >= 2 markers (>= 51 batches) are required, >= 200 episodes
recommended (the BASELINE.md protocol).

Training methodology: the reference trainer advances a tqdm bar (desc
"Steps", one tick per OPTIMIZER step — `train_icl_*_v3.py:1311-1316,1402`)
whose `\r`-separated redraws carry `N/TOTAL [`; our trainer prints
`step N/TOTAL loss ...` every --logging_steps (`cli/train.py:631`).  The
harness timestamps either marker family and computes

    steps_per_s = (last_step - first_step) / (t_last - t_first)

(optimizer steps; compile/startup before the first marker excluded).
With --write (train subjects) the result lands under the "train" key of
`artifacts/ref_qps.json` as `steps_per_s` — the measured replacement for
BASELINE.md's REF_4090_TRAIN_STEPS_S span.

Output: one JSON line; with --write the result is merged into
`artifacts/ref_qps.json` under its nshot key (eval) or "train" key,
where bench.py / BASELINE.md pick it up as the MEASURED denominator
(replacing the estimate and tagging records `baseline="measured"`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MARKER = re.compile(r"\[Batch:\s*(\d+)/(\d+)\]")
# training step markers: ours (`step N/M loss`) and the reference's tqdm
# redraws (`Steps ...  N/M [`) — tqdm separates redraws with \r, which the
# reader below treats as a line boundary.
_TRAIN_MARKERS = (re.compile(r"\bstep (\d+)/(\d+) loss"),
                  re.compile(r"Steps[^\r\n]*?\b(\d+)/(\d+)\s*\["))
DEFAULT_QPS_FILE = os.path.join(_REPO, "artifacts", "ref_qps.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "DiffewS baseline throughput harness (PyTorch port)", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--subject",
                   choices=["reference", "self", "reference-train",
                            "self-train", "cmd"],
                   required=True)
    p.add_argument("--reference_repo", default=None,
                   help="reference checkout root (subject=reference)")
    p.add_argument("--cmd", default=None,
                   help="subject=cmd: full command line to time")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--unet_ckpt_path", default=None)
    p.add_argument("--scheduler_load_path", default=None)
    p.add_argument("--datapath", default=None)
    p.add_argument("--benchmark", default="coco")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--bsz", type=int, default=1,
                   help="episodes per batch of the SUBJECT's run (the "
                        "reference protocol uses 1); scales the marker "
                        "deltas to episodes")
    p.add_argument("--max_episodes", type=int, default=0,
                   help="subject=self only: cap the protocol (0 = full)")
    p.add_argument("--log-root", default="./baseline_logs")
    p.add_argument("--timeout", type=float, default=7200.0,
                   help="hard wall-clock deadline for the subject, "
                        "enforced by a watchdog even if the subject "
                        "produces no output")
    # training-subject knobs (the reference's canonical footprint:
    # bs 1, gas 4, 512px, 20k steps — measured over --max_train_steps)
    p.add_argument("--max_train_steps", type=int, default=300,
                   help="train subjects: steps to run (>=200 + warmup "
                        "recommended; BASELINE.md protocol)")
    p.add_argument("--gas", type=int, default=4,
                   help="train subjects: gradient accumulation steps "
                        "(reference canonical: 4)")
    p.add_argument("--logging_steps", type=int, default=10,
                   help="self-train: our trainer's marker cadence")
    p.add_argument("--train_output_dir", default="./baseline_train_logs")
    p.add_argument("--min_steps", type=int, default=20,
                   help="train subjects: minimum optimizer steps between "
                        "first and last marker for a valid measurement")
    p.add_argument("--train_markers", action="store_true",
                   help="subject=cmd: parse training step markers instead "
                        "of [Batch:] eval markers")
    p.add_argument("--write", action="store_true",
                   help=f"merge the result into {DEFAULT_QPS_FILE} "
                        "(bench.py's measured-denominator hook). Only the "
                        "reference subject may write — the denominator is "
                        "the REFERENCE's throughput")
    p.add_argument("--force_write", action="store_true",
                   help="allow --write for subject self/cmd (e.g. timing a "
                        "reference install via --cmd)")
    p.add_argument("--qps_file", default=DEFAULT_QPS_FILE)
    p.add_argument("--device", default=None,
                   help="self subjects: the port CLI's --device (its default: "
                        "the CUDA card)")
    return p


def subject_command(args) -> tuple[list[str], str | None, dict]:
    """(argv, cwd, extra_env) for the subject."""
    if args.subject == "cmd":
        if not args.cmd:
            raise SystemExit("--subject cmd needs --cmd")
        import shlex

        return shlex.split(args.cmd), None, {}
    if args.subject == "reference-train":
        for need in ("reference_repo", "checkpoint", "datapath"):
            if not getattr(args, need):
                raise SystemExit(f"--subject reference-train needs --{need}")
        # scripts/train_cocofold0_4090_nocrop_lr1_nearest_fold1_7shot_ori_v3.sh
        # :18-49 — the canonical accelerate command, paths/fold/nshot/steps
        # substituted; 2000-step checkpoint/validation cadences never fire
        # inside a <=2000-step measurement window.
        argv = [
            "accelerate", "launch", "--num_processes", "1",
            "--main_process_port", "1234",
            "--mixed_precision", "fp16", "--num_machines", "1",
            "train_tools/train_icl_multitask_nocrop_nearest_nshot_v3.py",
            "--mixed_precision=fp16",
            "--train_batch_size=1",
            "--checkpointing_steps", "2000",
            f"--pretrained_model_name_or_path={args.checkpoint}",
            f"--output_dir={args.train_output_dir}",
            "--train_data_dir", args.datapath,
            "--resolution=%d" % getattr(args, "img_size"),
            "--learning_rate=1e-5",
            "--lr_warmup_steps", "0",
            f"--max_train_steps={args.max_train_steps}",
            "--validation_steps", "2000",
            "--lr_scheduler", "polynomial",
            "--lr_scheduler_power", "1.0",
            f"--gradient_accumulation_steps={args.gas}",
            "--enable_xformers_memory_efficient_attention",
            "--max_grad_norm=1.0",
            "--adam_weight_decay=1e-2",
            "--seed=42",
            "--allow_tf32",
            "--dataloader_num_workers=16",
            "--nshot", str(args.nshot),
            f"--fold={args.fold}",
        ]
        if args.scheduler_load_path:
            argv += ["--scheduler_load_path", args.scheduler_load_path]
        return argv, args.reference_repo, {"PYTHONPATH": "./"}
    if args.subject == "self-train":
        for need in ("checkpoint", "datapath"):
            if not getattr(args, need):
                raise SystemExit(f"--subject self-train needs --{need}")
        argv = [
            sys.executable, "-m", "diffews_tpu_torch.cli.train",
            "--pretrained_model_name_or_path", args.checkpoint,
            "--datapath", args.datapath,
            "--benchmark", args.benchmark,
            "--fold", str(args.fold),
            "--nshot", str(args.nshot),
            "--resolution", str(getattr(args, "img_size")),
            "--train_batch_size", str(args.bsz),
            "--gradient_accumulation_steps", str(args.gas),
            "--max_train_steps", str(args.max_train_steps),
            "--learning_rate", "1e-5",
            "--lr_warmup_steps", "0",
            "--seed", "42",
            "--output_dir", args.train_output_dir,
            "--checkpointing_steps", str(args.max_train_steps),
            "--logging_steps", str(args.logging_steps),
            "--dataloader_num_workers", "0",
        ] + _device_flag(args)
        return argv, _REPO, {}
    if args.subject == "reference":
        for need in ("reference_repo", "checkpoint", "datapath"):
            if not getattr(args, need):
                raise SystemExit(f"--subject reference needs --{need}")
        argv = [
            sys.executable, "evaluation_util/main_oss.py",
            "--log-root", args.log_root,
            "--denoise_steps", "1",
            "--checkpoint", args.checkpoint,
            "--datapath", args.datapath,
            "--benchmark", args.benchmark,
            "--img-size", str(getattr(args, "img_size")),
            "--ensemble_size", "1",
            "--bsz", str(args.bsz),
            "--nshot", str(args.nshot),
            "--fold", str(args.fold),
            "--threshold", "0",
            "--r_threshold", "0.25",
        ]
        if args.unet_ckpt_path:
            argv += ["--unet_ckpt_path", args.unet_ckpt_path]
        if args.scheduler_load_path:
            argv += ["--scheduler_load_path", args.scheduler_load_path]
        return argv, args.reference_repo, {"PYTHONPATH": "./"}
    # self
    for need in ("checkpoint", "datapath"):
        if not getattr(args, need):
            raise SystemExit(f"--subject self needs --{need}")
    argv = [
        sys.executable, "-m", "diffews_tpu_torch.cli.evaluate",
        "--log-root", args.log_root,
        "--denoise_steps", "1",
        "--checkpoint", args.checkpoint,
        "--datapath", args.datapath,
        "--benchmark", args.benchmark,
        "--img-size", str(getattr(args, "img_size")),
        "--ensemble_size", "1",
        "--bsz", str(args.bsz),
        "--nshot", str(args.nshot),
        "--fold", str(args.fold),
        "--threshold", "0",
        "--r_threshold", "0.25",
    ]
    if args.max_episodes:
        argv += ["--max_episodes", str(args.max_episodes)]
    if args.unet_ckpt_path:
        argv += ["--unet_ckpt_path", args.unet_ckpt_path]
    if args.scheduler_load_path:
        argv += ["--scheduler_load_path", args.scheduler_load_path]
    return argv + _device_flag(args), _REPO, {}


def _device_flag(args) -> list[str]:
    return ["--device", args.device] if args.device else []


def _iter_chunk_lines(fd):
    """Yield logical lines from a pipe fd, treating BOTH \\n and \\r as
    line boundaries (tqdm redraws its bar with \\r and never \\n)."""
    buf = b""
    while True:
        try:
            chunk = os.read(fd, 65536)
        except OSError:
            chunk = b""
        if not chunk:
            if buf:
                yield buf.decode("utf-8", "replace")
            return
        buf += chunk
        parts = re.split(rb"[\r\n]", buf)
        buf = parts.pop()
        for part in parts:
            if part:
                yield part.decode("utf-8", "replace")


def time_subject(argv, cwd, extra_env, bsz, timeout, train=False,
                 min_steps=20) -> dict:
    """Run the subject, timestamp its progress markers, compute the rate.

    Eval subjects: `[Batch: n/m]` meter markers -> episodes/s (qps).
    Train subjects (train=True): optimizer-step markers (our
    `step N/M loss` logs or the reference's tqdm "Steps" redraws) ->
    opt-steps/s.  Compile/startup before the first marker is excluded
    either way.

    The --timeout deadline is enforced by a watchdog timer that kills the
    subject even if it hangs while producing NO output (a silent hang
    would otherwise block the pipe read forever)."""
    env = dict(os.environ)
    env.update(extra_env)
    t_start = time.monotonic()
    proc = subprocess.Popen(argv, cwd=cwd, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    timed_out = threading.Event()

    def _watchdog():
        timed_out.set()
        proc.kill()

    watchdog = threading.Timer(timeout, _watchdog)
    watchdog.daemon = True
    watchdog.start()
    markers: list[tuple[float, int, int]] = []  # (t, step/batch idx, total)
    patterns = _TRAIN_MARKERS if train else (_MARKER,)
    tail: list[str] = []
    try:
        assert proc.stdout is not None
        for line in _iter_chunk_lines(proc.stdout.fileno()):
            tail.append(line.rstrip())
            if len(tail) > 40:
                tail.pop(0)
            for pat in patterns:
                m = pat.search(line)
                if m:
                    markers.append((time.monotonic(),
                                    int(m.group(1)), int(m.group(2))))
                    print(f"[measure +{time.monotonic() - t_start:7.1f}s] "
                          f"marker {'step' if train else 'batch'} "
                          f"{m.group(1)}/{m.group(2)}",
                          file=sys.stderr, flush=True)
                    break
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    if timed_out.is_set():
        raise SystemExit(f"subject exceeded --timeout={timeout:g}s after "
                         f"{len(markers)} markers (killed by watchdog)")
    wall_total = time.monotonic() - t_start
    if rc != 0:
        raise SystemExit("subject failed rc=%d; tail:\n%s"
                         % (rc, "\n".join(tail)))
    # tqdm re-draws at a fixed real-time cadence, so consecutive markers can
    # repeat a step index; dedupe to strictly-increasing indices.
    dedup = [markers[0]] if markers else []
    for rec in markers[1:]:
        if rec[1] > dedup[-1][1]:
            dedup.append(rec)
    markers = dedup
    # a train-mode "0/N" tick is tqdm's bar-creation redraw, emitted BEFORE
    # model load/compile — keeping it would count startup as measured time
    if train and markers and markers[0][1] == 0:
        markers = markers[1:]
    if len(markers) < 2:
        raise SystemExit(
            f"only {len(markers)} progress marker(s) seen — need >= 2 "
            + ("to exclude warmup; raise --max_train_steps" if train else
               "(>= 51 batches at the 50-batch cadence) to exclude "
               "warmup; run more episodes"))
    (t0, b0, _), (t1, b1, _) = markers[0], markers[-1]
    if train:
        steps = b1 - b0
        if steps < min_steps:
            raise SystemExit(
                f"only {steps} optimizer steps between first and last "
                f"marker (< --min_steps={min_steps}); raise "
                "--max_train_steps for a trustworthy cadence")
        return {
            "steps_per_s": round(steps / (t1 - t0), 4),
            "steps_timed": steps,
            "wall_timed_s": round(t1 - t0, 2),
            "wall_total_s": round(wall_total, 2),
            "markers": len(markers),
            "warmup_excluded_s": round(t0 - t_start, 2),
        }
    episodes = bsz * (b1 - b0)
    qps = episodes / (t1 - t0)
    return {
        "qps": round(qps, 4),
        "episodes_timed": episodes,
        "wall_timed_s": round(t1 - t0, 2),
        "wall_total_s": round(wall_total, 2),
        "markers": len(markers),
        "warmup_excluded_s": round(t0 - t_start, 2),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    train = (args.subject in ("reference-train", "self-train")
             or (args.subject == "cmd" and args.train_markers))
    cmd, cwd, extra_env = subject_command(args)
    print(f"[measure] timing: {' '.join(cmd)}", file=sys.stderr, flush=True)
    res = time_subject(cmd, cwd, extra_env, args.bsz, args.timeout,
                       train=train, min_steps=args.min_steps)
    key = "train" if train else f"{args.nshot}shot"
    proto = {"benchmark": args.benchmark, "fold": args.fold,
             "nshot": args.nshot,
             "img_size": getattr(args, "img_size"),
             "bsz": args.bsz}
    if train:
        proto["gas"] = args.gas
        proto["max_train_steps"] = args.max_train_steps
    rec = {
        "subject": args.subject,
        "protocol": proto,
        **res,
    }
    if args.write:
        if (args.subject not in ("reference", "reference-train")
                and not args.force_write):
            raise SystemExit(
                "--write records the BASELINE DENOMINATOR; refusing for "
                f"subject '{args.subject}' (our own throughput is not the "
                "baseline). Pass --force_write only if this command really "
                "timed the reference stack.")
        data = {}
        if os.path.exists(args.qps_file):
            with open(args.qps_file) as f:
                data = json.load(f)
        data[key] = rec
        os.makedirs(os.path.dirname(args.qps_file), exist_ok=True)
        with open(args.qps_file, "w") as f:
            json.dump(data, f, indent=2)
        rec["written_to"] = args.qps_file
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
