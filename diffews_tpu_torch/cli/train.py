"""In-context n-shot training CLI of the port.

Port of `diffews_tpu/cli/train.py` (the counterpart of the reference's
`train_tools/train_icl_multitask_nocrop_nearest_nshot_v3.py`): the same
flags and defaults, the same counter-keyed training stream, checkpoints in
the reference's `checkpoint-{step}/unet` diffusers layout (read by the
reference's eval, the JAX package and the port), exact resume, graceful
preemption, LoRA and periodic validation.  It drives the port's training
step (`training/state.py`, `training/lora.py`) on one CUDA card.  What
differs:

  - `--device` (default: the CUDA card, raising on a host without one;
    `cpu` runs the kernels' plain versions) takes the place of the JAX
    package's platform hook;
  - `--attn_impl` auto / xla / pallas map onto the step's auto / dense /
    flash (`pipeline.ATTN_IMPLS`);
  - multi-device training runs one process per device under `torchrun`
    (`torchrun --nproc_per_node N -m diffews_tpu_torch.cli.train
    --num_data_shards N [--fsdp] ...`; over several nodes torchrun's
    `--nnodes` / `--node_rank` give the node split, and `--multihost` is
    accepted for parity with the JAX CLI): data parallelism with the
    gradients mean-reduced over "data", or FSDP with the state born sharded
    (`parallel/mesh.py`).  A torch node is a JAX process: its ranks sample
    the node's batch alike (seeds offset by the node index, as JAX offsets
    them by the process index) and each keeps its rows, so one node of N
    ranks runs JAX's one-process N-chip stream.  Rank 0 alone logs,
    validates and writes; checkpoints equal an unsharded run's.  The mesh
    runs over the device's backend (NCCL on the card, gloo on the CPU).
    A preemption stops every rank one step after the signal: the ranks
    agree on the stop step a step late, so that no step waits on the host.
    `--num_model_shards` above 1 raises (tensor parallelism, ROADMAP A11b);
  - the optimizer, EMA and step state is `train_state.pt`
    (`training/checkpoints.py`), not flax msgpack;
  - each step's posterior-sample noise is drawn from a CPU generator keyed
    by (seed, step) (`step_noise`), so the stream is the same on every
    device; `--profile_step` writes a `torch.profiler` trace;
  - on a CUDA device the CLI sets `torch.backends.cudnn.deterministic`
    while it runs, and puts the process's setting back when `main`
    returns: cuDNN's default algorithms may sum a convolution's gradient in
    a different order from run to run, and the exact resume promised above
    needs the same bits every time (the JAX package's compiled step is
    deterministic as it stands).

Usage (mirrors `scripts/train_coco_*.sh`):

    python -m diffews_tpu_torch.cli.train \\
        --pretrained_model_name_or_path weight/stable-diffusion-2-1-ref8inchannels-tag4inchannels \\
        --datapath FSSBench --benchmark coco --fold 0 --nshot 1 --resolution 512 \\
        --train_batch_size 1 --gradient_accumulation_steps 4 --max_train_steps 20000 \\
        --checkpointing_steps 2000 --output_dir logs/diffews-train --seed 0
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import random
import signal
import threading
import time

import numpy as np
import torch

from diffews_tpu_torch import checkpoint as ckpt_lib
from diffews_tpu_torch.data.dataset import FSSDataset
from diffews_tpu_torch.models import clip_text
from diffews_tpu_torch.parallel import mesh as mesh_lib
from diffews_tpu_torch.pipeline import ATTN_IMPLS, resolve_device
from diffews_tpu_torch.training import checkpoints as tck
from diffews_tpu_torch.training import lora as lora_lib
from diffews_tpu_torch.training.state import (TrainerConfig, init_state, make_train_step,
                                              training_text_embed)
from diffews_tpu_torch.utils import to_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DiffewS in-context training (PyTorch port)")
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True,
                   help="base checkpoint (ref8inchannels surgery output)")
    p.add_argument("--scheduler_load_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="logs/diffews-train")
    p.add_argument("--seed", type=int, default=None)
    # data
    p.add_argument("--datapath", "--train_data_dir", dest="datapath",
                   type=str, default="datasets")
    p.add_argument("--benchmark", type=str, default="coco",
                   help="benchmark or comma-list for multitask")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--nshot", type=int, default=1, help="max shots (pad+mask)")
    p.add_argument("--resolution", "--img_size", dest="resolution", type=int, default=512)
    p.add_argument("--dataloader_num_workers", type=int, default=2)
    # optimization
    p.add_argument("--train_batch_size", type=int, default=1,
                   help="per-device episode batch")
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--max_train_steps", type=int, default=20000)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_scheduler", type=str, default="polynomial")
    p.add_argument("--lr_scheduler_power", type=float, default=1.0)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--reference_lr_quirk", action="store_true",
                   help="advance the LR schedule gas x faster, bit-matching "
                        "the reference's per-micro-batch scheduler stepping")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--train_timestep", type=int, default=1)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "bf16", "fp16"],
                   help="'fp16' (the reference's choice) runs as bf16: no loss "
                        "scaling needed")
    p.add_argument("--attn_impl", type=str, default="auto", choices=sorted(ATTN_IMPLS),
                   help="auto / pallas: the CUDA flash kernels on the card (their "
                        "plain versions on the CPU); xla: dense attention")
    p.add_argument("--attn_mask_variant", action="store_true",
                   help="train the experimental attn-mask conditioning "
                        "variant (support masks as per-level attention key "
                        "biases, `unet_2d_condition_attn.py`); evaluate "
                        "checkpoints with `cli/evaluate.py "
                        "--attn_mask_variant`")
    p.add_argument("--no_remat", action="store_true")
    # parallelism: one torchrun rank per device
    p.add_argument("--num_data_shards", type=int, default=0,
                   help="data-parallel size (0 = every rank); above 1, or under "
                        "torchrun, the ranks' world must have this many")
    p.add_argument("--multihost", action="store_true",
                   help="accepted for parity with the JAX CLI; a multi-node run "
                        "takes its node split from torchrun (--nnodes, --node_rank), "
                        "and outside torchrun the flag raises")
    p.add_argument("--num_model_shards", type=int, default=1,
                   help="tensor-parallel size; only 1 (ROADMAP A11b)")
    # LoRA (no reference equivalent: the reference only fine-tunes the
    # whole UNet); checkpoints still write the merged model
    p.add_argument("--lora_rank", type=int, default=0,
                   help="0 = full fine-tuning; >0 trains LoRA adapters")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="LoRA scale numerator (default: rank, i.e. scale 1)")
    p.add_argument("--lora_targets", type=str, default="attn",
                   choices=["attn", "attn+ff"])
    p.add_argument("--fsdp", action="store_true",
                   help="shard the float32 masters, Adam moments and EMA over the "
                        "data ranks (born sharded); under torchrun")
    # checkpointing / logging
    p.add_argument("--checkpointing_steps", type=int, default=2000)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'latest' or a checkpoint-N dir")
    p.add_argument("--report_to", type=str, default="none",
                   choices=["none", "tensorboard", "wandb"],
                   help="experiment tracker (reference `--report_to`); wandb "
                        "degrades to a warning when the package is not installed")
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--metrics_jsonl", type=str, default="",
                   help="append {step, loss, steps_per_s, wall_s, "
                        "total_notfinite} at every logging interval "
                        "(appends across resumes)")
    p.add_argument("--profile_step", type=int, default=0,
                   help="capture a torch.profiler trace starting at this "
                        "optimizer step (0 = off) into {output_dir}/profile")
    p.add_argument("--profile_num_steps", type=int, default=3,
                   help="steps to include in the --profile_step trace")
    # periodic validation (log_validation + eval_results.txt,
    # `train_icl_*_v3.py:173-326,1436-1441`)
    p.add_argument("--validation_steps", type=int, default=0,
                   help="run val episodes every N steps (0 = off)")
    p.add_argument("--validation_episodes", type=int, default=50)
    p.add_argument("--validation_image_grids", type=int, default=4,
                   help="save the first N validation episodes as image "
                        "strips under {output_dir}/validation/ (0 = off)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, which must be "
                        "present; 'cpu' runs the kernels' plain versions)")
    # accepted for compatibility: reference flags with nothing to do here
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true",
                   help="no-op: the flash kernels are the default")
    p.add_argument("--allow_tf32", action="store_true",
                   help="no-op: the process's TF32 settings stand")
    p.add_argument("--tracker_project_name", type=str, default=None,
                   help="wandb project name")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="no-op (HF hub cache; checkpoints are local dirs)")
    for col in ("image_ref_column", "image_tag_column", "conditioning_image_ref_column",
                "conditioning_image_tag_column", "caption_column"):
        p.add_argument(f"--{col}", type=str, default=None,
                       help="no-op (HF-datasets column naming; the episodic "
                            "loader has no column concept)")
    return p


def _install_preemption_handler():
    """The first SIGTERM/SIGINT asks for a clean stop: finish the step in
    flight, write a checkpoint, exit 0; the training stream is counter-keyed,
    so `--resume_from_checkpoint latest` continues it exactly.  A second
    signal restores the previous disposition and re-delivers itself, so a
    wedged run can still be killed.

    Returns `(stop_event, restore_fn)`.  Signal handlers can only be set
    from the main thread; elsewhere this is a no-op event."""
    stop = threading.Event()
    prev = {}

    def handler(signum, frame):
        if stop.is_set():  # second signal: give up gracefulness
            signal.signal(signum, prev.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        print(f"[preempt] received {signal.Signals(signum).name}: finishing "
              "the current step, then checkpointing and exiting "
              "(resume with --resume_from_checkpoint latest)", flush=True)
        stop.set()

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            prev[s] = signal.signal(s, handler)
    except ValueError:  # not the main thread
        return stop, lambda: None

    def restore():
        for s, h in prev.items():
            signal.signal(s, h)

    return stop, restore


def _mix(*parts: int) -> int:
    """Deterministic 64-bit seed from integer parts (hash() is salted per
    process and unusable for cross-run determinism)."""
    h = hashlib.blake2b(",".join(str(p) for p in parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def _episode_to_streams(batch, rng: random.Random, max_nshot: int):
    """Host-side per-step tensor prep, matching `train_icl_*_v3.py:1325-1340`:
    masks to 3-channel [-1,1]; random 1..max_nshot shot subset -> bool mask
    over padded supports (mask semantics == physically dropping the shots).

    With raw-uint8 episodes (`FSSDataset.initialize(raw_images=True)`, the
    train CLI default) images stay uint8 HWC and masks stay binary uint8;
    normalization and folding run inside the train step (identical
    arithmetic, ~8x smaller upload)."""
    if batch["query_img"].dtype == np.uint8:  # raw path: already HWC
        q, sup = batch["query_img"], batch["support_imgs"]
        qm = batch["query_mask"].astype(np.uint8)
        sm = batch["support_masks"].astype(np.uint8)
    else:
        q = np.moveaxis(batch["query_img"], 1, -1).astype(np.float32)
        sup = np.moveaxis(batch["support_imgs"], 2, -1).astype(np.float32)
        qm = (np.repeat(batch["query_mask"][:, :, :, None], 3, -1)
              * 2.0 - 1.0).astype(np.float32)
        sm = (np.repeat(batch["support_masks"][:, :, :, :, None], 3, -1)
              * 2.0 - 1.0).astype(np.float32)
    b, n = sup.shape[:2]
    shot_mask = np.zeros((b, n), dtype=bool)
    for i in range(b):
        k = rng.randint(1, max_nshot)
        shot_mask[i, rng.sample(range(n), k)] = True
    return q, qm, sup, sm, shot_mask


def _deterministic_cudnn():
    """Exact resume on the card: cuDNN's deterministic algorithms only."""
    torch.backends.cudnn.deterministic = True


def step_noise(seed: int, step: int, shape) -> torch.Tensor:
    """The posterior-sample noise of optimizer step `step`: standard normal
    draws of `shape` (gas, images, h, w, latent channels), float32, from a
    CPU generator keyed by (seed, step), so resume and every device see
    the same stream."""
    gen = torch.Generator().manual_seed(_mix(seed, step, 2) & 0x7FFFFFFFFFFFFFFF)
    return torch.randn(tuple(shape), generator=gen)


def _rank_noise(noise: torch.Tensor, b: int, n: int, rows: slice,
                attn_mask_variant: bool) -> torch.Tensor:
    """This rank's images of the global batch's noise (G, images, ...): the
    step encodes [query (B) ‖ query mask (B) ‖ supports (B·N) ‖ support
    masks (B·N)] (no support masks under the attn-mask variant), so the
    rows `rows` of the batch own those slices of each stream."""
    streams = [(0, 1), (b, 1), (2 * b, n)]
    if not attn_mask_variant:
        streams.append((2 * b + b * n, n))
    return torch.cat([noise[:, off + rows.start * k:off + rows.stop * k]
                      for off, k in streams], dim=1)


def _setup_mesh(args, device_type: str):
    """(mesh, host_index, host_count, owns_group): the ("data",) mesh of a
    torchrun launch (None for one plain process) on `device_type`'s
    backend, with the JAX CLI's checks."""
    if args.num_model_shards > 1:
        raise NotImplementedError("--num_model_shards > 1: tensor parallelism is not "
                                  "ported (ROADMAP A11b)")
    if not (args.fsdp or args.multihost or args.num_data_shards > 1 or mesh_lib.launched()):
        return None, 0, 1, False
    if not mesh_lib.launched():
        raise RuntimeError(
            "--fsdp / --multihost / --num_data_shards > 1: launch one process per "
            f"device with torchrun --nproc_per_node {max(args.num_data_shards, 1)} "
            "-m diffews_tpu_torch.cli.train ...")
    owns = not torch.distributed.is_initialized()
    host_idx, host_cnt = mesh_lib.maybe_initialize_distributed(device_type=device_type)
    mesh = mesh_lib.make_mesh(device_type, args.num_data_shards or None)
    return mesh, host_idx, host_cnt, owns


def main(argv=None) -> dict:
    """Train; returns a report of the run (steps, logged losses and walls,
    load / resume seconds, each save's snapshot and write seconds and
    bytes; rank 0's under torchrun)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device cpu: raise now
    deterministic = torch.backends.cudnn.deterministic
    if device.type == "cuda":
        _deterministic_cudnn()
    try:
        return _train(args, device)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _train(args, device) -> dict:
    # ---- multi-device bootstrap (before any device use) ----
    mesh, host_idx, host_cnt, owns_group = _setup_mesh(args, device.type)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    is_main = mesh_lib.rank() == 0
    if args.lora_rank > 0 and args.fsdp:
        raise SystemExit("--fsdp with --lora_rank is pointless (the adapter state is "
                         "rank-sized); drop one")
    if args.train_batch_size % host_cnt:
        raise SystemExit(f"train_batch_size {args.train_batch_size} not divisible "
                         f"by process count {host_cnt}")
    local_bs = args.train_batch_size // host_cnt
    data_group = mesh_lib.axis_group(mesh, "data") if mesh is not None else None
    # this rank's rows of the global batch (all of them for one process)
    my_rows = (mesh_lib.rows(args.train_batch_size, mesh_lib.axis_size(mesh, "data"),
                             mesh_lib.axis_rank(mesh, "data"))
               if mesh is not None else slice(0, args.train_batch_size))
    report = {"device": str(device), "log": [], "saves": []}

    if args.seed is not None:
        # per-node seed offset: each node samples its own episodes (JAX's
        # per-process offset, the DDP-sampler equivalent)
        random.seed(args.seed + host_idx)
        np.random.seed(args.seed + host_idx)
    # All training-stream randomness is counter-keyed rather than stateful:
    # episode sampling by (seed, node, benchmark, batch index) through
    # the loader's batch_seed mode, shot subsets by (seed, node, micro
    # index), the noise by (seed, step).  The stream is a pure function of
    # (seed, global_step): resume continues it exactly with no RNG state in
    # checkpoints, and validation (which replays the seeded eval protocol)
    # cannot perturb it.
    base_seed = args.seed if args.seed is not None else 0
    on_card = device.type == "cuda"
    fmt = torch.channels_last if on_card else torch.contiguous_format

    # ---- models ----
    t0 = time.perf_counter()
    bundle = ckpt_lib.load_pipeline_bundle(args.pretrained_model_name_or_path,
                                           scheduler_dir=args.scheduler_load_path)
    report["load_s"] = time.perf_counter() - t0
    dt = torch.bfloat16 if args.mixed_precision in ("bf16", "fp16") else torch.float32
    tcfg = TrainerConfig(
        learning_rate=args.learning_rate, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, adam_epsilon=args.adam_epsilon,
        adam_weight_decay=args.adam_weight_decay, max_grad_norm=args.max_grad_norm,
        lr_scheduler=args.lr_scheduler, lr_power=args.lr_scheduler_power,
        lr_warmup_steps=args.lr_warmup_steps, max_train_steps=args.max_train_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        train_timestep=args.train_timestep, max_nshot=args.nshot, use_ema=args.use_ema,
        compute_dtype=dt, attn_impl=ATTN_IMPLS[args.attn_impl],
        attn_mask_variant=args.attn_mask_variant, remat=not args.no_remat,
        lr_steps_per_opt_step=(args.gradient_accumulation_steps
                               if args.reference_lr_quirk else 1),
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        lora_targets=args.lora_targets)

    # the text encoder runs once: the 77-token training embedding and the
    # [bos, eos] one of validation's pipeline; then it is freed
    text = bundle.text.to(device)
    text_embed = training_text_embed(text, bundle.text_cfg)
    with torch.inference_mode():
        val_text_embed = text(clip_text.empty_prompt_ids(bundle.text_cfg, device=device))
    bundle.text = text = None
    # the frozen VAE in the compute dtype, channels-last on the card
    vae = bundle.vae.to(device=device, dtype=dt, memory_format=fmt).requires_grad_(False)
    unet, unet_cfg = bundle.unet, bundle.unet_cfg
    bundle.unet = None

    layout = None  # the FSDP layout of the state, under --fsdp
    base_c = base_host = None
    if args.lora_rank > 0:
        # the f32 base stays on the host for the checkpoint merges (the
        # written unet/ carries f32 weights like a full fine-tuning one);
        # the UNet itself becomes the frozen compute-dtype base
        base_host = {n: p.detach() for n, p in unet.named_parameters()}
        unet = unet.to(device=device, dtype=dt, memory_format=fmt).requires_grad_(False)
        base_c = {n: p.detach() for n, p in unet.named_parameters()}
        lora0 = lora_lib.init_lora(args.seed or 0, base_host, args.lora_rank,
                                   lora_lib.target_filter(args.lora_targets))
        n_lora = sum(t.numel() for ab in lora0.values() for t in ab.values())
        report["trainable_params"] = n_lora
        if is_main:
            print(f"LoRA rank {args.lora_rank} ({args.lora_targets}): "
                  f"{n_lora / 1e6:.2f}M trainable params")
        state = init_state(tcfg, lora_lib.flatten(lora0), device=device)
        step_fn = lora_lib.make_lora_train_step(tcfg, unet, data_group=data_group)
    elif args.fsdp:
        # born sharded: each rank moves only its shards to the device; the
        # module stays on the host as the structure the gathered weights
        # are bound to
        report["trainable_params"] = sum(p.numel() for p in unet.parameters())
        state, layout = mesh_lib.init_state_fsdp(tcfg, dict(unet.named_parameters()), mesh,
                                                 device=device)
        step_fn = make_train_step(tcfg, unet, layout=layout)
    else:
        # the masters are the module's own parameters, moved once
        unet = unet.to(device=device, memory_format=fmt)
        state = init_state(tcfg, dict(unet.named_parameters()), device=device)
        report["trainable_params"] = sum(p.numel() for p in state.params.values())
        step_fn = make_train_step(tcfg, unet, data_group=data_group)
    lora_scale = lora_lib.lora_scale(tcfg) if args.lora_rank > 0 else None

    def merged_unet_params(st):
        """The full UNet weights: the live masters under full fine-tuning,
        the compute-dtype base + adapters in LoRA mode; under FSDP gathered
        to the host (a collective every rank joins)."""
        if layout is not None:
            return tck.host_fetch(st.params, layout)
        if args.lora_rank == 0:
            return st.params
        with torch.no_grad():
            return lora_lib.merge_lora(base_c, lora_lib.unflatten(st.params), lora_scale)

    # ---- resume ----
    global_step = 0
    resumed_in_output_dir = False
    if args.resume_from_checkpoint:
        ckpt = (tck.latest_checkpoint(args.output_dir)
                if args.resume_from_checkpoint == "latest" else args.resume_from_checkpoint)
        if ckpt:
            resumed_in_output_dir = (os.path.dirname(os.path.abspath(ckpt))
                                     == os.path.abspath(args.output_dir))
            t0 = time.perf_counter()
            state, global_step = tck.load_checkpoint(ckpt, state, lora=args.lora_rank > 0,
                                                     layout=layout)
            report["resume_s"] = time.perf_counter() - t0
            if is_main:
                print(f"resumed from {ckpt} @ step {global_step}")

    # ---- data: round-robin over benchmarks (multitask) ----
    FSSDataset.initialize(args.resolution, args.datapath, raw_images=True)
    benchmarks = [b.strip() for b in args.benchmark.split(",") if b.strip()]
    loaders = [FSSDataset.build_dataloader(b, local_bs,
                                           args.dataloader_num_workers, args.fold, "trn",
                                           args.nshot, batch_seed=_mix(base_seed, host_idx, bi))
               for bi, b in enumerate(benchmarks)]
    # resume continues the exact episode stream: micro-batch m draws from
    # stream m % n, so after `consumed` micro-batches stream i has served
    # ceil((consumed - i) / n) batches
    consumed = global_step * args.gradient_accumulation_steps
    for i, l in enumerate(loaders):
        n = len(benchmarks)
        l.set_position(consumed // n + (1 if i < consumed % n else 0))

    def endless(loader):
        while True:
            yield from loader

    streams = [endless(l) for l in loaders]
    rot = consumed % len(streams)
    robin = itertools.cycle(streams[rot:] + streams[:rot])

    writer = wandb_run = None
    if not is_main:
        pass
    elif args.report_to == "tensorboard":
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(args.output_dir, "tb"))
    elif args.report_to == "wandb":
        try:
            import wandb

            wandb_run = wandb.init(project=args.tracker_project_name or "diffews_tpu",
                                   dir=args.output_dir, config=vars(args))
        except ImportError:
            print("WARNING: --report_to wandb requested but wandb is not "
                  "installed; continuing without a tracker")

    def log_scalar(tag, value, step):
        if writer:
            writer.add_scalar(tag, value, step)
        if wandb_run:
            wandb_run.log({tag: value}, step=step)

    def log_image(tag, img_hwc_uint8, step):
        if writer:
            writer.add_image(tag, img_hwc_uint8, step, dataformats="HWC")
        if wandb_run:
            import wandb

            wandb_run.log({tag: wandb.Image(img_hwc_uint8)}, step=step)

    # ---- lazy validation pipeline: shares the frozen VAE; a UNet of its
    # own in the compute dtype takes the live weights at every validation
    val_state = {}

    def run_validation(unet_params, step):
        from PIL import Image

        from diffews_tpu_torch.evaluation import AverageMeter, Evaluator
        from diffews_tpu_torch.evaluation.vis import episode_strip
        from diffews_tpu_torch.models.unet import UNet2DConditionModel
        from diffews_tpu_torch.pipeline import DiffewsPipeline
        from diffews_tpu_torch.utils.init import build_module

        if "pipe" not in val_state:
            vb = ckpt_lib.PipelineBundle(
                build_module(UNet2DConditionModel, unet_cfg, device=device), unet_cfg,
                vae, bundle.vae_cfg, None, bundle.text_cfg, bundle.scheduler_cfg)
            pipe = DiffewsPipeline(vb, device=device, compute_dtype=dt,
                                   attn_impl=tcfg.attn_impl,
                                   attn_mask_variant=args.attn_mask_variant)
            pipe.empty_text_embed = val_text_embed.to(dt)
            val_state["pipe"] = pipe
            val_state["loader"] = FSSDataset.build_dataloader(
                benchmarks[0], 1, 0, args.fold, "test", min(args.nshot, 5))
        pipe = val_state["pipe"]
        with torch.no_grad():
            for n, p in pipe.unet.named_parameters():
                p.copy_(unet_params[n])  # cast to the compute dtype
        loader = val_state["loader"]
        meter = AverageMeter(loader.dataset.benchmark, loader.dataset.class_ids)
        # replay the seeded eval protocol through a private RandomState(0)
        # (the draws of `np.random.seed(0)` + global calls) without
        # touching the global RNG
        loader.dataset.rng = np.random.RandomState(0)
        grid_dir = os.path.join(args.output_dir, "validation")
        for i, vb in zip(range(args.validation_episodes), loader):
            smask = vb["support_masks"].astype(np.uint8)
            out = pipe.predict(vb["query_img"], vb["support_imgs"], smask,
                               out_size=tuple(vb["query_mask"].shape[-2:]), r_threshold=0.25)
            inter, union = Evaluator.classify_prediction(
                out.mask.astype(np.int64), vb["query_mask"], vb.get("query_ignore_idx"))
            meter.update(inter, union, vb["class_id"])
            if i < args.validation_image_grids:
                # log_validation's grids (`train_icl_*_v3.py:173-326`):
                # [supports | query+gt | query+pred] per episode
                strip = episode_strip(vb["support_imgs"][0], vb["support_masks"][0],
                                      vb["query_img"][0], vb["query_mask"][0],
                                      out.mask[0].astype(np.uint8))
                os.makedirs(grid_dir, exist_ok=True)
                Image.fromarray(strip).save(os.path.join(grid_dir, f"step-{step}_ep-{i}.jpg"))
                log_image(f"validation/ep{i}", strip, step)
        miou, fb_iou, _ = meter.compute_iou()
        line = (f"step {step}: val mIoU {miou:.2f} FB-IoU {fb_iou:.2f} "
                f"({args.validation_episodes} eps)")
        print(line)
        with open(os.path.join(args.output_dir, "eval_results.txt"), "a") as f:
            f.write(line + "\n")
        log_scalar("val_miou", miou, step)
        return miou

    def save_ckpt(step, background):
        """Checkpoint the state; in LoRA mode `unet/` / `unet_ema/` get the
        merged model (reference layout), merged on the host from the f32
        base, and the raw adapters ride in `train_state.pt`.  Every rank
        calls it (under FSDP the snapshot gathers the shards); rank 0
        alone writes."""
        if not is_main and layout is None:
            return None
        kw = {"layout": layout, "write": is_main}
        if args.lora_rank > 0:
            adapters = tck.host_snapshot(state.params)
            with torch.no_grad():
                kw["params_override"] = lora_lib.merge_lora(
                    base_host, lora_lib.unflatten(adapters), lora_scale)
            kw["extra_aux"] = {"lora": adapters}
            if state.ema is not None:
                ema_adapters = tck.host_snapshot(state.ema.params)
                with torch.no_grad():
                    kw["ema_override"] = lora_lib.merge_lora(
                        base_host, lora_lib.unflatten(ema_adapters), lora_scale)
                kw["extra_aux"]["lora_ema"] = ema_adapters
        stats = {"step": step, "background": background}
        if is_main:
            report["saves"].append(stats)
        return tck.save_checkpoint(args.output_dir, step, state, unet_cfg,
                                   args.checkpoints_total_limit, background=background,
                                   stats=stats, **kw)

    lh = args.resolution // 2 ** (len(bundle.vae_cfg.block_out_channels) - 1)
    n_img = args.train_batch_size * (2 + args.nshot * (1 if args.attn_mask_variant else 2))
    noise_shape = (args.gradient_accumulation_steps, n_img, lh, lh,
                   bundle.vae_cfg.latent_channels)

    if is_main:
        os.makedirs(args.output_dir, exist_ok=True)
    preempt, restore_signals = _install_preemption_handler()
    t0 = time.time()
    last_logged_step, last_logged_t = global_step, t0
    profiler = None
    preempted = False
    # a resumed step already has its checkpoint on disk, but only counts as
    # saved when it lives in this output_dir (resuming a foreign checkpoint
    # with no further steps must still write one here); -1 = nothing saved
    last_saved_step = global_step if global_step and resumed_in_output_dir else -1
    # a signal can straddle a step boundary between ranks: they agree on the
    # stop step, or one rank would enter the final save's gathers while
    # another runs the next step
    vote = mesh_lib.StopVote(data_group, device) if mesh is not None else None
    while global_step < args.max_train_steps:
        if is_main and args.profile_step and global_step + 1 == args.profile_step:
            # steps [profile_step, profile_step + profile_num_steps) land in
            # the trace
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        micro = []
        for j in range(args.gradient_accumulation_steps):
            mi = global_step * args.gradient_accumulation_steps + j
            shot_rng = random.Random(_mix(base_seed, host_idx, mi, 1))
            micro.append(_episode_to_streams(next(next(robin)), shot_rng, args.nshot))
        host_batch = {k: np.stack([mb[i] for mb in micro])
                      for i, k in enumerate(("query", "q_mask3", "supports", "s_mask3",
                                             "shot_mask"))}
        # this rank's rows of its node's batch (the whole batch alone)
        batch = {k: to_device(torch.from_numpy(np.ascontiguousarray(v)), device)
                 for k, v in mesh_lib.put_global_batch(host_batch, mesh).items()}
        # counter-keyed (not a sequential chain): resume-invariant; drawn for
        # the global batch, of which this rank takes its rows' images
        noise = step_noise(base_seed, global_step, noise_shape)
        if mesh is not None:
            noise = _rank_noise(noise, args.train_batch_size, args.nshot, my_rows,
                                args.attn_mask_variant)
        noise = to_device(noise, device)
        if args.lora_rank > 0:
            state, metrics = step_fn(state, batch, noise, base_c, vae, text_embed)
        else:
            state, metrics = step_fn(state, batch, noise, vae, text_embed)
        global_step += 1

        if profiler is not None and \
                global_step >= args.profile_step + args.profile_num_steps - 1:
            float(metrics["loss"])  # the steps' end on the device
            profiler.stop()
            prof_dir = os.path.join(args.output_dir, "profile")
            os.makedirs(prof_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(
                prof_dir, f"trace_steps_{args.profile_step}-{global_step}.json"))
            profiler = None
            print(f"profiler trace through step {global_step} written to {prof_dir}")

        if (global_step % args.logging_steps == 0 or global_step == 1) and is_main:
            loss = float(metrics["loss"])
            now = time.time()
            rate = global_step / (now - t0)
            # windowed rate: steps since the previous log over the wall since
            # it (the cumulative rate hides checkpoint and resume stalls)
            win_rate = ((global_step - last_logged_step) / (now - last_logged_t)
                        if now > last_logged_t else rate)
            last_logged_step, last_logged_t = global_step, now
            report["log"].append({"step": global_step, "loss": loss, "wall_s": now - t0})
            print(f"step {global_step}/{args.max_train_steps} "
                  f"loss {loss:.5f} ({rate:.2f} opt-steps/s)")
            log_scalar("train_loss", loss, global_step)
            nf = int(metrics.get("total_notfinite", 0))
            if args.metrics_jsonl:
                with open(args.metrics_jsonl, "a") as fh:
                    fh.write(json.dumps({
                        "step": global_step, "loss": round(loss, 6),
                        "steps_per_s": round(win_rate, 4), "wall_s": round(now - t0, 2),
                        "total_notfinite": nf}) + "\n")
            if nf:
                # apply_if_finite skips silently; show the skipped steps so a
                # diverging run is diagnosed from the log
                print(f"  [containment] {nf} nonfinite step(s) skipped so far "
                      f"({int(metrics['notfinite_count'])} consecutive)")
                log_scalar("nonfinite_steps", nf, global_step)

        if args.validation_steps and global_step % args.validation_steps == 0:
            # the weights are gathered on every rank (FSDP); rank 0 validates
            vparams = merged_unet_params(state)
            if is_main:
                run_validation(vparams, global_step)
            del vparams

        if global_step % args.checkpointing_steps == 0:
            # the snapshot is taken now; the disk write overlaps the next steps
            handle = save_ckpt(global_step, background=True)
            last_saved_step = global_step
            if is_main:
                print(f"saving {handle.ckpt_dir} (background)")

        stop = preempt.is_set() if vote is None else vote(preempt.is_set())
        if stop:
            preempted = True
            break

    restore_signals()
    if profiler is not None:  # the loop ended inside the profiled window
        profiler.stop()
    tck.wait_for_pending_saves()
    if global_step != last_saved_step:
        # skip the final save when the cadence already wrote this step; the
        # same path writes the preemption checkpoint
        save_ckpt(global_step, background=False)
    if writer:
        writer.close()
    if owns_group:
        torch.distributed.destroy_process_group()
    report["global_step"] = global_step
    report["preempted"] = preempted
    if preempted and is_main:
        print(f"training preempted at step {global_step}/{args.max_train_steps}"
              f" — checkpoint-{global_step} written; resume with "
              "--resume_from_checkpoint latest", flush=True)
    if preempted:
        return report
    if is_main:
        print("training done")
    return report


if __name__ == "__main__":
    main()
