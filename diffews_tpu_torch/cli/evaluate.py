"""Evaluation harness CLI of the port.

Port of `diffews_tpu/cli/evaluate.py` (itself the counterpart of the
reference's `evaluation_util/main_oss.py`): the same flags, the same
seeded episodic protocol, the same metric math and the same
`_TEST_<benchmark>_<stamp>.log/log.txt` contract; the episode loop drives
the port's `DiffewsPipeline` on the CUDA card.  What differs:

  - `--half_precision` computes in `torch.bfloat16`;
  - `--device` (default: the CUDA card, raising on a host without one;
    `cpu` runs the kernels' plain versions) takes the place of the JAX
    package's platform hook;
  - `--attn_impl` auto / xla / pallas map onto the pipeline's auto /
    dense / flash;
  - multi-device runs go one process per device under `torchrun`
    (`torchrun --nproc_per_node N -m diffews_tpu_torch.cli.evaluate
    --num_data_shards D --num_shot_shards S ...` with N = D·S): every
    rank runs the same seeded protocol with a ("data",) mesh or a
    ("shots",) / ("data", "shots") shot mesh (`pipeline.py`), and rank 0
    alone logs and writes; the checks are the JAX CLI's
    (`cli/evaluate.py:132-154`);
  - `--vae_impl int8` and `--unet_int8` raise (ROADMAP A12, in the
    pipeline).

Usage (mirrors `scripts/eval_coco2014_rthres_1shot_nosample.sh`):

    python -m diffews_tpu_torch.cli.evaluate \\
        --checkpoint weight/stable-diffusion-2-1-ref8inchannels-tag4inchannels \\
        --unet_ckpt_path $MODEL_DIR/unet \\
        --scheduler_load_path ./scheduler_1.0_1.0 \\
        --datapath FSSBench --benchmark coco --fold 0 --nshot 1 \\
        --img-size 512 --denoise_steps 1 --ensemble_size 1 \\
        --threshold 0 --r_threshold 0.25 --half_precision --log-root ./logs/eval
"""

from __future__ import annotations

import argparse
import random
import time

import numpy as np
import torch

from diffews_tpu_torch.data.dataset import FSSDataset
from diffews_tpu_torch.evaluation import AverageMeter, Evaluator
from diffews_tpu_torch.evaluation.meter import EvalLogger
from diffews_tpu_torch.evaluation.vis import Visualizer
from diffews_tpu_torch.parallel import mesh as mesh_lib
from diffews_tpu_torch.pipeline import ATTN_IMPLS, DiffewsPipeline, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DiffewS one-shot segmentation evaluation (PyTorch port)")
    # dataset
    p.add_argument("--datapath", type=str, default="datasets")
    p.add_argument("--benchmark", type=str, default="coco",
                   choices=["fss", "coco", "pascal", "lvis", "paco_part",
                            "pascal_part", "pascal_cd"])
    p.add_argument("--bsz", type=int, default=1)
    p.add_argument("--nworker", type=int, default=0)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--img-size", dest="img_size", type=int, default=518)
    p.add_argument("--use_original_imgsize", action="store_true")
    p.add_argument("--log-root", dest="log_root", type=str, default="output/debug")
    p.add_argument("--visualize", type=int, default=0)
    p.add_argument("--vis_path", type=str, default="output/debug/vis")
    # diffusion
    p.add_argument("--checkpoint", type=str, required=True,
                   help="diffusers-layout base checkpoint directory")
    p.add_argument("--scheduler_load_path", type=str, default=None)
    p.add_argument("--unet_ckpt_path", type=str, default=None)
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--threshold", type=float, default=0.1)
    p.add_argument("--r_threshold", type=float, default=0.0)
    p.add_argument("--half_precision", action="store_true",
                   help="bfloat16 compute")
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--test_timestep", type=int, default=1)
    p.add_argument("--attn_impl", type=str, default="auto", choices=sorted(ATTN_IMPLS),
                   help="auto / pallas: the CUDA flash kernel on the card (its plain "
                        "version on the CPU); xla: dense attention")
    p.add_argument("--attn_mask_variant", action="store_true",
                   help="evaluate with the experimental attn-mask "
                        "conditioning (support masks as attention key "
                        "biases, `unet_2d_condition_attn.py`); the "
                        "checkpoint must have been trained with "
                        "`cli/train.py --attn_mask_variant`")
    p.add_argument("--max_episodes", type=int, default=0,
                   help="cap episode count (0 = full protocol)")
    p.add_argument("--dispatch_ahead", type=int, default=2,
                   help="episodes kept in flight on the device; host metric "
                        "work overlaps device compute (1 = synchronous)")
    p.add_argument("--mask_on_device", action="store_true",
                   help="compute the threshold rule on the device and transfer "
                        "only the bool mask (pipeline.device_mask_from_seg, "
                        "bit for bit the host formula)")
    p.add_argument("--num_shot_shards", type=int, default=1,
                   help="shard each episode's support shots over this many "
                        "devices (one torchrun rank each)")
    p.add_argument("--num_data_shards", type=int, default=1,
                   help="shard the episode batch over this many devices (one "
                        "torchrun rank each)")
    p.add_argument("--encode_chunks", type=int, default=0,
                   help="run the batched VAE encode in N chunks: same "
                        "numerics. 0 = auto: chunk only past 48 encoded "
                        "images")
    p.add_argument("--vae_impl", type=str, default="xla",
                   choices=["xla", "fused", "mixed", "auto", "int8"],
                   help="VAE resnet implementation. Default 'xla' (GroupNorm "
                        "kernels + cuDNN convs) keeps metrics independent of "
                        "--bsz; 'fused' / 'mixed' / 'auto' opt into the fused "
                        "conv kernel (batch-dependent rounding); 'int8' is not "
                        "ported (ROADMAP A12)")
    p.add_argument("--unet_int8", action="store_true",
                   help="W8A8 UNet linears; not ported (ROADMAP A12)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, which must be "
                        "present; 'cpu' runs the kernels' plain versions)")
    return p


def evaluate(args, pipe=None, raw_images: bool = True) -> tuple[float, float]:
    """Run the seeded eval protocol.  `pipe` injects a prebuilt
    `DiffewsPipeline` (tools use random-init full-size models without a
    checkpoint on disk); default builds one from `args.checkpoint` like the
    reference harness (`main_oss.py:338-372`) on `args.device`.
    `raw_images=False` feeds host-normalized float episodes (numerically
    identical; ~8x more host-to-device bytes)."""
    # no card and no --device cpu: raise before anything is loaded
    device = resolve_device(args.device) if pipe is None else None
    mesh = shot_mesh = None
    owns_group = not torch.distributed.is_initialized()
    if pipe is None and (args.num_data_shards > 1 or args.num_shot_shards > 1
                         or mesh_lib.launched()):
        mesh, shot_mesh = _meshes(args, device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    is_main = mesh_lib.rank() == 0

    # Seeded protocol (main_oss.py:33-36): global RNGs pinned before episode
    # sampling.
    random.seed(0)
    np.random.seed(0)

    if is_main:
        EvalLogger.initialize(args, root=args.log_root, benchmark=args.benchmark)
    Visualizer.initialize(bool(args.visualize) and is_main, args.vis_path)

    if pipe is None:
        pipe = DiffewsPipeline.from_pretrained(
            args.checkpoint,
            unet_dir=args.unet_ckpt_path,
            scheduler_dir=args.scheduler_load_path,
            device=device,
            compute_dtype=torch.bfloat16 if args.half_precision else torch.float32,
            attn_impl=ATTN_IMPLS[args.attn_impl],
            test_timestep=args.test_timestep,
            encode_chunks=args.encode_chunks,
            vae_impl=args.vae_impl,
            unet_int8=args.unet_int8,
            attn_mask_variant=args.attn_mask_variant,
            mesh=mesh,
            shot_mesh=shot_mesh,
        )

    # raw_images: episodes stay uint8 HWC on the host; the pipeline
    # normalizes on the device (identical arithmetic, ~8x smaller upload)
    FSSDataset.initialize(args.img_size, args.datapath, args.use_original_imgsize,
                          raw_images=raw_images)
    loader = FSSDataset.build_dataloader(
        args.benchmark, args.bsz, args.nworker, args.fold, "test", args.nshot
    )
    meter = AverageMeter(loader.dataset.benchmark, loader.dataset.class_ids)

    n_total = len(loader)
    t0 = time.time()
    n_done = 0
    depth = max(1, args.dispatch_ahead)
    in_flight: list = []  # [(idx, batch, PendingSeg)]

    def drain_one():
        nonlocal n_done
        idx, batch, pending = in_flight.pop(0)
        # need_seg=False: scoring and visualization only use the mask; the
        # host-threshold path still copies the seg (it computes the mask
        # from it), the --mask_on_device path copies the mask alone.
        # `result()` is the loop's one synchronisation with the device.
        pred = pending.result(need_seg=False).mask.astype(np.int64)
        inter, union = Evaluator.classify_prediction(
            pred, batch["query_mask"], batch.get("query_ignore_idx")
        )
        meter.update(inter, union, batch["class_id"])
        meter.write_process(idx, n_total, epoch=-1, write_batch_idx=50)
        n_done += pred.shape[0]
        if Visualizer.visualize:
            iou = inter[1] / np.maximum(union[1], 1)
            Visualizer.visualize_prediction_batch(
                batch["support_imgs"], batch["support_masks"], batch["query_img"],
                batch["query_mask"], pred, batch["class_id"], idx, iou,
            )

    for idx, batch in enumerate(loader):
        if args.max_episodes and idx >= args.max_episodes:
            break
        # support masks stay (B,N,H,W) {0,1} uint8; the 3-channel [-1,1]
        # folding (main_oss.py:100-104) happens on the device.
        if raw_images:
            smask = batch["support_masks"].astype(np.uint8)
        else:
            smask = (np.repeat(batch["support_masks"][:, :, None], 3, axis=2)
                     * 2.0 - 1.0)

        # Dispatch ahead: the device computes episode i while the host scores
        # episode i-1 (CUDA launches are asynchronous; numerics unchanged).
        in_flight.append((idx, batch, pipe.predict_async(
            batch["query_img"],
            batch["support_imgs"],
            smask,
            denoising_steps=args.denoise_steps,
            # prediction is compared against query_mask: same-size resize is a
            # no-op in the standard protocol; with --use_original_imgsize the
            # gt keeps its native size and the prediction must match it
            out_size=tuple(np.asarray(batch["query_mask"]).shape[-2:]),
            r_threshold=args.r_threshold,
            threshold=args.threshold if args.r_threshold <= 0 else 0.0,
            mask_on_device=args.mask_on_device,
        )))
        if len(in_flight) >= depth:
            drain_one()
    while in_flight:
        drain_one()

    dt = time.time() - t0
    miou, fb_iou = meter.write_result("Test", 0)
    EvalLogger.info(f"throughput: {n_done / dt:.3f} episodes/s ({n_done} in {dt:.1f}s)")
    EvalLogger.info("mIoU: %5.2f \t FB-IoU: %5.2f" % (miou, fb_iou))
    if owns_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return miou, fb_iou


def _meshes(args, device_type: str):
    """The run's (mesh, shot_mesh) under torchrun, with the JAX CLI's
    checks: "data" divides --bsz, "shots" divides --nshot, and the world
    has as many ranks as the shard counts' product."""
    if not mesh_lib.launched():
        raise RuntimeError(
            f"--num_data_shards {args.num_data_shards} / --num_shot_shards "
            f"{args.num_shot_shards}: launch one process per device with torchrun "
            f"--nproc_per_node {args.num_data_shards * args.num_shot_shards} "
            "-m diffews_tpu_torch.cli.evaluate ...")
    if args.bsz % args.num_data_shards:
        raise SystemExit(f"--bsz {args.bsz} must be divisible by "
                         f"--num_data_shards {args.num_data_shards}")
    if args.nshot % args.num_shot_shards:
        raise SystemExit(f"--nshot {args.nshot} must be divisible by "
                         f"--num_shot_shards {args.num_shot_shards}")
    mesh_lib.maybe_initialize_distributed(device_type=device_type)
    if args.num_shot_shards > 1:
        # a 2-D ("data", "shots") mesh when --num_data_shards > 1 too
        return None, mesh_lib.make_shot_mesh(device_type, args.num_shot_shards,
                                             n_data=args.num_data_shards)
    return mesh_lib.make_mesh(device_type, args.num_data_shards), None


def main(argv=None):
    return evaluate(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
