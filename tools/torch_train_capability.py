"""Train-to-capability check of the port: its training learns the task.

The port's counterpart of `tools/train_capability.py`, run through the
port's CLIs only (`diffews_tpu_torch.cli.evaluate`,
`diffews_tpu_torch.cli.train`) on one device:

  1. synthesise a learnable miniature COCO-20i
     (`tests/helpers/synthetic_data.make_coco`): `--task visible`
     (`correlated=True`: the object is brighter than the background, so
     held-out-fold episodes are solvable from the query alone),
     `incontext` (two coloured rectangles; which one is the object is
     known only from the support, so a query-only model caps near 50
     mIoU) or `incontext_nshot` (half the images are ambiguous supports,
     so extra shots disambiguate: trained with random 1..`--nshot` shot
     subsets, and the trained checkpoint evaluated at each shot count of
     `--shot_curve`);
  2. pretrain the tiny VAE in plain torch to autoencode (the recipe of
     `train_capability.py:51-129`: Adam, reconstruction MSE of the mean
     latent's decode plus 0.05·mean(exp(logvar)), on dataset images and
     random mask images) and measure its mask round-trip IoU, the ceiling
     of any eval mIoU;
  3. write a tiny checkpoint with the port's savers (seeded random UNet,
     the pretrained VAE, a tiny text tower, the DiffewS scheduler);
  4. evaluate the random-init UNet with the seeded eval protocol;
  5. train it with the train CLI (f32, gas 1, validation at mid-run;
     `--attn_mask_variant` trains and evaluates the attn-mask
     conditioning);
  6. evaluate the trained checkpoint with the same protocol (and at each
     shot count of the curve);
  7. write the report as JSON and print it as one line.

The pass rule (`--check`, as `tests/test_training.py::
test_training_improves_miou`): mask round-trip IoU > 0.8, trained mIoU at
least twice the random-init one and at least 10 points above it, the loss
falling, two mid-run validations.  Imports torch and the port only.

    python tools/torch_train_capability.py [--device cpu] [--steps 400]
        [--vae_steps 600] [--episodes 60] [--out report.json] [--check]
        [--task visible|incontext|incontext_nshot] [--nshot 3]
        [--shot_curve 1,2,3,5] [--curve_episodes 200] [--attn_mask_variant]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pretrain_vae(vcfg, data_dir, img_size, steps, lr, seed, device, log_every=100):
    """The tiny VAE trained to a near-deterministic autoencoder on dataset
    images and random binary mask images (the two input families the
    frozen VAE round-trips in training and eval).  Returns (module,
    recon_mse, mask_roundtrip_iou)."""
    import torch
    from PIL import Image

    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.utils.init import build_module

    rng = np.random.default_rng(seed)
    paths = sorted(glob.glob(os.path.join(data_dir, "COCO2014", "train2014", "*.jpg")))
    imgs = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (img_size, img_size), Image.BILINEAR), np.float32) / 127.5 - 1.0
        for p in paths[:256]])

    def rand_mask3(n):
        out = np.full((n, img_size, img_size, 3), -1.0, np.float32)
        for i in range(n):
            r0, c0 = rng.integers(0, img_size // 2, 2)
            r1 = rng.integers(r0 + img_size // 4, img_size + 1)
            c1 = rng.integers(c0 + img_size // 4, img_size + 1)
            out[i, r0:r1, c0:c1] = 1.0
        return out

    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    vae = build_module(AutoencoderKL, vcfg, seed=seed, device=device).to(memory_format=fmt)
    opt = torch.optim.Adam(vae.parameters(), lr=lr)
    lc = vcfg.latent_channels
    # dense attention: the pretraining is set-up, not the path under test
    put = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    for step in range(steps):
        idx = rng.integers(0, len(imgs), 4)
        batch = put(np.concatenate([imgs[idx], rand_mask3(4)]))
        mom = vae.encode_moments(batch, attn_impl="dense")
        mean, logvar = mom[..., :lc], mom[..., lc:]
        rec = vae.decode(mean * vcfg.scaling_factor, attn_impl="dense")
        recon_t = (rec - batch).square().mean()
        loss = recon_t + 0.05 * logvar.exp().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (step + 1) % log_every == 0:
            print(f"[vae-pretrain] step {step + 1}/{steps} recon_mse {recon_t.item():.5f}",
                  flush=True)
    recon = recon_t.item()
    vae.requires_grad_(False)
    test_m = rand_mask3(16)
    with torch.no_grad():
        rec = vae.decode(vae.encode_mean_latent(put(test_m), attn_impl="dense"),
                         attn_impl="dense").cpu().numpy()
    pred, gt = rec.mean(-1) > 0.0, test_m.mean(-1) > 0.0
    iou = np.logical_and(pred, gt).sum() / max(np.logical_or(pred, gt).sum(), 1)
    return vae, recon, float(iou)


def build_checkpoint(ck_dir, vae, seed):
    """A tiny diffusers-layout checkpoint written by the port's savers."""
    from diffews_tpu_torch import checkpoint as C
    from diffews_tpu_torch.configs import CLIPTextConfig, SchedulerConfig, UNetConfig
    from diffews_tpu_torch.models.clip_text import CLIPTextModel
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.utils.init import build_module

    ucfg, tcfg = UNetConfig.tiny(), CLIPTextConfig.tiny()
    C.save_unet(build_module(UNet2DConditionModel, ucfg, seed=seed), ucfg,
                os.path.join(ck_dir, "unet"))
    C.save_vae(vae, vae.cfg, os.path.join(ck_dir, "vae"))
    text = build_module(CLIPTextModel, tcfg, seed=seed + 2)
    text_dir = os.path.join(ck_dir, "text_encoder")
    C.save_torch_weights({"text_model." + k: v for k, v in text.state_dict().items()},
                         text_dir, C.TEXT_SAFETENSORS)
    with open(os.path.join(text_dir, "config.json"), "w") as f:
        json.dump({"vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
                   "intermediate_size": tcfg.intermediate_size,
                   "num_hidden_layers": tcfg.num_hidden_layers,
                   "num_attention_heads": tcfg.num_attention_heads}, f)
    os.makedirs(os.path.join(ck_dir, "scheduler"), exist_ok=True)
    with open(os.path.join(ck_dir, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(SchedulerConfig.diffews().to_diffusers_dict(), f)


def run_eval(ck_dir, data_dir, img_size, episodes, log_root, device, nshot,
             unet_ckpt_path=None, attn_mask_variant=False):
    """The seeded eval protocol through the port's eval CLI."""
    from diffews_tpu_torch.cli.evaluate import main as eval_main

    argv = (["--attn_mask_variant"] if attn_mask_variant else []) + [
            "--checkpoint", ck_dir, "--datapath", data_dir, "--benchmark", "coco",
            "--fold", "0", "--nshot", str(nshot), "--img-size", str(img_size),
            "--denoise_steps", "1", "--ensemble_size", "1", "--threshold", "0",
            "--r_threshold", "0.25", "--max_episodes", str(episodes),
            "--log-root", log_root, "--device", device]
    if unet_ckpt_path:
        argv += ["--unet_ckpt_path", unet_ckpt_path]
    miou, fb_iou = eval_main(argv)
    return float(miou), float(fb_iou)


def check(report: dict) -> list:
    """The failed conditions of the pass rule (empty when it holds)."""
    bad = []
    if not report["vae_pretrain"]["mask_roundtrip_iou"] > 0.8:
        bad.append("mask round-trip IoU <= 0.8")
    if not report["miou_trained"] >= 2 * report["miou_random_init"]:
        bad.append("trained mIoU < 2x random-init")
    if not report["miou_trained"] - report["miou_random_init"] >= 10.0:
        bad.append("gain < 10 points")
    if not (report["loss_last"] is not None and report["loss_last"] < report["loss_first"]):
        bad.append("the loss did not fall")
    if len(report["mid_run_validation"]) < 2:
        bad.append("fewer than two mid-run validations")
    return bad


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=None, help="default: a fresh temporary directory")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--vae_steps", type=int, default=600)
    p.add_argument("--episodes", type=int, default=60,
                   help="eval episodes for the before/after comparison")
    p.add_argument("--validation_episodes", type=int, default=16)
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--vae_lr", type=float, default=2e-3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--nshot", type=int, default=1,
                   help="max shots in training (random 1..n subsets a step); "
                        "3 with --task incontext_nshot")
    p.add_argument("--task", choices=["visible", "incontext", "incontext_nshot"],
                   default="visible")
    p.add_argument("--shot_curve", default="",
                   help="comma list of shot counts to evaluate the trained "
                        "checkpoint at (default 1,2,3,5 for incontext_nshot)")
    p.add_argument("--curve_episodes", type=int, default=200,
                   help="eval episodes per shot-curve point")
    p.add_argument("--attn_mask_variant", action="store_true",
                   help="train and evaluate with the attn-mask conditioning")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, which must be present)")
    p.add_argument("--out", default=None, help="write the report here too")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero unless the pass rule holds")
    args = p.parse_args(argv)

    import torch

    from diffews_tpu_torch.cli.train import main as train_main
    from diffews_tpu_torch.configs import VAEConfig
    from diffews_tpu_torch.pipeline import resolve_device
    from helpers.synthetic_data import make_coco

    device = resolve_device(args.device)
    t0 = time.time()
    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_train_capability_")
    data_dir, ck_dir = os.path.join(workdir, "data"), os.path.join(workdir, "ckpt")
    out_dir = os.path.join(workdir, "train")
    metrics_jsonl = os.path.join(workdir, "train_metrics.jsonl")

    print(f"[1/6] synthesizing correlated COCO-20i (task={args.task})", flush=True)
    make_coco(data_dir,
              correlated=args.task if args.task.startswith("incontext") else True,
              imgs_per_class=6 if args.task == "incontext_nshot" else 3, seed=args.seed)
    print("[2/6] pretraining the tiny VAE", flush=True)
    t1 = time.time()
    vae, recon, ceiling = pretrain_vae(VAEConfig.tiny(), data_dir, args.img_size,
                                       args.vae_steps, args.vae_lr, args.seed, device)
    vae_s = time.time() - t1
    print(f"[2/6] recon_mse {recon:.5f}, mask round-trip IoU {ceiling:.3f}", flush=True)
    print("[3/6] writing the tiny checkpoint", flush=True)
    build_checkpoint(ck_dir, vae.cpu(), args.seed)
    del vae
    print("[4/6] eval of the random-init UNet", flush=True)
    t1 = time.time()
    miou_random, fb_random = run_eval(ck_dir, data_dir, args.img_size, args.episodes,
                                      os.path.join(workdir, "eval_random"), str(device),
                                      args.nshot, attn_mask_variant=args.attn_mask_variant)
    eval_s = time.time() - t1
    print(f"[5/6] training {args.steps} steps through the train CLI", flush=True)
    t1 = time.time()
    train = train_main([
        "--pretrained_model_name_or_path", ck_dir, "--datapath", data_dir,
        "--benchmark", "coco", "--fold", "0", "--nshot", str(args.nshot),
        "--resolution", str(args.img_size), "--train_batch_size", str(args.batch_size),
        "--gradient_accumulation_steps", "1", "--max_train_steps", str(args.steps),
        "--learning_rate", str(args.lr), "--lr_warmup_steps", "0",
        "--mixed_precision", "no", "--seed", str(args.seed), "--output_dir", out_dir,
        "--checkpointing_steps", str(args.steps), "--logging_steps", "25",
        "--metrics_jsonl", metrics_jsonl,
        "--validation_steps", str(max(args.steps // 2, 1)),
        "--validation_episodes", str(args.validation_episodes),
        "--validation_image_grids", "2", "--dataloader_num_workers", "0",
        "--device", str(device)] + (["--attn_mask_variant"] if args.attn_mask_variant else []))
    train_s = time.time() - t1
    trained_unet = os.path.join(out_dir, f"checkpoint-{args.steps}", "unet")
    print("[6/6] eval of the trained UNet", flush=True)
    miou_trained, fb_trained = run_eval(ck_dir, data_dir, args.img_size, args.episodes,
                                        os.path.join(workdir, "eval_trained"), str(device),
                                        args.nshot, unet_ckpt_path=trained_unet,
                                        attn_mask_variant=args.attn_mask_variant)
    curve_spec = args.shot_curve or ("1,2,3,5" if args.task == "incontext_nshot" else "")
    shot_curve = {}
    for k in [int(c) for c in curve_spec.split(",") if c.strip()]:
        mi_k, fb_k = run_eval(ck_dir, data_dir, args.img_size, args.curve_episodes,
                              os.path.join(workdir, f"eval_shots{k}"), str(device), k,
                              unet_ckpt_path=trained_unet,
                              attn_mask_variant=args.attn_mask_variant)
        shot_curve[str(k)] = {"miou": mi_k, "fb_iou": fb_k}
        print(f"[curve] {k}-shot mIoU {mi_k:.2f} FB-IoU {fb_k:.2f} "
              f"({args.curve_episodes} episodes)", flush=True)
    with open(os.path.join(out_dir, "eval_results.txt")) as fh:
        val_lines = [ln.strip() for ln in fh if ln.strip()]
    losses = [r["loss"] for r in train["log"]]
    report = {
        "task": f"{args.task} synthetic COCO-20i fold0, held-out classes, {args.img_size}px, "
                f"{args.nshot}-shot, seeded protocol",
        "device": str(device),
        "card": torch.cuda.get_device_name(0) if device.type == "cuda" else None,
        "steps": args.steps, "lr": args.lr, "batch_size": args.batch_size,
        "nshot_train": args.nshot, "attn_mask_variant": args.attn_mask_variant,
        "shot_curve": shot_curve or None,
        "curve_episodes": args.curve_episodes if shot_curve else None,
        "vae_pretrain": {"steps": args.vae_steps, "recon_mse": recon,
                         "mask_roundtrip_iou": ceiling, "seconds": vae_s},
        "episodes": args.episodes,
        "miou_random_init": miou_random, "miou_trained": miou_trained,
        "fb_iou_random_init": fb_random, "fb_iou_trained": fb_trained,
        "improvement_x": miou_trained / max(miou_random, 1e-6),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "mid_run_validation": val_lines,
        "eval_s": eval_s, "train_s": train_s, "wall_s": time.time() - t0,
        "workdir": workdir,
    }
    report["failed"] = check(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    if args.check and report["failed"]:
        raise SystemExit(f"capability rule failed: {report['failed']}")
    return report


if __name__ == "__main__":
    main()
