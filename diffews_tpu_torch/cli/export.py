"""Export an AOT serving artifact (`torch.export` program + manifest).

    python -m diffews_tpu_torch.cli.export --checkpoint <ckpt> --out <dir> \\
        [--bsz 8] [--nshot 1] [--img-size 512] [--vae_impl xla] \\
        [--unet_ckpt_path <dir>/unet] [--device cpu]

Port of `diffews_tpu/cli/export.py`, with the same flags plus `--device`.
The artifact serves episodes with no model code
(`diffews_tpu_torch.serving.load`); run this ON the serving device (the
program is exported for the device it is traced on: an export on the CUDA
card carries the hand-written kernels as custom-op nodes, one with
`--device cpu` the plain PyTorch path).  Without `--device` it runs on the
card and raises on a host without one.
"""

from __future__ import annotations

import argparse

import torch

from diffews_tpu_torch import serving
from diffews_tpu_torch.pipeline import ATTN_IMPLS, DiffewsPipeline, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--unet_ckpt_path", type=str, default=None,
                   help="fine-tuned UNet dir (like evaluate's flag)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--img-size", type=int, default=512, dest="img_size")
    p.add_argument("--half_precision", action="store_true", default=False,
                   help="export the bf16 program (recommended for serving on "
                        "the card); default f32, matching evaluate's flag")
    p.add_argument("--attn_impl", type=str, default="auto", choices=sorted(ATTN_IMPLS))
    p.add_argument("--vae_impl", type=str, default="xla",
                   choices=["xla", "fused", "mixed", "auto", "int8"],
                   help="'int8': the VAE's 3x3 convs W8A8 (static scales "
                        "calibrated before export; on the card the int8 "
                        "kernels are custom-op nodes of the program)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to export on (default: the CUDA card, "
                        "which must be present; 'cpu' exports the plain path)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    pipe = DiffewsPipeline.from_pretrained(
        args.checkpoint,
        unet_dir=args.unet_ckpt_path,
        device=resolve_device(args.device),
        compute_dtype=torch.bfloat16 if args.half_precision else torch.float32,
        attn_impl=ATTN_IMPLS[args.attn_impl],
        vae_impl=args.vae_impl,
    )
    out = serving.save_serving_artifact(
        pipe, args.out, bsz=args.bsz, nshot=args.nshot,
        img_size=args.img_size)
    print(f"serving artifact written to {out} "
          f"(bsz {args.bsz}, {args.nshot}-shot, {args.img_size}px, "
          f"{pipe.device.type})")
    return out


if __name__ == "__main__":
    main()
