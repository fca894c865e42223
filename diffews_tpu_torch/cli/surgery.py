"""Checkpoint surgery CLI of the port.

Port of `diffews_tpu/cli/surgery.py` (the counterpart of the reference's
`train_tools/load_ckpt_and_modify_ref8in_tag4in.py`): clone a vanilla
diffusers SD checkpoint and attach the 8-channel `conv_in_ref` (conv_in's
weights repeated over the input channels and halved, its bias copied),
producing the `...-ref8inchannels-tag4inchannels` base checkpoint.  Runs on
the host alone (no device), with the port's own safetensors codec.

    python -m diffews_tpu_torch.cli.surgery <src> <dst>
"""

from __future__ import annotations

import argparse

from diffews_tpu_torch.checkpoint import surgery_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser("DiffewS checkpoint surgery (PyTorch port)")
    p.add_argument("src", help="vanilla SD checkpoint dir (e.g. stable-diffusion-2-1)")
    p.add_argument("dst", help="output dir (e.g. ...-ref8inchannels-tag4inchannels)")
    args = p.parse_args(argv)
    surgery_checkpoint(args.src, args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
