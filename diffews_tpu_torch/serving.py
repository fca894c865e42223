"""AOT serving artifacts: the whole episode program as one `torch.export` file.

Port of `diffews_tpu/serving.py`.  `export_predict` exports a
`DiffewsPipeline`'s episode — batched VAE encode, joint KV-fusion UNet,
degenerate DDIM, VAE decode, uint8 quantization — with `torch.export`;
`save_serving_artifact` writes it as `predict.pt2` beside a
`manifest.json`.  The artifact serves episodes without any model code:
`load(path)` returns a callable.

Notes:
- The weights are the program's lifted parameters and buffers (saved in
  the same `.pt2` file), never constants inlined into the graph.
- Shapes are static: one artifact per (bsz, nshot, img_size) serving
  configuration; export several if needed.
- The artifact records the device it was exported on.  An export on the
  card carries the hand-written CUDA kernels as custom-op nodes
  (`torch.ops.diffews_tpu_torch.*`, registered by the ops modules, which
  `load` imports first), and runs them, never their plain versions; a CPU
  export carries the plain PyTorch path, as a JAX CPU export carries the
  dense one.  A card artifact loaded on a host without a card raises.
- Inputs mirror `DiffewsPipeline.predict_async`'s uint8 ingestion: uint8
  query and supports, {0,1} uint8 masks, bool shot mask; the output is
  the uint8 decoded prediction on the device (the threshold stays with
  the caller, as in the eval harness).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from diffews_tpu_torch.utils import to_device

ARTIFACT = "predict.pt2"
MANIFEST = "manifest.json"


class _Episode(torch.nn.Module):
    """The episode `predict_async` runs (`_x0_latent`, one step, then
    `_decode_seg`) as a module whose parameters are the pipeline's UNet and
    VAE and whose buffer is the empty-prompt embedding."""

    def __init__(self, pipe):
        super().__init__()
        self.unet, self.vae = pipe.unet, pipe.vae
        # the pipeline's embedding is an inference tensor; a clone is not
        self.register_buffer("empty_text_embed", pipe.empty_text_embed.clone())
        self._pipe = pipe

    def forward(self, query, supports, masks, shot_mask):
        x0 = self._pipe._x0_latent(query, supports, masks, self.empty_text_embed, shot_mask, 1)
        return self._pipe._decode_seg(x0)


def _specs(bsz: int, nshot: int, s: int) -> dict:
    return {"query": ((bsz, s, s, 3), torch.uint8),
            "supports": ((bsz, nshot, s, s, 3), torch.uint8),
            "masks": ((bsz, nshot, s, s), torch.uint8),
            "shot_mask": ((bsz, nshot), torch.bool)}


def export_predict(pipe, *, bsz: int, nshot: int,
                   img_size: int = 512) -> tuple[torch.export.ExportedProgram, dict]:
    """(exported program, manifest dict) for one configuration, exported on
    the pipeline's device."""
    s = img_size
    example = tuple(torch.zeros(shape, dtype=dtype, device=pipe.device)
                    for shape, dtype in _specs(bsz, nshot, s).values())
    with torch.no_grad():
        program = torch.export.export(_Episode(pipe), example)
    manifest = {
        "bsz": bsz,
        "nshot": nshot,
        "img_size": img_size,
        "denoising_steps": 1,
        "platforms": [pipe.device.type],
        "inputs": {
            "query": f"uint8[{bsz},{s},{s},3] (0..255 RGB)",
            "supports": f"uint8[{bsz},{nshot},{s},{s},3]",
            "masks": f"uint8[{bsz},{nshot},{s},{s}] {{0,1}}",
            "shot_mask": f"bool[{bsz},{nshot}]",
        },
        "output": f"uint8[{bsz},{s},{s},3] decoded prediction "
                  "(threshold host-side)",
        "torch_version": torch.__version__,
    }
    return program, manifest


def save_serving_artifact(pipe, out_dir: str, *, bsz: int, nshot: int,
                          img_size: int = 512) -> str:
    """Write `predict.pt2` + `manifest.json`."""
    program, manifest = export_predict(pipe, bsz=bsz, nshot=nshot, img_size=img_size)
    return write_artifact(program, manifest, out_dir)


def write_artifact(program: torch.export.ExportedProgram, manifest: dict, out_dir: str) -> str:
    """Write an `export_predict` result as `predict.pt2` + `manifest.json`."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class ServingModule:
    """A loaded artifact: `__call__(query, supports, masks, shot_mask)` ->
    the uint8 prediction, a tensor on the artifact's device (the call
    queues the work and returns).  No model code needed: the program and
    its weights both come from the artifact directory."""

    def __init__(self, program: torch.export.ExportedProgram, manifest: dict):
        self.manifest = manifest
        self.device = torch.device(manifest["platforms"][0])
        self._call = program.module()
        m = manifest
        self._specs = _specs(m["bsz"], m["nshot"], m["img_size"])

    def __call__(self, query, supports, masks, shot_mask=None) -> torch.Tensor:
        if shot_mask is None:
            shot_mask = np.ones((self.manifest["bsz"], self.manifest["nshot"]), bool)
        args = []
        for (name, (shape, dtype)), x in zip(self._specs.items(),
                                             (query, supports, masks, shot_mask)):
            t = torch.as_tensor(np.asarray(x))
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: the artifact takes shape {list(shape)}; got "
                                 f"{list(t.shape)}")
            args.append(to_device(t.to(dtype), self.device))
        with torch.inference_mode():
            return self._call(*args)


def load(path: str) -> ServingModule:
    """Load a directory written by `save_serving_artifact`."""
    # the custom ops must be registered before the program is deserialised
    from diffews_tpu_torch.ops import (downsample, flash_attention, fused_resnet,  # noqa: F401
                                       groupnorm, quant)

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["platforms"] == ["cuda"] and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported on a CUDA device and this host has none")
    return ServingModule(torch.export.load(os.path.join(path, ARTIFACT)), manifest)
