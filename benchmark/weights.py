"""The models' weights, made from `--seed` on the device.

The layout (every parameter's diffusers name and shape) comes from a walk
of the reference on the meta device, so it is the published architecture's
and not read from the program.  All values come from one
`torch.Generator` in one large normal draw per model, in the type the
model is served in, then scaled in place per tensor: fan-in scaling for
matrices and kernels, N(0, 0.02) for embeddings, 1 ± 0.1 for norm scales,
small shifts and biases.  The program and the reference get the same
tensors (the reference as float32 copies).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as M


def layouts(cfg: dict) -> dict:
    """{"unet" | "vae" | "text": {name: shape}} in the reference's walk
    order, from a meta-device run at small spatial sizes (no weight
    depends on them)."""
    u, v, t = M.Net(), M.Net(), M.Net()
    uc, vc = cfg["unet"], cfg["vae"]
    M.unet(u, uc, torch.empty((1, uc["in_channels"], 8, 8), device="meta"), 1,
           torch.empty((1, 2, uc["cross_attention_dim"]), device="meta"),
           ref=torch.empty((1, 1, uc["ref_in_channels"], 8, 8), device="meta"))
    z = M.vae_encode_mean(v, vc, torch.empty((1, vc["in_channels"], 64, 64), device="meta"))
    M.vae_decode(v, vc, z)
    M.clip_text(t, cfg["text"], torch.zeros((1, 2), dtype=torch.int64, device="meta"))
    return {"unet": u.layout, "vae": v.layout, "text": t.layout}


def _init(name: str, shape) -> tuple:
    """(std, mean) of a parameter's draw."""
    module = name.rsplit(".", 2)[-2]
    if name.endswith("embedding.weight"):
        return 0.02, 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if "norm" in module:
        return 0.1, (1.0 if name.endswith(".weight") else 0.0)
    return 0.02, 0.0


@torch.no_grad()
def draw(layout: dict, gen: torch.Generator, dtype, device) -> dict:
    """{name: tensor}: views into one normal draw of every element."""
    total = sum(math.prod(s) for s in layout.values())
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out, o = {}, 0
    for name, shape in layout.items():
        n = math.prod(shape)
        std, mean = _init(name, shape)
        t = flat[o:o + n].view(shape).mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        o += n
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """{"unet", "vae", "text": {name: tensor}} from `seed`: the UNet and VAE
    in the compute dtype, the text tower in its own (the program computes
    one embedding with it)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    lay = layouts(cfg)
    dt = getattr(torch, cfg["compute_dtype"])
    return {"unet": draw(lay["unet"], gen, dt, device),
            "vae": draw(lay["vae"], gen, dt, device),
            "text": draw(lay["text"], gen, getattr(torch, cfg["text_dtype"]), device)}


def as_float32(weights: dict) -> dict:
    return {k: {n: t.float() for n, t in w.items()} for k, w in weights.items()}
