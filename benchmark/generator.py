"""The one traffic generator: turns a traffic file's parameters and `--seed`
into the inputs a run sends, made on the device in a few large draws and
handed to the program as host arrays, as users hand them over.

Images are smooth colour fields (a coarse normal grid, bilinearly
upsampled) with fine noise, as uint8; masks are the positive part of
another coarse field, as {0, 1} uint8, so every mask has foreground and
background.  Every seed gives the same sizes, so the work per batch never
depends on the seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _images(gen, n: int, size: int, device) -> torch.Tensor:
    coarse = torch.randn((n, 3, 8, 8), generator=gen, device=device)
    x = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    x = x * 0.5 + 0.1 * torch.randn((n, 3, size, size), generator=gen, device=device)
    return ((x.clamp(-1.0, 1.0) * 0.5 + 0.5) * 255.0).to(torch.uint8).permute(0, 2, 3, 1)


def _masks(gen, n: int, size: int, device) -> torch.Tensor:
    coarse = torch.randn((n, 1, 6, 6), generator=gen, device=device)
    x = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)[:, 0]
    return (x > 0).to(torch.uint8)


class Draws:
    """The run's draws, in the order a kind asks for them: all from one
    `torch.Generator` on the device, seeded from `--seed`."""

    def __init__(self, seed: int, size: int, device):
        self.size, self.device = size, torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed((int(seed) * 2 + 1) % (2 ** 63))

    def images(self, *lead) -> np.ndarray:
        """uint8 images (*lead, H, W, 3)."""
        n, s = int(np.prod(lead)), self.size
        return _images(self.gen, n, s, self.device).reshape(*lead, s, s, 3).cpu().numpy()

    def masks(self, *lead) -> np.ndarray:
        """{0, 1} uint8 masks (*lead, H, W)."""
        n, s = int(np.prod(lead)), self.size
        return _masks(self.gen, n, s, self.device).reshape(*lead, s, s).cpu().numpy()

    def normal(self, *shape) -> np.ndarray:
        """float32 standard normal draws."""
        return torch.randn(shape, generator=self.gen, device=self.device).cpu().numpy()


def episodes(d: Draws, traffic: dict) -> dict:
    """`pool` batches of {"query": (B, H, W, 3), "supports": (B, N, H, W, 3),
    "masks": (B, N, H, W)} uint8."""
    b, n, pool = traffic["batch"], traffic["shots"], traffic["pool"]
    q = d.images(pool, b)
    s, m = d.images(pool, b, n), d.masks(pool, b, n)
    return {"batches": [{"query": q[i], "supports": s[i], "masks": m[i]} for i in range(pool)]}


def make(traffic: dict, seed: int, size: int, device, latent=(8, 4), root=None) -> dict:
    """The run's inputs as numpy arrays, drawn by the traffic's kind
    (`benchmark/kinds/<mode>.py`): at least "batches", `pool` batches that
    the window cycles through in order, each {"query": (B, H, W, 3) uint8,
    ...}.  `latent`: the VAE's (downsampling factor, channels), for kinds
    that draw latent noise."""
    from benchmark import kinds

    return kinds.load(traffic["mode"], root).draw(Draws(seed, size, device), traffic, latent)


def as_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
