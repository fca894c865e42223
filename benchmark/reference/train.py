"""The reference's DiffewS fine-tuning step, float32 throughout.

DiffewS's in-context objective (arXiv 2410.02369): the query RGB, query
mask, support RGB and support mask images go through the frozen VAE as
posterior samples (mean + std·noise, logvar clipped to [-30, 20], times
the scaling factor); the joint UNet predicts at the fixed timestep, and
the loss is the mean squared error against the negative query-mask latent.
The update is clip-by-global-norm, then AdamW (bias-corrected moments,
decoupled weight decay on every leaf) at a polynomially decaying learning
rate.  The loss of a batch is the mean of its episodes' losses, so the
gradient is taken episode by episode and summed, which keeps float32
activations of one episode at a time.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import episode as E
from benchmark.reference import model as M


class TrainReference:
    """Float32 masters, moments and step count of the fine-tuning run."""

    def __init__(self, cfg: dict, trainer: dict, weights: dict, device, low=None):
        """`low`: None, or a dtype every convolution's and linear's
        operands are rounded to (a control computed below the
        configuration's precision)."""
        self.cfg, self.t, self.low = cfg, trainer, low
        self.device = torch.device(device)
        self.params = {n: w.detach().clone().requires_grad_(True)
                       for n, w in weights["unet"].items()}
        self.vae = M.Net(weights["vae"], low=low)
        towers = {k: M.Net(weights[k]) for k in M.TOWERS if k in cfg}
        with torch.no_grad():
            self.context, self.added = M.conditioning(towers, cfg, True, self.device)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def latents(self, batch: dict, noise: torch.Tensor):
        """Posterior samples of the batch's four image streams, NCHW:
        (query, query mask, support (B, N, ...), support mask (B, N, ...)).
        `noise`: (images, h, w, latent) standard normal draws in stream
        order."""
        vc = self.cfg["vae"]
        b, n = batch["supports"].shape[:2]
        imgs = torch.cat([E.image_in(batch["query"]), E.mask_in(batch["q_mask"]),
                          E.image_in(batch["supports"].flatten(0, 1)),
                          E.mask_in(batch["s_mask"].flatten(0, 1))])
        moments = torch.cat([M.vae_moments(self.vae, vc, c) for c in imgs.split(4)])
        mean, logvar = moments.chunk(2, dim=1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        lat = (mean + std * noise.permute(0, 3, 1, 2).float()) * vc["scaling_factor"]
        q, qm = lat[:b], lat[b:2 * b]
        s = lat[2 * b:2 * b + b * n].reshape((b, n) + lat.shape[1:])
        sm = lat[2 * b + b * n:].reshape((b, n) + lat.shape[1:])
        return q, qm, s, sm

    def loss_and_grads(self, batch: dict, noise: torch.Tensor):
        """The batch's loss (a float) and the float32 gradients of the
        masters, episode by episode."""
        q, qm, s, sm = self.latents(batch, noise)
        ref = torch.cat([s, sm], dim=2)
        b = q.shape[0]
        grads = {n: torch.zeros_like(p) for n, p in self.params.items()}
        net = M.Net(self.params, low=self.low)
        total = 0.0
        for i in range(b):
            pred = M.unet(net, self.cfg["unet"], q[i:i + 1], self.t["train_timestep"],
                          self.context, ref=ref[i:i + 1], added=self.added)
            loss = (pred - (-qm[i:i + 1])).square().mean() / b
            g = torch.autograd.grad(loss, list(self.params.values()), allow_unused=True)
            for (n, p), gi in zip(self.params.items(), g):
                if gi is not None:
                    grads[n] += gi
            total += float(loss.detach())
        return total, grads

    def lr(self, count: int) -> float:
        t = self.t
        pct = min(max(1.0 - count / max(t["max_train_steps"], 1), 0.0), 1.0)
        return (t["learning_rate"] - t["lr_end"]) * pct ** t["lr_power"] + t["lr_end"]

    @torch.no_grad()
    def update(self, grads: dict) -> tuple:
        """Clip, AdamW; returns (pre-clip global norm, {leaf: the norm of
        the clipped gradient the optimizer took})."""
        t = self.t
        gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        scale = 1.0 if gnorm < t["max_grad_norm"] else t["max_grad_norm"] / gnorm
        b1, b2, eps, wd = t["adam_beta1"], t["adam_beta2"], t["adam_epsilon"], t["adam_weight_decay"]
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        lr = self.lr(self.count - 1)
        taken = {}
        for n, p in self.params.items():
            g = grads[n] * scale
            taken[n] = float(g.norm())
            self.mu[n] = (1.0 - b1) * g + b1 * self.mu[n]
            self.nu[n] = (1.0 - b2) * g * g + b2 * self.nu[n]
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + eps) + wd * p
            p -= lr * u
        return gnorm, taken
