"""AutoencoderKL (SD VAE) on NHWC tensors (port of `models/vae.py`).

Resnet implementations (`resnet_impl`, the JAX package's strings):
  - "xla": plain resnet blocks (`layers.ResnetBlock2D`, whose GroupNorm+SiLU
    pairs and the head's go through `group_norm_act`);
  - "fused": each resnet block is two `gn_silu_conv3x3` calls with the
    GroupNorm statistics threaded from one call to the next (the fused
    kernel on the card, its plain version on the CPU); the chain restarts
    from fresh statistics after conv_in, a resampler and the mid-block
    attention, and the head (norm + SiLU + conv_out) is one more call;
  - "mixed": "fused" only where the grid has at least `MIXED_MIN_PIXELS`
    pixels, "xla" below; the decoder's head follows its last block;
  - "pallas": "fused" with the kernel named explicitly;
  - "auto": "xla", as in the JAX package (the pipeline's `vae_impl="auto"`
    picks "fused" for small encode batches itself).

The mid-block attention goes through `ops.attention.fused_kv_attention`
(the flash kernel on the card).  Latents: deterministic posterior means
for eval, reparametrised posterior samples for training.  `state_dict`
keys are the diffusers AutoencoderKL keys (modern `to_q/to_k/to_v/to_out.0`
names; `checkpoint.py` maps the legacy ones).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffews_tpu_torch.configs import VAEConfig
from diffews_tpu_torch.models.layers import (Conv2d, Downsample2D, GroupNorm,
                                             ResnetBlock2D, Upsample2D)
from diffews_tpu_torch.ops.attention import fused_kv_attention
from diffews_tpu_torch.ops.fused_resnet import fused_norm_conv_out, fused_resnet_block
from diffews_tpu_torch.utils.profiling import annotate

EPS = 1e-6  # VAE GroupNorm epsilon (diffusers AutoencoderKL default)
RESNET_IMPLS = ("auto", "xla", "fused", "mixed", "pallas")

# "mixed" runs the fused chain only on grids of at least this many pixels
# (the JAX package's threshold, chosen from TPU measurements; read at call
# time, so tests can lower it).
MIXED_MIN_PIXELS = 256 * 256


def _resolve_resnet_impl(impl: str) -> str:
    if impl not in RESNET_IMPLS:
        raise ValueError(f"unknown resnet_impl {impl!r} (expected one of {RESNET_IMPLS})")
    return "xla" if impl == "auto" else impl


def _resnet(block: ResnetBlock2D, h: torch.Tensor, st, impl: str):
    """One resnet block; threads the GroupNorm statistics when fused."""
    if impl == "mixed":
        impl = "fused" if h.shape[1] * h.shape[2] >= MIXED_MIN_PIXELS else "xla"
        st = st if impl == "fused" else None
    with annotate("diffews.vae.resnet"):
        if impl in ("fused", "pallas"):
            return fused_resnet_block(block, h, st, groups=block.norm1.groups, eps=EPS,
                                      impl="auto" if impl == "fused" else "pallas")
        return block(h), None


def _head(norm: GroupNorm, conv: Conv2d, h: torch.Tensor, st, fused: bool,
          impl: str) -> torch.Tensor:
    """conv_out(silu(conv_norm_out(h))): one fused call, or `group_norm_act`
    (JAX `vae.py:119,171`) and the conv."""
    if fused:
        return fused_norm_conv_out(norm, conv, h, st, groups=norm.groups, eps=EPS,
                                   impl="pallas" if impl == "pallas" else "auto")
    return conv(norm.norm_silu(h))


class VAEAttention(nn.Module):
    """Single-head full-channel attention over spatial tokens."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, EPS)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        b, h, w, c = x.shape
        with annotate("diffews.vae.attention"):
            y = self.group_norm(x).reshape(b, h * w, c)
            q = self.to_q(y)[:, :, None, :]  # 1 head
            k = self.to_k(y)[:, :, None, :]
            v = self.to_v(y)[:, :, None, :]
            o = fused_kv_attention(q, k, v, None, None, impl=attn_impl)[:, :, 0, :]
            return self.to_out[0](o).reshape(b, h, w, c) + x


class MidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, c, None, groups=groups, eps=EPS) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(c, groups)])

    def forward(self, x: torch.Tensor, st, attn_impl: str, impl: str):
        x, _ = _resnet(self.resnets[0], x, st, impl)
        x = self.attentions[0](x, attn_impl)
        return _resnet(self.resnets[1], x, None, impl)  # the attention broke the chain


class _Block(nn.Module):
    """A down (encoder) or up (decoder) block: resnets + optional resampler."""

    def __init__(self, resnets, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        n = len(chans)
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        blocks, cin = [], chans[0]
        for i in range(n):
            cout = chans[i]
            res = [ResnetBlock2D(cin if j == 0 else cout, cout, None, groups=g, eps=EPS)
                   for j in range(cfg.layers_per_block)]
            down = Downsample2D(cout, asymmetric_pad=True) if i < n - 1 else None
            blocks.append(_Block(res, "downsamplers", down))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], EPS)
        self.conv_out = Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)
        self._down_spans = tuple(f"diffews.vae.encoder.down{i}" for i in range(n))

    def forward(self, x: torch.Tensor, attn_impl: str, impl: str = "xla") -> torch.Tensor:
        h, st = self.conv_in(x), None
        for i, blk in enumerate(self.down_blocks):
            with annotate(self._down_spans[i]):
                for r in blk.resnets:
                    h, st = _resnet(r, h, st, impl)
                if hasattr(blk, "downsamplers"):
                    h, st = blk.downsamplers[0](h), None
        with annotate("diffews.vae.encoder.mid"):
            h, st = self.mid_block(h, st, attn_impl, impl)
        with annotate("diffews.vae.encoder.head"):
            return _head(self.conv_norm_out, self.conv_out, h, st, impl in ("fused", "pallas"),
                         impl)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        n = len(rev)
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        blocks, cin = [], rev[0]
        for i in range(n):
            cout = rev[i]
            res = [ResnetBlock2D(cin if j == 0 else cout, cout, None, groups=g, eps=EPS)
                   for j in range(cfg.layers_per_block + 1)]
            up = Upsample2D(cout) if i < n - 1 else None
            blocks.append(_Block(res, "upsamplers", up))
            cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], EPS)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)
        self._up_spans = tuple(f"diffews.vae.decoder.up{i}" for i in range(n))

    def forward(self, z: torch.Tensor, attn_impl: str, impl: str = "xla") -> torch.Tensor:
        h = self.conv_in(z)
        with annotate("diffews.vae.decoder.mid"):
            h, st = self.mid_block(h, None, attn_impl, impl)
        for i, blk in enumerate(self.up_blocks):
            with annotate(self._up_spans[i]):
                for r in blk.resnets:
                    h, st = _resnet(r, h, st, impl)
                if hasattr(blk, "upsamplers"):
                    h, st = blk.upsamplers[0](h), None
        # "mixed" ends at full resolution, where its fused blocks ran, so the
        # head belongs to the fused chain there too
        fused = impl in ("fused", "pallas") or (
            impl == "mixed" and h.shape[1] * h.shape[2] >= MIXED_MIN_PIXELS)
        with annotate("diffews.vae.decoder.head"):
            return _head(self.conv_norm_out, self.conv_out, h, st, fused, impl)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, padding=0)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1, padding=0)

    def encode_moments(self, x: torch.Tensor, attn_impl: str = "auto",
                       resnet_impl: str = "auto") -> torch.Tensor:
        """NHWC image in [-1, 1] -> (B, H/8, W/8, 2*latent) moments."""
        return self.quant_conv(self.encoder(x, attn_impl, _resolve_resnet_impl(resnet_impl)))

    def encode_mean_latent(self, x: torch.Tensor, attn_impl: str = "auto",
                           resnet_impl: str = "auto") -> torch.Tensor:
        """Deterministic latent: posterior mean x scaling_factor (eval path)."""
        moments = self.encode_moments(x, attn_impl, resnet_impl)
        return moments[..., : self.cfg.latent_channels] * self.cfg.scaling_factor

    def sample_latent(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
                      generator: Optional[torch.Generator] = None,
                      attn_impl: str = "auto", resnet_impl: str = "auto") -> torch.Tensor:
        """Reparametrised posterior sample x scaling_factor (train path,
        `vae.py:133-142`): logvar clipped to [-30, 20], std = exp(logvar/2),
        (mean + std·noise)·scaling_factor.  `noise` is standard normal of
        the latent's shape (tests feed the JAX package's draws); without it
        the draw comes from `generator` in the latent's dtype."""
        moments = self.encode_moments(x, attn_impl, resnet_impl)
        mean, logvar = moments.chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=mean.device)
        return (mean + std * noise.to(mean.dtype)) * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor, attn_impl: str = "auto",
               resnet_impl: str = "auto") -> torch.Tensor:
        """Scaled latent -> NHWC image (unclipped; the pipeline clips)."""
        z = self.post_quant_conv(z / self.cfg.scaling_factor)
        return self.decoder(z, attn_impl, _resolve_resnet_impl(resnet_impl))
