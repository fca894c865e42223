"""Neural-net building blocks on NHWC tensors (port of `models/layers.py`).

Activations keep the JAX package's NHWC layout.  A convolution views its
NHWC input as a channels-last NCHW tensor (`permute`, no copy), so cuDNN
runs its NHWC kernels and the output permutes back for free.  Weights keep
the torch/diffusers layouts (OIHW convs, (out, in) linears), so each
module's `state_dict` keys and shapes are the diffusers checkpoint's.

Numerics follow the JAX formulas, not torch's built-ins, where the two
round differently:
  - `group_norm` / `layer_norm` take f32 sum and sum-of-squares, then apply
    `x * A + B` with A and B cast to the input dtype (`layers.py:76-123`);
    `F.group_norm`'s two-pass statistics and f32 apply round differently
    in bf16;
  - GELU is the exact erf form, GEGLU's first half is the value and the
    second the gate;
  - `timestep_embedding` swaps its sin/cos halves under `flip_sin_to_cos`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from diffews_tpu_torch.ops.groupnorm import group_norm_act
from diffews_tpu_torch.parallel import tensor_parallel as tp


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding=1) -> torch.Tensor:
    """Convolution of an NHWC input with an OIHW kernel; returns NHWC.

    padding: int (symmetric) or ((top, bottom), (left, right)) as in the
    JAX package."""
    xc = x.permute(0, 3, 1, 2)
    if not isinstance(padding, int):
        (pt, pb), (pl, pr) = padding
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            padding = 0
    y = F.conv2d(xc, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over NHWC (or (B, ..., C)) with the JAX package's rounding:
    f32 sum / sum-of-squares statistics, then `x * A + B` in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    spatial = tuple(range(1, x.ndim - 1))
    n = math.prod(x.shape[a] for a in spatial) * (c // groups)
    xf = x.float()
    s1 = xf.sum(dim=spatial)                       # (B, C)
    s2 = xf.square().sum(dim=spatial)
    s1g = s1.reshape(b, groups, -1).sum(-1)        # (B, G)
    s2g = s2.reshape(b, groups, -1).sum(-1)
    mean = s1g / n
    var = s2g / n - mean.square()
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)   # (B, C)
    mean_c = mean.repeat_interleave(c // groups, dim=1)
    scale = weight.float()[None]
    a = (inv_c * scale).to(x.dtype)
    bb = (bias.float()[None] - mean_c * inv_c * scale).to(x.dtype)
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    return x * a.reshape(shape) + bb.reshape(shape)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics applied as `x * a + b` in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
    inv = torch.rsqrt(var + eps)
    w = weight.float()
    a = (inv * w).to(x.dtype)
    b = (bias.float() - mean * inv * w).to(x.dtype)
    return x * a + b


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def timestep_embedding(timesteps: torch.Tensor, dim: int, *,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0,
                       dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers `get_timestep_embedding`).

    timesteps: (B,) tensor.  Returns (B, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest 2x upsample."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# modules (diffusers state_dict keys)
# ---------------------------------------------------------------------------


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose forward takes and returns NHWC tensors."""

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride=self.stride[0],
                      padding=self.padding[0] if padding is None else padding)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, groups=self.groups,
                          eps=self.eps)

    def norm_silu(self, x: torch.Tensor) -> torch.Tensor:
        """SiLU(GroupNorm(x)) through `ops.groupnorm.group_norm_act`: the
        GroupNorm kernels on the card, the plain formula on the CPU."""
        return group_norm_act(x, self.weight, self.bias, groups=self.groups, eps=self.eps,
                              act="silu")


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear (diffusers `linear_1`/`linear_2`)."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (default time-scale-shift, output factor 1).
    Both GroupNorm+SiLU pairs go through `GroupNorm.norm_silu`, i.e.
    `group_norm_act` (JAX `layers.py:184,189`)."""

    def __init__(self, cin: int, cout: int, temb_dim: Optional[int], *,
                 groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1, padding=0)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1.norm_silu(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2.norm_silu(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  The UNet pads symmetrically; the VAE encoder
    pads (0,1),(0,1) and convolves with padding 0 (`layers.py:196-207`)."""

    def __init__(self, c: int, *, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = ((0, 1), (0, 1)) if self.asymmetric_pad else 1
        return self.conv(x, padding=pad)


class Upsample2D(nn.Module):
    """Nearest 2x + 3x3 conv (diffusers Upsample2D with use_conv)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


class GEGLU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cout = cout
        self.proj = nn.Linear(cin, cout * 2)

    def forward(self, x: torch.Tensor, model_group=None) -> torch.Tensor:
        """Column-parallel over `model_group`: `proj` holds this rank's
        block of the `h` rows and the same block of the `gate` rows, and the
        replicated bias is sliced to them."""
        if model_group is None:
            y = self.proj(x)
        else:
            x = tp.copy_to_model(x, model_group)
            rank, n = dist.get_rank(model_group), dist.get_world_size(model_group)
            bias = tp.scatter_to_model(self.proj.bias, 0, tp.halves(self.cout, n, rank),
                                       model_group)
            y = F.linear(x, self.proj.weight, bias)
        h, gate = y.chunk(2, dim=-1)
        return h * gelu(gate)


class FeedForward(nn.Module):
    """diffusers FeedForward with GEGLU: net.0.proj -> chunk -> net.2;
    under `model_group` `net.2` is row-parallel (its bias added once, after
    the sum of the partial products)."""

    def __init__(self, c: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(c, c * mult), nn.Dropout(0.0), nn.Linear(c * mult, c)])

    def forward(self, x: torch.Tensor, model_group=None) -> torch.Tensor:
        h, out = self.net[0](x, model_group), self.net[2]
        if model_group is None:
            return out(h)
        return tp.reduce_from_model(F.linear(h, out.weight), model_group) + out.bias
