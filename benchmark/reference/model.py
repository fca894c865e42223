"""Plain float32 PyTorch reference of the DiffewS model math.

The SD-2.1 conditional UNet with DiffewS's KV-fusion self-attention, the SD
VAE, the OpenCLIP ViT-H text tower and the W8A8 quantization the
configuration can state, written from their published descriptions
(diffusers `UNet2DConditionModel`, `AutoencoderKL`, transformers
`CLIPTextModel`; DiffewS, arXiv 2410.02369) in NCHW with stock torch ops.
No kernels, no caches beyond the support K/V the configuration defines, no
batching tricks.  It imports nothing of the program under test.

Weights are looked up by their diffusers names, so a run with `weights=None`
on the meta device records the whole layout (`Net.layout`), which is how
the benchmark learns every parameter's name and shape, and a `Work` object
passed in counts the operations and bytes each layer needs.

KV-fusion (DiffewS): the support rows (B·N, b-major) enter through
`conv_in_ref` (8 channels: support RGB latent ‖ support-mask latent), the
query rows through `conv_in`; at every UNet self-attention the support rows
attend to themselves and each query row attends to `[own ‖ its N shots]`
keys and values.  A support set's K/V can be captured once and reused for
any query (the program's support cache computes the same function).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F


@dataclass
class Work:
    """Operations and bytes of one forward, counted from shapes as the
    layers are walked (on the meta device).  `elt` is the activation
    element size of the program being measured."""

    elt: int = 2
    flops: float = 0.0          # every matmul, convolution and attention product, 2 per MAC
    int8_ops: float = 0.0       # the part of `flops` that runs as int8 products
    attention: List[tuple] = field(default_factory=list)   # flash sites (B, H, Sq, Skv, d)
    attention_bwd: List[tuple] = field(default_factory=list)  # flash sites differentiated
    gn_silu: List[int] = field(default_factory=list)       # GroupNorm+SiLU sites: elements
    int8_conv: List[tuple] = field(default_factory=list)   # (B, H, W, Cin, Cout, Ho, Wo)


class Quant:
    """Symmetric W8A8 (or, as a control, narrower) quantization of a set of
    sites: per-output-channel weight scales, one static activation scale
    per site calibrated as amax(|x|) · margin over one run.  With `scales`
    None the sites run in float and record their amax (calibration)."""

    def __init__(self, kind: str, bits: int = 8, scales: Optional[dict] = None,
                 margin: float = 1.25):
        self.kind, self.qmax, self.margin = kind, 2 ** (bits - 1) - 1, margin
        self.scales = scales
        self.amax: dict = {}

    def inv(self, device) -> torch.Tensor:
        return torch.tensor(1.0 / self.qmax, dtype=torch.float32).to(device)

    def calibrated(self) -> dict:
        return {k: float(v) * self.margin for k, v in self.amax.items()}

    def record(self, name: str, x: torch.Tensor) -> None:
        a = x.detach().abs().amax().float()
        self.amax[name] = a if name not in self.amax else torch.maximum(self.amax[name], a)

    def activation(self, name: str, x: torch.Tensor):
        s = torch.tensor(self.scales[name], dtype=torch.float32).to(x.device) * self.inv(x.device)
        s = torch.clamp_min(s, 1e-12)
        return torch.clamp(torch.round(x / s), -self.qmax, self.qmax), s

    def weight(self, w: torch.Tensor):
        dims = tuple(range(1, w.ndim))
        s = torch.clamp_min(w.abs().amax(dim=dims) * self.inv(w.device), 1e-12)
        shape = (-1,) + (1,) * (w.ndim - 1)
        return torch.clamp(torch.round(w / s.reshape(shape)), -self.qmax, self.qmax), s


def vae_conv_site(name: str, k: int, cin: int) -> bool:
    """The W8A8 VAE's sites: every 3x3 convolution with at least 32 input
    channels."""
    return k == 3 and cin >= 32


def unet_linear_site(name: str) -> bool:
    """The W8A8 UNet's sites: the self-attention projections, the GEGLU
    feed-forward and the transformers' proj_in / proj_out."""
    return (".attn1." in name or ".ff." in name or name.endswith(".proj_in")
            or name.endswith(".proj_out"))


class Net:
    """One model's weights by diffusers name, and how its convolutions and
    linears run: in float, quantized (`quant`), or recording the layout
    (`weights` None, meta tensors)."""

    def __init__(self, weights: Optional[dict] = None, quant: Optional[Quant] = None,
                 work: Optional[Work] = None, low=None):
        """`low`: None, or a narrower float type (e.g. torch.float8_e4m3fn)
        every convolution's and linear's operands are rounded to, with
        saturation at its largest finite value (a control)."""
        self.weights, self.quant, self.work, self.low = weights, quant, work, low
        self.layout: dict = {}

    def _low(self, t: torch.Tensor) -> torch.Tensor:
        if self.low is None:
            return t
        big = torch.finfo(self.low).max
        return t.clamp(-big, big).to(self.low).to(t.dtype)

    def p(self, name: str, shape) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        self.layout[name] = shape
        if self.weights is None:
            return torch.empty(shape, device="meta")
        t = self.weights[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: weight {tuple(t.shape)}, layer wants {shape}")
        return t

    def _quantized(self, kind: str, name: str, x: torch.Tensor, site: bool):
        q = self.quant
        if q is None or q.kind != kind or not site:
            return None
        if q.scales is None:
            q.record(name, x)
            return None
        return q

    def conv(self, name: str, x: torch.Tensor, cout: int, k: int = 3, stride: int = 1,
             pad=1) -> torch.Tensor:
        """`pad` an int, or (left, right, top, bottom) zero padding."""
        cin = x.shape[1]
        w = self.p(f"{name}.weight", (cout, cin, k, k))
        b = self.p(f"{name}.bias", (cout,))
        q = self._quantized("conv", name, x, vae_conv_site(name, k, cin))
        h_in, w_in = x.shape[2], x.shape[3]
        if not isinstance(pad, int):
            x = F.pad(x, pad)
            pad = 0
        if q is None:
            y = F.conv2d(self._low(x), self._low(w), b, stride=stride, padding=pad)
        else:
            xq, s_a = q.activation(name, x)
            wq, s_w = q.weight(w)
            y = F.conv2d(xq, wq, stride=stride, padding=pad)
            y = y * (s_w * s_a)[None, :, None, None] + b[None, :, None, None]
        if self.work is not None:
            ops = 2.0 * y.numel() * cin * k * k
            self.work.flops += ops
            if self.quant is not None and self.quant.kind == "conv" and vae_conv_site(name, k, cin):
                self.work.int8_ops += ops
                self.work.int8_conv.append((x.shape[0], h_in, w_in, cin, cout,
                                            y.shape[2], y.shape[3]))
        return y

    def linear(self, name: str, x: torch.Tensor, cout: int, bias: bool = True) -> torch.Tensor:
        cin = x.shape[-1]
        w = self.p(f"{name}.weight", (cout, cin))
        b = self.p(f"{name}.bias", (cout,)) if bias else None
        q = self._quantized("linear", name, x, unet_linear_site(name))
        if q is None:
            y = F.linear(self._low(x), self._low(w), b)
        else:
            xq, s_a = q.activation(name, x)
            wq, s_w = q.weight(w)
            y = F.linear(xq, wq) * (s_w * s_a)
            if b is not None:
                y = y + b
        if self.work is not None:
            ops = 2.0 * (x.numel() // cin) * cin * cout
            self.work.flops += ops
            if self.quant is not None and self.quant.kind == "linear" and unet_linear_site(name):
                self.work.int8_ops += ops
        return y

    def group_norm(self, name: str, x: torch.Tensor, groups: int, eps: float,
                   silu: bool = False) -> torch.Tensor:
        c = x.shape[1]
        y = F.group_norm(x, groups, self.p(f"{name}.weight", (c,)),
                         self.p(f"{name}.bias", (c,)), eps)
        if silu:
            if self.work is not None:
                self.work.gn_silu.append(x.numel())
            y = F.silu(y)
        return y

    def layer_norm(self, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        c = x.shape[-1]
        return F.layer_norm(x, (c,), self.p(f"{name}.weight", (c,)),
                            self.p(f"{name}.bias", (c,)), eps)

    def attention(self, q, k, v, heads: int, flash: bool = True, causal: bool = False):
        """softmax(q·kᵀ/√d)·v over (B, S, C) operands, row by row of the
        batch so the f32 probabilities of a long support fit."""
        b, sq, c = q.shape
        skv, d = k.shape[1], c // heads
        if self.work is not None:
            self.work.flops += 4.0 * b * heads * sq * skv * d
            if flash:
                self.work.attention.append((b, heads, sq, skv, d))
        out = torch.empty_like(q)
        for i in range(b):
            qi = q[i].reshape(sq, heads, d).transpose(0, 1)
            ki = k[i].reshape(skv, heads, d).transpose(0, 1)
            vi = v[i].reshape(skv, heads, d).transpose(0, 1)
            s = (qi @ ki.transpose(1, 2)) * (d ** -0.5)
            if causal:
                s = s + torch.triu(torch.full((sq, skv), float("-inf"), device=q.device), 1)
            out[i] = (torch.softmax(s, dim=-1) @ vi).transpose(0, 1).reshape(sq, c)
        return out


# ---------------------------------------------------------------------------
# shared blocks
# ---------------------------------------------------------------------------


def resnet(net: Net, name: str, x, cout: int, temb, groups: int, eps: float):
    h = net.conv(f"{name}.conv1", net.group_norm(f"{name}.norm1", x, groups, eps, silu=True),
                 cout)
    if temb is not None:
        h = h + net.linear(f"{name}.time_emb_proj", F.silu(temb), cout)[:, :, None, None]
    h = net.conv(f"{name}.conv2", net.group_norm(f"{name}.norm2", h, groups, eps, silu=True),
                 cout)
    if x.shape[1] != cout:
        x = net.conv(f"{name}.conv_shortcut", x, cout, k=1, pad=0)
    return x + h


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# UNet with KV-fusion
# ---------------------------------------------------------------------------


@dataclass
class Streams:
    """How the rows split at a self-attention site: `ref_rows` support rows
    first (N shots per query), or the query rows alone against `cache`."""

    ref_rows: int = 0
    n_shots: int = 0
    capture: Optional[list] = None       # receives each site's (k_sup, v_sup): (B, N·S, C)
    cache: Optional[Iterator] = None     # yields captured entries in site order


def timestep_embedding(t: float, dim: int, flip: bool, shift: float, device):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device)
    emb = torch.exp(exponent / (half - shift)) * float(t)
    emb = torch.cat([torch.sin(emb), torch.cos(emb)])
    if flip:
        emb = torch.cat([emb[half:], emb[:half]])
    return emb[None]


def self_attention(net: Net, name: str, h, heads: int, st: Streams):
    c = h.shape[-1]
    q = net.linear(f"{name}.to_q", h, c, bias=False)
    k = net.linear(f"{name}.to_k", h, c, bias=False)
    v = net.linear(f"{name}.to_v", h, c, bias=False)
    if st.cache is not None:
        k_sup, v_sup = next(st.cache)
        b = h.shape[0]
        k = torch.cat([k, k_sup.expand(b, -1, -1)], dim=1)
        v = torch.cat([v, v_sup.expand(b, -1, -1)], dim=1)
        out = net.attention(q, k, v, heads)
    elif st.ref_rows:
        r, s = st.ref_rows, h.shape[1]
        b = h.shape[0] - r
        out_ref = net.attention(q[:r], k[:r], v[:r], heads)
        k_sup = k[:r].reshape(b, st.n_shots * s, c)
        v_sup = v[:r].reshape(b, st.n_shots * s, c)
        if st.capture is not None:
            st.capture.append((k_sup, v_sup))
        out_q = net.attention(q[r:], torch.cat([k[r:], k_sup], dim=1),
                              torch.cat([v[r:], v_sup], dim=1), heads)
        out = torch.cat([out_ref, out_q])
    else:
        out = net.attention(q, k, v, heads)
    return net.linear(f"{name}.to_out.0", out, c)


def transformer(net: Net, name: str, x, ctx, heads: int, cfg: dict, st: Streams):
    b, c, hh, ww = x.shape
    h = net.group_norm(f"{name}.norm", x, cfg["norm_num_groups"], 1e-6)
    h = net.linear(f"{name}.proj_in", h.permute(0, 2, 3, 1).reshape(b, hh * ww, c), c)
    for i in range(cfg["transformer_layers_per_block"]):
        blk = f"{name}.transformer_blocks.{i}"
        h = h + self_attention(net, f"{blk}.attn1", net.layer_norm(f"{blk}.norm1", h), heads, st)
        n2 = net.layer_norm(f"{blk}.norm2", h)
        kc = net.linear(f"{blk}.attn2.to_k", ctx, c, bias=False)
        vc = net.linear(f"{blk}.attn2.to_v", ctx, c, bias=False)
        qc = net.linear(f"{blk}.attn2.to_q", n2, c, bias=False)
        h = h + net.linear(f"{blk}.attn2.to_out.0",
                           net.attention(qc, kc, vc, heads, flash=False), c)
        g = net.linear(f"{blk}.ff.net.0.proj", net.layer_norm(f"{blk}.norm3", h), 8 * c)
        val, gate = g.chunk(2, dim=-1)
        h = h + net.linear(f"{blk}.ff.net.2", val * F.gelu(gate), c)
    h = net.linear(f"{name}.proj_out", h, c)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def unet(net: Net, cfg: dict, sample, t: float, ctx, ref=None, capture=None, cache=None):
    """The joint forward.  sample: (B, 4, h, w) query latents; ctx: (1, L,
    D) text context; ref: (B, N, 8, h, w) support latents ‖ mask latents,
    or None with `cache` (per-site support K/V of one support set).
    Returns the query rows' prediction (B, 4, h, w)."""
    chans, n = cfg["block_out_channels"], len(cfg["block_out_channels"])
    g, eps, heads = cfg["norm_num_groups"], cfg["norm_eps"], cfg["num_attention_heads"]
    attn_down = [bt == "CrossAttnDownBlock2D" for bt in cfg["down_block_types"]]
    attn_up = [bt == "CrossAttnUpBlock2D" for bt in cfg["up_block_types"]]
    b = sample.shape[0]
    temb = timestep_embedding(t, chans[0], cfg["flip_sin_to_cos"], cfg["freq_shift"],
                              sample.device)
    temb = net.linear("time_embedding.linear_2",
                      F.silu(net.linear("time_embedding.linear_1", temb, 4 * chans[0])),
                      4 * chans[0])
    h = net.conv("conv_in", sample, chans[0])
    st = Streams(capture=capture, cache=None if cache is None else iter(cache))
    if ref is not None:
        st.n_shots = ref.shape[1]
        st.ref_rows = b * st.n_shots
        h = torch.cat([net.conv("conv_in_ref", ref.reshape((st.ref_rows,) + ref.shape[2:]),
                                chans[0]), h])
    ctx = ctx.expand(h.shape[0], -1, -1)

    skips = [h]
    for i in range(n):
        for j in range(cfg["layers_per_block"]):
            h = resnet(net, f"down_blocks.{i}.resnets.{j}", h, chans[i], temb, g, eps)
            if attn_down[i]:
                h = transformer(net, f"down_blocks.{i}.attentions.{j}", h, ctx, heads[i], cfg, st)
            skips.append(h)
        if i < n - 1:
            h = net.conv(f"down_blocks.{i}.downsamplers.0.conv", h, chans[i], stride=2)
            skips.append(h)
    h = resnet(net, "mid_block.resnets.0", h, chans[-1], temb, g, eps)
    h = transformer(net, "mid_block.attentions.0", h, ctx, heads[-1], cfg, st)
    h = resnet(net, "mid_block.resnets.1", h, chans[-1], temb, g, eps)
    for i in range(n):
        c = chans[n - 1 - i]
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(net, f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=1),
                       c, temb, g, eps)
            if attn_up[i]:
                h = transformer(net, f"up_blocks.{i}.attentions.{j}", h, ctx, heads[n - 1 - i],
                                cfg, st)
        if i < n - 1:
            h = net.conv(f"up_blocks.{i}.upsamplers.0.conv", upsample2x(h), c)
    if st.cache is not None and next(st.cache, None) is not None:
        raise ValueError("the support cache has more entries than the UNet has sites")
    h = F.silu(net.group_norm("conv_norm_out", h[st.ref_rows:], g, eps))
    return net.conv("conv_out", h, cfg["out_channels"])


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

VAE_EPS = 1e-6


def vae_mid(net: Net, name: str, h, groups: int):
    c = h.shape[1]
    h = resnet(net, f"{name}.resnets.0", h, c, None, groups, VAE_EPS)
    a = f"{name}.attentions.0"
    b, _, hh, ww = h.shape
    y = net.group_norm(f"{a}.group_norm", h, groups, VAE_EPS)
    y = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    o = net.attention(net.linear(f"{a}.to_q", y, c), net.linear(f"{a}.to_k", y, c),
                      net.linear(f"{a}.to_v", y, c), 1)
    h = net.linear(f"{a}.to_out.0", o, c).reshape(b, hh, ww, c).permute(0, 3, 1, 2) + h
    return resnet(net, f"{name}.resnets.1", h, c, None, groups, VAE_EPS)


def vae_moments(net: Net, cfg: dict, x):
    """(B, 3, H, W) image in [-1, 1] -> (B, 2·latent, H/8, W/8) moments."""
    chans, g = cfg["block_out_channels"], cfg["norm_num_groups"]
    n = len(chans)
    h = net.conv("encoder.conv_in", x, chans[0])
    for i in range(n):
        for j in range(cfg["layers_per_block"]):
            h = resnet(net, f"encoder.down_blocks.{i}.resnets.{j}", h, chans[i], None, g, VAE_EPS)
        if i < n - 1:
            h = net.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", h, chans[i], stride=2,
                         pad=(0, 1, 0, 1))
    h = vae_mid(net, "encoder.mid_block", h, g)
    h = net.group_norm("encoder.conv_norm_out", h, g, VAE_EPS, silu=True)
    h = net.conv("encoder.conv_out", h, 2 * cfg["latent_channels"])
    return net.conv("quant_conv", h, 2 * cfg["latent_channels"], k=1, pad=0)


def vae_encode_mean(net: Net, cfg: dict, x):
    """The posterior mean latent times the scaling factor."""
    return vae_moments(net, cfg, x)[:, :cfg["latent_channels"]] * cfg["scaling_factor"]


def vae_decode(net: Net, cfg: dict, z):
    """(B, latent, h, w) scaled latent -> (B, 3, 8h, 8w) image, unclipped."""
    rev, g = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
    n = len(rev)
    z = net.conv("post_quant_conv", z / cfg["scaling_factor"], cfg["latent_channels"], k=1, pad=0)
    h = vae_mid(net, "decoder.mid_block", net.conv("decoder.conv_in", z, rev[0]), g)
    for i in range(n):
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(net, f"decoder.up_blocks.{i}.resnets.{j}", h, rev[i], None, g, VAE_EPS)
        if i < n - 1:
            h = net.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", upsample2x(h), rev[i])
    h = net.group_norm("decoder.conv_norm_out", h, g, VAE_EPS, silu=True)
    return net.conv("decoder.conv_out", h, cfg["out_channels"])


# ---------------------------------------------------------------------------
# CLIP text tower
# ---------------------------------------------------------------------------


def clip_text(net: Net, cfg: dict, ids: torch.Tensor):
    """(B, S) token ids -> final-layer-normed last hidden state (B, S, D)."""
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    s = ids.shape[1]
    tok = net.p("embeddings.token_embedding.weight", (vocab, d))
    pos = net.p("embeddings.position_embedding.weight", (cfg["max_position_embeddings"], d))
    if tok.device.type == "meta":
        x = torch.empty((ids.shape[0], s, d), device="meta")
    else:
        x = tok[ids.clamp(0, vocab - 1)] + pos[:s][None]
    eps = cfg["layer_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        L = f"encoder.layers.{i}"
        h = net.layer_norm(f"{L}.layer_norm1", x, eps)
        q = net.linear(f"{L}.self_attn.q_proj", h, d)
        k = net.linear(f"{L}.self_attn.k_proj", h, d)
        v = net.linear(f"{L}.self_attn.v_proj", h, d)
        a = net.attention(q, k, v, cfg["num_attention_heads"], flash=False, causal=True)
        x = x + net.linear(f"{L}.self_attn.out_proj", a, d)
        h = net.linear(f"{L}.mlp.fc1", net.layer_norm(f"{L}.layer_norm2", x, eps),
                       cfg["intermediate_size"])
        x = x + net.linear(f"{L}.mlp.fc2", F.gelu(h), d)
    return net.layer_norm("final_layer_norm", x, eps)
