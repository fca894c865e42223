"""SD-2.1 conditional UNet with KV-fusion in-context conditioning.

Port of `diffews_tpu/models/unet.py::forward` (`unet.py:176-409`).  Both
streams run in one forward:

  - support rows (B*N, b-major) enter through `conv_in_ref` (8 channels:
    support RGB latent ‖ support-mask latent), query rows (B) through
    `conv_in`; the streams are concatenated along batch, so every conv,
    resnet, cross-attention and FFN processes them together;
  - at each self-attention the streams split: support rows self-attend,
    query rows attend over `[own K/V ‖ shot-folded support K/V]`
    (`_attn1`, `unet.py:59-123`) through `ops.attention.fused_kv_attention`
    (the flash kernel on the card);
  - padded shots are masked by `shot_mask`;
  - the attn-mask variant (`ref_mask`) feeds support RGB latents through the
    shared `conv_in` and biases support keys by `(1-m)*-1e4`, with the mask
    nearest-resized to each level's token grid (`unet.py:313-324`);
  - the output head runs on the query rows only (`unet.py:404-409`).

`remat=True` recomputes activations in the backward pass at the JAX
package's granularity (`unet.py:332-396`): each down layer (resnet +
attention), the mid block and each up layer (skip concat + resnet +
attention) run under `torch.utils.checkpoint` (non-reentrant).

Support-KV cache (`kv_capture` / `kv_cache`, `unet.py:59-123,230-266`): a
capturing forward appends every self-attention site's shot-folded support
K/V (and the attn-mask key bias) in forward order; a cached forward runs
the query stream alone and attends over `[own ‖ cached support]` at each
site.  The support rows never read the query rows, so the captured K/V
equal a joint forward's.

Shot-parallel attention (`shot_group`, JAX `shot_axis`, `unet.py:59-123,
189-260`): each rank of a process group passes its local shard of shots
(`ref_sample`, `ref_context`, `shot_mask`, `ref_mask`) beside the full
query stream; every fused self-attention site merges the query rows'
partial softmaxes over the group
(`ops.attention.shot_parallel_fused_kv_attention`), so each rank returns
the whole query prediction.

Tensor parallelism (`model_group`, JAX's "model" mesh axis with
`parallel.mesh._TP_RULES`): the modules' weights are this rank's parts
(bound by the training step): whole heads of `to_q` / `to_k` / `to_v`
(rows) and `to_out.0` (columns), and a block of each GEGLU half of
`ff.net.0.proj` with the matching columns of `ff.net.2`.  Each attention
and feed-forward runs column-parallel then row-parallel around the
collectives of `parallel/tensor_parallel.py`; every rank returns the whole
prediction.

`state_dict` keys are the diffusers `UNet2DConditionModel` keys plus
`conv_in_ref.*`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffews_tpu_torch.configs import UNetConfig
from diffews_tpu_torch.models.layers import (Conv2d, Downsample2D, FeedForward,
                                             GroupNorm, LayerNorm, ResnetBlock2D,
                                             TimestepEmbedding, Upsample2D, silu,
                                             timestep_embedding)
from diffews_tpu_torch.ops.attention import (cross_attention, fused_kv_attention,
                                             merge_heads, shot_parallel_fused_kv_attention)
from diffews_tpu_torch.ops.resize import nearest_resize
from diffews_tpu_torch.parallel import tensor_parallel as tp
from diffews_tpu_torch.utils.profiling import annotate

ATTN_EPS = 1e-6  # Transformer2D GroupNorm epsilon


@dataclass
class _Streams:
    """How the batch splits at a self-attention site."""

    ref_rows: Optional[int]             # R = B*N support rows first, or None
    n_shots: int
    shot_mask: Optional[torch.Tensor]   # (B, N) bool
    sup_bias: Optional[torch.Tensor]    # (B, N*S) attn-mask key bias
    attn_impl: str
    kv_capture: Optional[list] = None   # receives (k_sup, v_sup, bias) per site
    kv_iter: Optional[Iterator] = None  # yields captured entries, in site order
    shot_group: object = None           # process group the shots are sharded over
    model_group: object = None          # process group of the tensor-parallel parts


class Attention(nn.Module):
    def __init__(self, q_dim: int, kv_dim: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, q_dim // heads
        self.to_q = nn.Linear(q_dim, q_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, q_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, q_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(q_dim, q_dim), nn.Dropout(0.0)])

    def _qkv(self, h: torch.Tensor, ctx: torch.Tensor, group):
        """q from `h`, k and v from `ctx`, split into this rank's heads (the
        projections' rows the module holds)."""
        if group is not None:  # self-attention's one input: one copy, one gradient sum
            same = ctx is h
            h = tp.copy_to_model(h, group)
            ctx = h if same else tp.copy_to_model(ctx, group)
        return self._heads(self.to_q(h)), self._heads(self.to_k(ctx)), self._heads(self.to_v(ctx))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, h·d) -> (B, S, h, d): the heads this rank holds (h may be 0
        where the heads do not divide the model axis)."""
        b, s, c = x.shape
        return x.reshape(b, s, c // self.head_dim, self.head_dim)

    def _out(self, x: torch.Tensor, group) -> torch.Tensor:
        """`to_out.0`; row-parallel over `group`: the partial products
        summed, then the bias added once."""
        lin = self.to_out[0]
        if group is None:
            return lin(x)
        return tp.reduce_from_model(F.linear(x, lin.weight), group) + lin.bias

    def self_attention(self, h: torch.Tensor, st: _Streams) -> torch.Tensor:
        """KV-fused self-attention; h: (R+B, S, C), support rows first."""
        q, k, v = self._qkv(h, h, st.model_group)
        if st.kv_iter is not None:
            entry = next(st.kv_iter, None)
            if entry is None:
                raise ValueError("kv_cache has fewer entries than this config's "
                                 "fused self-attention sites")
            k_sup, v_sup, bias = entry
            # a batch-1 cache (and its mask and bias) serves every query row
            over_b = lambda t: t if t is None or t.shape[0] == h.shape[0] else \
                t.expand((h.shape[0],) + tuple(t.shape[1:]))
            out = fused_kv_attention(q, k, v, over_b(k_sup), over_b(v_sup),
                                     shot_mask=over_b(st.shot_mask),
                                     support_bias=over_b(bias), impl=st.attn_impl)
        elif st.ref_rows is None:
            out = fused_kv_attention(q, k, v, None, None, impl=st.attn_impl)
        else:
            r = st.ref_rows
            b, s = h.shape[0] - r, h.shape[1]
            hd = q.shape[-1]
            out_ref = fused_kv_attention(q[:r], k[:r], v[:r], None, None,
                                         impl=st.attn_impl)
            k_sup = k[:r].reshape(b, st.n_shots, s, k.shape[2], hd)
            v_sup = v[:r].reshape(b, st.n_shots, s, v.shape[2], hd)
            if st.kv_capture is not None:
                # copies of the support rows alone: a view would keep the
                # whole site's K and V (query rows too) alive in the cache
                st.kv_capture.append((k_sup.clone(), v_sup.clone(), st.sup_bias))
            if st.shot_group is not None:
                # shots sharded over the group: exact partial-softmax merge
                out_tag = shot_parallel_fused_kv_attention(
                    q[r:], k[r:], v[r:], k_sup, v_sup, group=st.shot_group,
                    shot_mask=st.shot_mask, support_bias=st.sup_bias, impl=st.attn_impl)
            else:
                out_tag = fused_kv_attention(
                    q[r:], k[r:], v[r:], k_sup, v_sup, shot_mask=st.shot_mask,
                    support_bias=st.sup_bias, impl=st.attn_impl)
            out = torch.cat([out_ref, out_tag], dim=0)
        return self._out(merge_heads(out), st.model_group)

    def cross(self, h: torch.Tensor, ctx: torch.Tensor, model_group=None) -> torch.Tensor:
        q, k, v = self._qkv(h, ctx, model_group)
        return self._out(merge_heads(cross_attention(q, k, v)), model_group)


class BasicTransformerBlock(nn.Module):
    def __init__(self, c: int, cross_dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(c)
        self.attn1 = Attention(c, c, heads)
        self.norm2 = LayerNorm(c)
        self.attn2 = Attention(c, cross_dim, heads)
        self.norm3 = LayerNorm(c)
        self.ff = FeedForward(c)

    def forward(self, h, ctx, st: _Streams):
        h = h + self.attn1.self_attention(self.norm1(h), st)
        h = h + self.attn2.cross(self.norm2(h), ctx, st.model_group)
        return h + self.ff(self.norm3(h), st.model_group)


class Transformer2DModel(nn.Module):
    def __init__(self, c: int, heads: int, cfg: UNetConfig):
        super().__init__()
        self.linear = cfg.use_linear_projection
        self.norm = GroupNorm(cfg.norm_num_groups, c, ATTN_EPS)
        self.proj_in = nn.Linear(c, c) if self.linear else Conv2d(c, c, 1, padding=0)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(c, cfg.cross_attention_dim, heads)
             for _ in range(cfg.transformer_layers_per_block)])
        self.proj_out = nn.Linear(c, c) if self.linear else Conv2d(c, c, 1, padding=0)

    def forward(self, x, ctx, st: _Streams):
        b, hh, ww, c = x.shape
        h = self.norm(x)
        h = self.proj_in(h.reshape(b, hh * ww, c) if self.linear else h)
        h = h.reshape(b, hh * ww, c)
        for blk in self.transformer_blocks:
            h = blk(h, ctx, st)
        h = self.proj_out(h if self.linear else h.reshape(b, hh, ww, c))
        return h.reshape(b, hh, ww, c) + x


class _Block(nn.Module):
    def __init__(self, resnets, attentions, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class MidBlock(nn.Module):
    def __init__(self, c: int, heads: int, temb: int, cfg: UNetConfig):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, c, temb, groups=g, eps=eps) for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer2DModel(c, heads, cfg)])


def _resnet(res, h, emb):
    with annotate("diffews.unet.resnet"):
        return res(h, emb)


def _transformer(attn, h, ctx, st):
    if attn is None:
        return h
    with annotate("diffews.unet.transformer"):
        return attn(h, ctx, st)


def _down_layer(h, emb, ctx, res, attn, st):
    return _transformer(attn, _resnet(res, h, emb), ctx, st)


def _mid(h, emb, ctx, mid, st):
    h = _transformer(mid.attentions[0], _resnet(mid.resnets[0], h, emb), ctx, st)
    return _resnet(mid.resnets[1], h, emb)


def _up_layer(h, skip, emb, ctx, res, attn, st):
    return _transformer(attn, _resnet(res, torch.cat([h, skip], dim=-1), emb), ctx, st)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        chans, n = cfg.block_out_channels, cfg.num_levels
        g, eps, temb = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim
        k_in, k_out = cfg.conv_in_kernel, cfg.conv_out_kernel
        self.conv_in = Conv2d(cfg.in_channels, chans[0], k_in, padding=k_in // 2)
        self.conv_in_ref = Conv2d(cfg.ref_in_channels, chans[0], k_in, padding=k_in // 2)
        self.time_embedding = TimestepEmbedding(chans[0], temb)

        down, cin, skip_ch = [], chans[0], [chans[0]]
        for i in range(n):
            cout, heads = chans[i], cfg.num_attention_heads[i]
            with_attn = cfg.down_block_types[i] == "CrossAttnDownBlock2D"
            res, att = [], []
            for j in range(cfg.layers_per_block):
                res.append(ResnetBlock2D(cin if j == 0 else cout, cout, temb, groups=g, eps=eps))
                if with_attn:
                    att.append(Transformer2DModel(cout, heads, cfg))
                skip_ch.append(cout)
            ds = Downsample2D(cout) if i < n - 1 else None
            if ds is not None:
                skip_ch.append(cout)
            down.append(_Block(res, att, "downsamplers", ds))
            cin = cout
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(chans[-1], cfg.num_attention_heads[-1], temb, cfg)

        up, rev = [], list(reversed(chans))
        cin = rev[0]
        for i in range(n):
            cout, heads = rev[i], cfg.num_attention_heads[n - 1 - i]
            with_attn = cfg.up_block_types[i] == "CrossAttnUpBlock2D"
            res, att = [], []
            for j in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock2D((cin if j == 0 else cout) + skip_ch.pop(), cout,
                                         temb, groups=g, eps=eps))
                if with_attn:
                    att.append(Transformer2DModel(cout, heads, cfg))
            us = Upsample2D(cout) if i < n - 1 else None
            up.append(_Block(res, att, "upsamplers", us))
            cin = cout
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(g, chans[0], eps)
        self.conv_out = Conv2d(chans[0], cfg.out_channels, k_out, padding=k_out // 2)
        # each block's span name, built once
        self._down_spans = tuple(f"diffews.unet.down{i}" for i in range(n))
        self._up_spans = tuple(f"diffews.unet.up{i}" for i in range(n))

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        context: torch.Tensor,
        *,
        ref_sample: Optional[torch.Tensor] = None,
        ref_context: Optional[torch.Tensor] = None,
        shot_mask: Optional[torch.Tensor] = None,
        ref_mask: Optional[torch.Tensor] = None,
        attn_impl: str = "auto",
        remat: bool = False,
        kv_capture: Optional[list] = None,
        kv_cache=None,
        shot_group=None,
        model_group=None,
    ) -> torch.Tensor:
        """Joint support+query forward.

        sample: (B, H, W, in_channels) query latents; timestep: int or (B,);
        context: (B, L, cross_dim); ref_sample: optional (B, N, H, W,
        ref_in_channels) support latents (in_channels under `ref_mask`);
        ref_context: optional (B, N, L, cross_dim), default `context`
        repeated over shots; shot_mask: optional (B, N) bool; ref_mask:
        optional (B, N, Hm, Wm) binary support masks (attn-mask variant);
        remat: recompute each layer's activations in the backward pass.
        kv_capture: optional list (needs `ref_sample`): every fused
        self-attention site appends its `(k_sup, v_sup, bias)`, each K/V
        (B, N, S, heads, d), bias the attn-mask key bias (B, N*S) or None.
        kv_cache: optional sequence of such entries, consumed in forward
        order, in place of `ref_sample`: the query stream runs alone and
        attends over `[own ‖ cached support]`; entries of batch 1 serve any
        query batch, and `shot_mask` applies to the cached shots.
        shot_group: optional process group the shots are sharded over:
        `ref_sample`, `ref_context`, `shot_mask` and `ref_mask` carry this
        rank's shots, `sample`, `context` and `timestep` the same on every
        rank; each rank returns the whole query prediction.
        model_group: optional process group of the tensor-parallel parts
        the modules' attention and feed-forward weights hold (each rank
        passes the same inputs and returns the whole prediction).
        Returns (B, H, W, out_channels) for the query rows."""
        if kv_cache is not None and ref_sample is not None:
            raise ValueError("kv_cache replaces the support stream; "
                             "pass either kv_cache or ref_sample, not both")
        if kv_capture is not None and ref_sample is None:
            raise ValueError("kv_capture requires ref_sample (a live support "
                             "stream to capture)")
        if shot_group is not None and (kv_capture is not None or kv_cache is not None):
            raise ValueError("the support-KV cache does not compose with "
                             "shot-parallel serving (a shard's cache would skip "
                             "the cross-device softmax merge)")
        if model_group is not None and (shot_group is not None or kv_capture is not None
                                        or kv_cache is not None):
            raise ValueError("tensor parallelism (model_group) is a training path: it "
                             "does not compose with shot-parallel serving or the "
                             "support-KV cache")
        if remat and (kv_capture is not None or kv_cache is not None):
            # checkpoint runs each layer again in the backward pass, which
            # would consume the cache twice and capture every site twice
            raise ValueError("kv_capture/kv_cache are serving features and do "
                             "not compose with remat")
        kv_iter = iter(kv_cache) if kv_cache is not None else None
        cfg = self.cfg
        b = sample.shape[0]
        if ref_sample is not None:
            n_shots = ref_sample.shape[1]
            ref_rows = b * n_shots
            ref_flat = ref_sample.reshape((ref_rows,) + tuple(ref_sample.shape[2:]))
        else:
            n_shots, ref_rows, ref_flat = 0, None, None

        # --- time embedding (shared across both streams) ---
        if isinstance(timestep, torch.Tensor):
            ts = timestep.to(device=sample.device, dtype=torch.float32).reshape(-1)
        else:  # filled on the device: no host copy, no stream sync
            ts = torch.full((1,), float(timestep), dtype=torch.float32, device=sample.device)
        t_emb = timestep_embedding(ts, cfg.block_out_channels[0],
                                   flip_sin_to_cos=cfg.flip_sin_to_cos,
                                   downscale_freq_shift=cfg.freq_shift,
                                   dtype=sample.dtype)
        emb1 = self.time_embedding(t_emb)
        total_rows = b + (ref_rows or 0)
        if emb1.shape[0] == 1:
            emb = emb1.expand(total_rows, emb1.shape[1])
        else:
            reps = [emb1.repeat_interleave(n_shots, dim=0)] if ref_rows else []
            emb = torch.cat(reps + [emb1], dim=0)

        # --- context for the combined batch ---
        if ref_rows:
            if ref_context is None:
                ctx_ref = context.repeat_interleave(n_shots, dim=0)
            else:
                ctx_ref = ref_context.reshape((ref_rows,) + tuple(ref_context.shape[2:]))
            ctx = torch.cat([ctx_ref, context], dim=0)
        else:
            ctx = context

        # --- input convs: per-stream, then concat along batch ---
        h = self.conv_in(sample)
        if ref_rows:
            conv_ref = self.conv_in if ref_mask is not None else self.conv_in_ref
            h = torch.cat([conv_ref(ref_flat), h], dim=0)

        # --- attn-mask variant: per-level support-key biases ---
        sup_biases: Dict[int, torch.Tensor] = {}
        if ref_rows and ref_mask is not None:
            lat_h, lat_w = sample.shape[1], sample.shape[2]
            flat_mask = ref_mask.reshape((ref_rows,) + tuple(ref_mask.shape[2:])).float()
            for sid in range(cfg.num_levels):
                gh, gw = lat_h // (2 ** sid), lat_w // (2 ** sid)
                m = nearest_resize(flat_mask, (gh, gw)).reshape(b, n_shots * gh * gw)
                sup_biases[sid] = (1.0 - m) * -10000.0

        def streams(sid):
            return _Streams(ref_rows, n_shots, shot_mask, sup_biases.get(sid), attn_impl,
                            kv_capture, kv_iter, shot_group, model_group)

        def layer(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        n = cfg.num_levels
        # --- down path ---
        down_states = [h]
        for i, blk in enumerate(self.down_blocks):
            with annotate(self._down_spans[i]):
                for j, res in enumerate(blk.resnets):
                    attn = blk.attentions[j] if len(blk.attentions) else None
                    h = layer(_down_layer, h, emb, ctx, res, attn, streams(i))
                    down_states.append(h)
                if hasattr(blk, "downsamplers"):
                    h = blk.downsamplers[0](h)
                    down_states.append(h)

        # --- mid ---
        with annotate("diffews.unet.mid"):
            h = layer(_mid, h, emb, ctx, self.mid_block, streams(n - 1))

        # --- up path ---
        for i, blk in enumerate(self.up_blocks):
            with annotate(self._up_spans[i]):
                for j, res in enumerate(blk.resnets):
                    attn = blk.attentions[j] if len(blk.attentions) else None
                    h = layer(_up_layer, h, down_states.pop(), emb, ctx, res, attn,
                              streams(n - 1 - i))
                if hasattr(blk, "upsamplers"):
                    h = blk.upsamplers[0](h)

        if kv_iter is not None and next(kv_iter, None) is not None:
            raise ValueError("kv_cache has more entries than this config's "
                             "fused self-attention sites")

        # --- output head: query rows only ---
        if ref_rows:
            h = h[ref_rows:]
        return self.conv_out(silu(self.conv_norm_out(h)))
