"""The work a batch of the cell's traffic needs, counted from shapes by
walking the reference on the meta device, and the least time the card
could take for it (the roofline bounds).

Counts are of the model's work, whatever kernel runs it: 2 operations per
multiply-add of every convolution, linear and attention product; each
input byte read once and each output byte written once.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark.reference import model as M

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _nets(cfg: dict, work: M.Work):
    vq = M.Quant("conv") if cfg["vae_impl"] == "int8" else None
    uq = M.Quant("linear") if cfg["unet_int8"] else None
    return M.Net(quant=uq, work=work), M.Net(quant=vq, work=work)


@dataclass
class Shapes:
    """What a kind's `count` needs: the model nets that record into `work`,
    the configuration's sizes and the traffic's batch on the meta device."""

    cfg: dict
    traffic: dict
    work: M.Work
    unet: M.Net
    vae: M.Net
    b: int              # batch
    n: int              # shots
    r: int              # image size
    h: int              # latent size
    ctx: torch.Tensor   # the text context
    added: object       # the UNet's added conditioning, or None
    t: int              # the timestep

    def meta(self, *shape) -> torch.Tensor:
        return _meta(*shape)


def conditioning(cfg: dict, padded: bool) -> tuple:
    """(context, added) of the empty prompt (`M.conditioning`), its ids
    padded to the towers' length where `padded`, on the meta device."""
    return M.conditioning({k: M.Net() for k in M.TOWERS if k in cfg}, cfg, padded, "meta")


def batch_work(cfg: dict, traffic: dict, root=None) -> M.Work:
    """Operations and bytes of one batch of `traffic` under `cfg`, as its
    kind counts them."""
    from benchmark import kinds

    vc = cfg["vae"]
    work = M.Work(elt=torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8)
    unet, vae = _nets(cfg, work)
    r = cfg["resolution"]
    s = Shapes(cfg, traffic, work, unet, vae, traffic["batch"], traffic["shots"], r,
               r // 2 ** (len(vc["block_out_channels"]) - 1), *conditioning(cfg, False),
               cfg["scheduler"]["timestep"])
    kinds.load(traffic["mode"], root).count(s)
    return work


def attention_bound_s(site, elt: int) -> float:
    """Least time of one flash attention launch (B, H, Sq, Skv, d): Q, K, V
    read and O written in the compute type, the f32 log-sum-exp written."""
    b, h, sq, skv, d = site
    flops = 4.0 * b * h * sq * skv * d
    nbytes = (2 * b * sq * h * d + 2 * b * skv * h * d) * elt + 4 * b * sq * h
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def attention_bwd_bound_s(site, elt: int) -> float:
    """Least time of one flash attention backward (B, H, Sq, Skv, d), as
    its two kernels: dQ (6 operations per multiply position) and dK, dV
    (8); each reads Q, K, V, dO and the f32 log-sum-exp and δ, dQ writes
    dQ, dK-dV writes dK and dV."""
    b, h, sq, skv, d = site
    reads = (2 * b * sq * h * d + 2 * b * skv * h * d) * elt + 2 * 4 * b * sq * h
    dq = max(6.0 * b * h * sq * skv * d / PEAKS["bf16_flops"],
             (reads + b * sq * h * d * elt) / PEAKS["hbm_bytes_per_s"])
    dkv = max(8.0 * b * h * sq * skv * d / PEAKS["bf16_flops"],
              (reads + 2 * b * skv * h * d * elt) / PEAKS["hbm_bytes_per_s"])
    return dq + dkv


def gn_silu_bound_s(elements: int, elt: int) -> float:
    """Least time of one GroupNorm+SiLU: read x, write y."""
    return 2.0 * elements * elt / PEAKS["hbm_bytes_per_s"]


def int8_conv_bound_s(site, elt: int) -> float:
    """Least time of one int8 3x3 convolution (B, H, W, Cin, Cout, Ho, Wo):
    int8 activations and weights read, the output written in the compute
    type, per-channel scale and bias read."""
    b, hh, ww, cin, cout, ho, wo = site
    ops = 2.0 * b * ho * wo * cout * cin * 9
    nbytes = b * hh * ww * cin + cout * 9 * cin + b * ho * wo * cout * elt + 8 * cout
    return max(ops / PEAKS["int8_ops"], nbytes / PEAKS["hbm_bytes_per_s"])


def step_bound_s(work: M.Work) -> float:
    """Least time of the whole batch's products at the card's peaks: the
    int8 part at the int8 rate, the rest at the bf16 rate."""
    return ((work.flops - work.int8_ops) / PEAKS["bf16_flops"]
            + work.int8_ops / PEAKS["int8_ops"])
