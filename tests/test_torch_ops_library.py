"""The port's forward kernels as torch custom ops (`torch.ops.diffews_tpu_torch`).

Each op (the int8 conv writing f32 and bf16), on the CPU, in f32 and bf16: `torch.library.opcheck` (schema,
fake implementation against the real one, strides included, autograd
registration, AOT dispatch) passes, and its result equals its plain
version's bit for bit, with contiguous outputs.  The CUDA implementation of
each op is the kernel's launcher; it is held against the same plain
versions on the card (`tests/test_torch_serve_gpu.py`, `chip_smoke.py`).
The optimizer's two ops (`ops/adamw.py`) run on CUDA tensors only and are
held against their plain version on the card (`tests/test_torch_adamw_gpu.py`).
"""

import numpy as np
import pytest
import torch

from diffews_tpu_torch.ops import (adamw, downsample, flash_attention, fused_resnet,  # noqa: F401
                                   groupnorm, quant)
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

OPS = torch.ops.diffews_tpu_torch


def _r(*shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                            .astype(np.float32)).to(dtype)


def _cases(dt):
    """name -> (op, args, plain version of the same call)."""
    q, k, v = _r(2, 8, 2, 16, seed=0, dtype=dt), _r(2, 12, 2, 16, seed=1, dtype=dt), \
        _r(2, 12, 2, 16, seed=2, dtype=dt)
    mask = torch.from_numpy(np.random.default_rng(3).random((2, 12)) > 0.3)
    x = _r(2, 4, 6, 16, seed=4, dtype=dt)
    a, b = _r(2, 16, seed=5, dtype=dt), _r(2, 16, seed=6, dtype=dt)
    a32, b32 = _r(2, 16, seed=7), _r(2, 16, seed=8)
    w, bias = _r(8, 16, 3, 3, seed=9, dtype=dt), _r(8, seed=10)
    w_sq, res = _r(16, 16, 3, 3, seed=11, dtype=dt), _r(2, 4, 6, 16, seed=12, dtype=dt)
    s_a = quant.static_s_a(2.0)
    xq = quant.quantize_s8_reference(x, s_a)
    w8, s_w = quant.quantize_weight(w.permute(0, 2, 3, 1), (1, 2, 3))
    fa = lambda m: lambda: flash_attention.flash_attention_reference(q, k, v, scale=0.25,
                                                                     kv_mask=m)
    return {
        "flash_attention_fwd": (OPS.flash_attention_fwd, (q, k, v, mask, 0.25), fa(mask)),
        "flash_attention_fwd_no_mask": (OPS.flash_attention_fwd, (q, k, v, None, 0.25),
                                        fa(None)),
        "gn_stats": (OPS.gn_stats, (x,), lambda: fused_resnet.gn_stats(x)),
        "gn_apply_silu": (OPS.gn_apply, (x, a, b, "silu"),
                          lambda: groupnorm.gn_apply_reference(x, a, b, "silu")),
        "gn_apply_none": (OPS.gn_apply, (x, a, b, "none"),
                          lambda: groupnorm.gn_apply_reference(x, a, b, "none")),
        "fused_gn_silu_conv3x3": (
            OPS.fused_gn_silu_conv3x3, (x, a32, b32, w, bias, None),
            lambda: fused_resnet.gn_silu_conv3x3_reference(x, a32, b32, w, bias)),
        "fused_gn_silu_conv3x3_residual": (
            OPS.fused_gn_silu_conv3x3, (x, a32, b32, w_sq, bias.repeat(2), res),
            lambda: fused_resnet.gn_silu_conv3x3_reference(x, a32, b32, w_sq,
                                                           bias.repeat(2), res)),
        "downsample_conv2x": (OPS.downsample_conv2x, (x, w, bias),
                              lambda: downsample.downsample_conv2x_reference(x, w, bias)),
        "quantize_s8": (OPS.quantize_s8, (x, s_a),
                        lambda: quant.quantize_s8_reference(x, s_a)),
        "conv2d_int8": (OPS.conv2d_int8, (xq, w8, s_w, s_a, bias, 1, [1, 1, 1, 1], dt),
                        lambda: quant.conv2d_int8_reference(xq, w8, s_w, s_a, bias, 1, 1, dt)),
        "conv2d_int8_encoder_down_no_bias": (
            OPS.conv2d_int8, (xq, w8, s_w, s_a, None, 2, [0, 1, 0, 1], dt),
            lambda: quant.conv2d_int8_reference(xq, w8, s_w, s_a, None, 2, ((0, 1), (0, 1)),
                                                dt)),
    }


CASES = sorted(_cases(torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_op_opcheck_and_plain_version(case, dtype):
    op, args, plain = _cases(dtype)[case]
    torch.library.opcheck(op, args)
    got, want = op(*args), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_every_forward_kernel_has_one_op():
    names = {n for n in dir(OPS) if not n.startswith("_") and n != "name"}
    assert names == {"flash_attention_fwd", "gn_stats", "gn_apply",
                     "fused_gn_silu_conv3x3", "downsample_conv2x", "quantize_s8", "conv2d_int8",
                     "adamw_norm", "adamw_apply"}
