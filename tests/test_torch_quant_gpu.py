"""The CUDA int8 kernels (`quantize_s8`, `conv2d_int8`) and the int8
linear's `torch._int_mm` route against their plain versions, on the card,
bit for bit.

The integer sum is exact and the epilogue is the plain version's IEEE
operations in the same order, so every comparison is exact (`torch.equal`).
The conv kernel's tiles are 16 x 16 output pixels, 32 input channels a
chunk and N blocks of 128 channels (8 for Cout <= 8, the heads), walked by
a persistent grid of one CTA an SM (two for the heads); the cases sit
around them: stride 1 and 2; paddings (1,1),(1,1), (0,1),(0,1) (the VAE
encoder's downsample) and 0; Cout 3, 8 (narrow N block), 9, 128 and 136
(past one 128-channel block); Cin 16, 48 and 80 (a 16-channel tail past
the 32-channel chunk), 32, 128 and 512; H and W ragged against the tile
(8, 9, 17, 33, ...); B = 1 up to 13, with more work items than CTAs (more
than one persistent wave, wide and narrow); f32 and bf16; static and
dynamic scales; with and without bias; bit-identical repeats.  Cin 40,
stride 3 and padding 2 raise.  `quantize_s8` at ties
(values at exactly (k + 0.5)·s_a round half to even) and saturation.  The
int8 linear at M <= 16 and at K and N not multiples of 8 (padded for
`torch._int_mm`).  Weights quantized on the card equal the CPU's.
Marked `gpu`: each test skips without a CUDA device.  This file imports no
JAX (the GPU host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_quant_gpu.py
"""

import numpy as np
import pytest
import torch

from diffews_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _conv_inputs(B, H, W, Cin, Cout, dtype, seed, device, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, Cin), generator=g).to(dtype)
    w = torch.randn((Cout, 3, 3, Cin), generator=g) * 0.05
    w8, s_w = Q.quantize_weight(w, (1, 2, 3))
    b = torch.randn((Cout,), generator=g) * 0.1 if bias else None
    to = lambda t: None if t is None else t.to(device)
    return to(x), to(w8), to(s_w), to(b)


PADS = {"same": ((1, 1), (1, 1)), "encoder_down": ((0, 1), (0, 1)), "valid": 0}
SHAPES = [  # (B, H, W, Cin, Cout)
    (1, 8, 8, 32, 8), (3, 13, 21, 32, 3), (2, 17, 9, 48, 128), (1, 33, 47, 128, 128),
    (2, 16, 16, 128, 136), (1, 9, 30, 512, 8), (1, 20, 12, 512, 512), (5, 11, 7, 64, 3),
    # Cin 16 (half a chunk), Cout 9 (just past the narrow block)
    (1, 17, 33, 16, 9),
    # Cin 80 (two chunks and a half), Cout 136
    (2, 8, 17, 80, 136),
    # B = 13: 156 wide items at stride 1 (> 132 CTAs), 325 narrow ones (> 264)
    (13, 64, 48, 32, 128), (13, 80, 80, 16, 8)]


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stride,pad", [(1, "same"), (2, "same"), (2, "encoder_down"),
                                        (1, "valid"), (2, "valid")])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_equals_plain_version(cuda, shape, stride, pad, dtype, static):
    x, w8, s_w, b = _conv_inputs(*shape, dtype, sum(shape) + stride, cuda)
    padding = PADS[pad]
    s_a = Q.static_s_a(2.5, cuda) if static else None
    before = (Q.conv2d_int8.launches, Q.quantize_s8.launches)
    y = Q.conv2d_int8(x, w8, s_w, b, s_a=s_a, stride=stride, padding=padding)
    assert (Q.conv2d_int8.launches, Q.quantize_s8.launches) == (before[0] + 1, before[1] + 1)
    s = Q.dynamic_s_a(x) if s_a is None else s_a
    xq = Q.quantize_s8_reference(x, s)
    want = Q.conv2d_int8_reference(xq, w8, s_w, s, b, stride, padding, dtype)
    assert y.dtype == dtype and y.is_contiguous() and y.shape == want.shape
    assert torch.isfinite(y.float()).all()
    assert torch.equal(y, want), (y.float() - want.float()).abs().max().item()
    assert torch.equal(y, Q.conv2d_int8(x, w8, s_w, b, s_a=s_a, stride=stride,
                                        padding=padding))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cout", [8, 128], ids=["narrow", "wide"])
def test_conv_without_bias(cuda, cout, dtype):
    x, w8, s_w, _ = _conv_inputs(2, 10, 14, 32, cout, dtype, 7, cuda, bias=False)
    s = Q.static_s_a(1.5, cuda)
    y = Q.conv2d_int8(x, w8, s_w, None, s_a=s)
    want = Q.conv2d_int8_reference(Q.quantize_s8_reference(x, s), w8, s_w, s, None, 1,
                                   ((1, 1), (1, 1)), dtype)
    assert torch.equal(y, want)


def test_conv_at_the_vae_width(cuda):
    """B = 4, 128² x 128 -> 128 bf16: many tiles, every CTA busy."""
    x, w8, s_w, b = _conv_inputs(4, 128, 128, 128, 128, torch.bfloat16, 11, cuda)
    s = Q.static_s_a(3.0, cuda)
    y = Q.conv2d_int8(x, w8, s_w, b, s_a=s)
    want = Q.conv2d_int8_reference(Q.quantize_s8_reference(x, s), w8, s_w, s, b, 1,
                                   ((1, 1), (1, 1)), torch.bfloat16)
    assert torch.equal(y, want)


def test_unsupported_inputs_raise(cuda):
    x, w8, s_w, b = _conv_inputs(1, 8, 8, 40, 8, torch.float32, 1, cuda)
    with pytest.raises(ValueError, match="Cin % 16"):
        Q.conv2d_int8(x, w8, s_w, b)
    x, w8, s_w, b = _conv_inputs(1, 8, 8, 32, 8, torch.float32, 1, cuda)
    with pytest.raises(ValueError, match="stride"):
        Q.conv2d_int8(x, w8, s_w, b, stride=3)
    with pytest.raises(ValueError, match="padding"):
        Q.conv2d_int8(x, w8, s_w, b, padding=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        Q.quantize_s8(x.half(), Q.static_s_a(1.0, cuda))
    with pytest.raises(ValueError, match="contiguous"):
        Q.quantize_s8(x.permute(0, 2, 1, 3), Q.static_s_a(1.0, cuda))
    with pytest.raises(ValueError, match="is on"):
        Q.conv2d_int8(x, w8.cpu(), s_w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 4097, 1 << 20])
def test_quantize_equals_plain_version_at_ties(cuda, dtype, n):
    """(k + 0.5)·s_a for s_a = 0.5 and |k + 0.5| <= 127.5 is exact in both
    dtypes: round half to even, then clip at ±127 (127.5 rounds to 128)."""
    s = torch.full((), 0.5, device=cuda)
    k = torch.arange(n, device=cuda) % 255 - 127
    x = ((k.float() + 0.5) * 0.5).to(dtype)
    x[::3] = -x[::3]
    before = Q.quantize_s8.launches
    got = Q.quantize_s8(x, s)
    assert Q.quantize_s8.launches == before + 1
    want = Q.quantize_s8_reference(x, s)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    # an even k + 0.5 rounds down in magnitude, an odd one up
    r = torch.round(k.float() + 0.5).clamp(-127, 127)
    assert torch.equal(want[1::3].cpu(), r[1::3].to(torch.int8).cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_random_and_dynamic(cuda, dtype):
    x = (torch.randn((3, 37, 41, 64), device=cuda) * 3).to(dtype)
    for s in (Q.dynamic_s_a(x), Q.static_s_a(4.0, cuda), Q.static_s_a(1e-20, cuda)):
        assert torch.equal(Q.quantize_s8(x, s), Q.quantize_s8_reference(x, s))


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (16, 64, 96), (17, 64, 96), (5, 36, 50),
                                   (300, 320, 320), (64, 1280, 5120), (33, 20, 3)])
def test_linear_equals_plain_version(cuda, m, k, n, dtype, static):
    """`torch._int_mm` needs M > 16 and K, N multiples of 8: the wrapper pads
    with zeros, which changes no sum."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g).to(dtype).to(cuda)
    w8, s_w = Q.quantize_weight(torch.randn((n, k), generator=g) * 0.05, (1,))
    b = torch.randn((n,), generator=g) * 0.1
    w8, s_w, b = w8.to(cuda), s_w.to(cuda), b.to(cuda)
    s_a = Q.static_s_a(3.0, cuda) if static else None
    before = Q.linear_int8.launches
    y = Q.linear_int8(x, w8, s_w, b, s_a=s_a)
    assert Q.linear_int8.launches == before + 1
    s = Q.dynamic_s_a(x) if s_a is None else s_a
    want = Q._dequant(Q._int_mm_reference(Q.quantize_s8_reference(x, s), w8), s_w, s, b,
                      dtype)
    assert y.shape == (m, n) and torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_weights_quantized_on_the_card_equal_the_cpu(cuda, dtype):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(128, 3, 3, 256)).astype(np.float32) * 0.02).to(dtype)
    w[5] = 0.0  # a zero channel: s_w = 1e-12
    got = Q.quantize_weight(w.to(cuda), (1, 2, 3))
    want = Q.quantize_weight(w, (1, 2, 3))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
