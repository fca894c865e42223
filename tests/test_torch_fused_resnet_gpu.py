"""The CUDA fused GroupNorm-apply + SiLU + 3x3 conv kernel against its
plain version, on the card.

Small, ragged (H and W not multiples of the 16 x 16 bf16 tile or the 8 x
16 f32 tile, in both extents; Cin = 8, 24, 72 and others not multiples of
the 32-channel chunk; Cout = 136 and 520, not multiples of the 128-channel
N block; B = 1 and 13) and full widths, Cout = 3 and 8 (the VAE heads),
with and without residual, f32 (TF32 off) and bf16; the
statistics against a fresh sum of the kernel's own output; bit-identical
repeats; a row's output independent of the other rows' content; a call on
all-NaN input leaves nothing behind for the next call (channels past Cin
are zero in both operands); inputs the kernel does not take raise.  Tolerances: f32 max |kernel − plain| ≤
1e-4·max|plain|; bf16 max ≤ 2e-2·max|plain| and mean ≤ 2e-3·max|plain|
(the kernel rounds the activation to bf16 before the product, the plain
version convolves it in f32); statistics 1e-5 of Σ|y| and Σy².
Marked `gpu`: each test skips without a CUDA device.  This file imports
no JAX (the GPU host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_fused_resnet_gpu.py
"""

import pytest
import torch

from diffews_tpu_torch.ops import fused_resnet as FR

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, W, Cin, Cout, res, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=device)
    x = r(B, H, W, Cin).to(dtype)
    a = torch.rand((B, Cin), generator=g, device=device) + 0.5
    b = torch.rand((B, Cin), generator=g, device=device) * 0.6 - 0.3
    w = (r(Cout, Cin, 3, 3) * (1.0 / (3 * Cin ** 0.5))).to(dtype)
    bias = r(Cout) * 0.1
    rr = r(B, H, W, Cout).to(dtype) if res else None
    return x, a, b, w, bias, rr


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * top, (err.max().item(), top)
    else:
        assert err.max().item() <= 2e-2 * top and err.mean().item() <= 2e-3 * top, (
            err.max().item(), err.mean().item(), top)


def _stats_of(y, s1, s2):
    yf = y.double()
    w1, w2 = yf.sum((1, 2)), yf.square().sum((1, 2))
    assert ((s1.double() - w1).abs() <= 1e-5 * yf.abs().sum((1, 2)) + 1e-6).all()
    assert ((s2.double() - w2).abs() <= 1e-5 * w2 + 1e-6).all()


SHAPES = [  # (B, H, W, Cin, Cout, residual)
    (1, 16, 16, 32, 32, True), (2, 13, 20, 16, 32, False), (1, 8, 8, 48, 64, True),
    (2, 32, 32, 16, 16, True), (2, 16, 16, 32, 3, False), (2, 16, 16, 32, 8, False),
    (1, 5, 3, 64, 136, True), (1, 1, 1, 32, 32, False),
    (2, 512, 512, 128, 128, True), (4, 256, 256, 256, 256, True), (4, 64, 64, 512, 512, True),
    (2, 512, 512, 128, 3, False), (4, 64, 64, 512, 8, False), (2, 256, 256, 128, 256, False),
    # the 16 x 16 tile's edges, chunks past Cin, partial N blocks, B = 13
    (13, 17, 35, 24, 136, True), (1, 31, 18, 8, 3, False), (2, 33, 47, 72, 520, True),
    (13, 20, 9, 72, 8, False), (1, 40, 24, 24, 8, True), (13, 16, 16, 8, 136, False),
    (1, 47, 33, 24, 520, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_plain_version(cuda, shape, dtype):
    x, a, b, w, bias, rr = _inputs(*shape, dtype, sum(shape[:5]), cuda)
    before = FR.gn_silu_conv3x3.launches
    y, s1, s2 = FR.gn_silu_conv3x3(x, a, b, w, bias, rr)
    assert FR.gn_silu_conv3x3.launches == before + 1
    want = FR.gn_silu_conv3x3_reference(x, a, b, w, bias, rr)
    assert y.dtype == dtype and y.shape == shape[:3] + (shape[4],) and y.is_contiguous()
    _close(y, want[0], dtype)
    _stats_of(y, s1, s2)
    if dtype == torch.float32:
        _stats_of(want[0], s1, s2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeat_is_bit_identical_and_rows_are_independent(cuda, dtype):
    x, a, b, w, bias, rr = _inputs(3, 64, 48, 128, 128, True, dtype, 9, cuda)
    y1 = FR.gn_silu_conv3x3(x, a, b, w, bias, rr)
    y2 = FR.gn_silu_conv3x3(x, a, b, w, bias, rr)
    assert all(torch.equal(p, q) for p, q in zip(y1, y2))
    xo, ro = x.clone(), rr.clone()
    xo[1:], ro[1:] = -xo[1:].flip(2), ro[1:] * 2.0
    y3 = FR.gn_silu_conv3x3(xo, a, b, w, bias, ro)
    assert all(torch.equal(p[0], q[0]) for p, q in zip(y1, y3))


@pytest.mark.parametrize("cin", [24, 72])
def test_nan_call_leaves_nothing_for_the_next(cuda, cin):
    """A call on all-NaN x, then a call on finite x at a Cin that is not a
    multiple of the channel chunk: the second result is finite and matches
    the plain version (stale shared memory past Cin meets no weight)."""
    x, a, b, w, bias, rr = _inputs(2, 24, 40, cin, 136, True, torch.bfloat16, 14 + cin, cuda)
    FR.gn_silu_conv3x3(torch.full_like(x, float("nan")), a, b, w, bias, rr)
    y, s1, s2 = FR.gn_silu_conv3x3(x, a, b, w, bias, rr)
    _close(y, FR.gn_silu_conv3x3_reference(x, a, b, w, bias, rr)[0], torch.bfloat16)
    _stats_of(y, s1, s2)


def test_image_boundaries_are_padding(cuda):
    """A tile's halo rows at the top and bottom of an image are the conv's
    zero padding, not the neighbouring image's rows: each image alone gives
    its row of the batch bit for bit."""
    x, a, b, w, bias, _ = _inputs(3, 24, 32, 32, 32, False, torch.bfloat16, 10, cuda)
    y = FR.gn_silu_conv3x3(x, a, b, w, bias)[0]
    for i in range(3):
        yi = FR.gn_silu_conv3x3(x[i:i + 1].contiguous(), a[i:i + 1].contiguous(),
                                b[i:i + 1].contiguous(), w, bias)[0]
        assert torch.equal(yi[0], y[i])


def test_rejects_what_the_kernel_does_not_take(cuda):
    x, a, b, w, bias, rr = _inputs(1, 8, 8, 32, 32, True, torch.float32, 11, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        FR.gn_silu_conv3x3(x, a, b, w, bias, rr.permute(0, 2, 1, 3).contiguous().permute(
            0, 2, 1, 3))
    with pytest.raises(ValueError, match="contiguous"):
        FR.gn_silu_conv3x3(torch.randn((1, 32, 8, 8), device=cuda).permute(0, 2, 3, 1),
                           a, b, w, bias)
    with pytest.raises(TypeError):
        FR.gn_silu_conv3x3(x.half(), a, b, w, bias)
    with pytest.raises(ValueError, match="residual"):
        FR.gn_silu_conv3x3(x, a, b, w, bias, rr.bfloat16())
    xb, ab, bb, wb, biasb, _ = _inputs(1, 8, 8, 12, 16, False, torch.bfloat16, 12, cuda)
    with pytest.raises(ValueError, match="Cin"):
        FR.gn_silu_conv3x3(xb, ab, bb, wb, biasb)


def test_gradients_on_the_card_match_the_plain_formula(cuda):
    x, a, b, w, bias, rr = _inputs(1, 16, 16, 32, 32, True, torch.float32, 13, cuda)
    ts = [t.clone().requires_grad_() for t in (x, b, w, rr)]
    rs = [t.clone().requires_grad_() for t in (x, b, w, rr)]
    loss = lambda y, s1, s2: (y ** 2).sum() + 0.1 * s1.sum() + 0.01 * s2.sum()
    loss(*FR.gn_silu_conv3x3(ts[0], a, ts[1], ts[2], bias, ts[3])).backward()
    loss(*FR.gn_silu_conv3x3_reference(rs[0], a, rs[1], rs[2], bias, rs[3])).backward()
    for t, r in zip(ts, rs):
        assert (t.grad - r.grad).abs().max().item() <= 1e-4 * r.grad.abs().max().item()
