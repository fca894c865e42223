"""The CUDA GroupNorm kernels (stats, apply) against their plain version,
on the card.

Small, ragged and full widths, f32 (TF32 off) and bf16, with and without
SiLU; statistics against plain sums; the apply kernel bit for bit against
`x * a + b` where both get the same a and b; bit-identical repeats; a row's
output independent of the other rows; inputs the kernels do not take
raise.  Tolerances: f32 max |kernel − plain| ≤ 1e-4·max|plain|; bf16 max
≤ 2e-2·max|plain| and mean ≤ 2e-3·max|plain| (A and B round to bf16 from
statistics summed in another order); statistics 1e-5 of Σ|x| and Σx².
Marked `gpu`: each test skips without a CUDA device.  This file imports
no JAX (the GPU host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_groupnorm_gpu.py
"""

import pytest
import torch

from diffews_tpu_torch.ops import groupnorm as G

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    w = (torch.rand((c,), generator=g, device=device) + 0.5).to(dtype)
    b = (torch.randn((c,), generator=g, device=device) * 0.1).to(dtype)
    return x, w, b


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * top, (err.max().item(), top)
    else:
        assert err.max().item() <= 2e-2 * top and err.mean().item() <= 2e-3 * top, (
            err.max().item(), err.mean().item(), top)


SHAPES = [  # (B, H, W, C, groups)
    (2, 8, 8, 32, 8), (3, 5, 7, 40, 8), (1, 3, 3, 6, 3), (2, 4, 4, 12, 4), (1, 1, 1, 16, 8),
    (8, 64, 64, 320, 32), (8, 16, 16, 1920, 32), (8, 8, 8, 2560, 32), (8, 64, 64, 960, 32),
    (4, 512, 512, 128, 32), (12, 64, 64, 512, 32)]


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_plain_version(cuda, shape, dtype, act):
    *dims, groups = shape
    x, w, b = _inputs(tuple(dims), dtype, sum(shape), cuda)
    before = (G.gn_stats_kernel.launches, G.gn_apply_kernel.launches)
    got = G.group_norm_act(x, w, b, groups=groups, eps=1e-6, act=act)
    assert (G.gn_stats_kernel.launches, G.gn_apply_kernel.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want = G.group_norm_act_reference(x, w, b, groups=groups, eps=1e-6, act=act)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (3, 5, 7, 40), (1, 3, 3, 6), (12, 256, 256, 128),
                                   (8, 32, 32, 1920)], ids=str)
def test_stats_match_plain_sums(cuda, shape, dtype):
    x, _, _ = _inputs(shape, dtype, 3, cuda)
    s1, s2 = G.gn_stats_kernel(x)
    xf = x.double()
    want1, want2 = xf.sum((1, 2)), xf.square().sum((1, 2))
    assert ((s1.double() - want1).abs() <= 1e-5 * xf.abs().sum((1, 2)) + 1e-6).all()
    assert ((s2.double() - want2).abs() <= 1e-5 * want2 + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 40, 6, 3, 960])
def test_apply_rounds_like_the_torch_ops(cuda, dtype, c):
    """Given the same a and b, `x·a + b` is the plain version's two torch
    ops bit for bit (product rounded, then the sum; no FMA)."""
    x, _, _ = _inputs((3, 9, 11, c), dtype, 4, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    a = (torch.rand((3, c), generator=g, device=cuda) * 3 - 1).to(dtype)
    b = torch.randn((3, c), generator=g, device=cuda).to(dtype)
    got = G.gn_apply_kernel(x, a, b)
    assert torch.equal(got, x * a[:, None, None, :] + b[:, None, None, :])
    silu = G.gn_apply_kernel(x, a, b, act="silu")
    want = torch.nn.functional.silu(x * a[:, None, None, :] + b[:, None, None, :])
    _close(silu, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeat_is_bit_identical_and_rows_are_independent(cuda, dtype):
    x, w, b = _inputs((6, 64, 64, 320), dtype, 6, cuda)
    run = lambda t: G.group_norm_act(t, w, b, groups=32, eps=1e-6, act="silu")
    y1, y2 = run(x), run(x)
    assert torch.equal(y1, y2)
    other = x.clone()
    other[1:] = -3.0 * other[1:].flip(1) + 1.0
    assert torch.equal(run(other)[0], y1[0])


def test_rejects_what_the_kernels_do_not_take(cuda):
    x, w, b = _inputs((2, 8, 8, 32), torch.float32, 7, cuda)
    nchw = torch.randn((2, 32, 8, 8), device=cuda).permute(0, 2, 3, 1)  # not contiguous NHWC
    with pytest.raises(ValueError, match="contiguous"):
        G.group_norm_act(nchw, w, b, groups=8, eps=1e-6)
    with pytest.raises(TypeError):
        G.group_norm_act(x.half(), w, b, groups=8, eps=1e-6)
    a = torch.ones((2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        G.gn_apply_kernel(x, a, a)


def test_gradients_on_the_card_match_the_plain_formula(cuda):
    x, w, b = _inputs((2, 16, 16, 64), torch.float32, 8, cuda)
    ts = [t.clone().requires_grad_() for t in (x, w, b)]
    rs = [t.clone().requires_grad_() for t in (x, w, b)]
    g = torch.randn(x.shape, device=cuda)
    (G.group_norm_act(*ts, groups=8, eps=1e-6, act="silu") * g).sum().backward()
    (G.group_norm_act_reference(*rs, groups=8, eps=1e-6, act="silu") * g).sum().backward()
    for t, r in zip(ts, rs):
        assert (t.grad - r.grad).abs().max().item() <= 1e-4 * r.grad.abs().max().item()
