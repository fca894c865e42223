"""The CUDA flash-attention backward kernels against their plain version.

dq and dkv kernels on the card against `flash_attention_bwd_reference` on
the same inputs (the kernel forward's O and LSE, a random output gradient):
prime and ragged extents, every backward head dim, f32 and bf16, masks that
empty whole tiles, a row with no valid key, exact-zero gradients for masked
keys, run-to-run determinism, the refusals where a call would return no
gradient (d = 512, `flash_attention_lse`), and autograd end to end through
`fused_kv_attention`.  Tolerance relative to
max |reference|: f32 1e-4, bf16 3e-2.  Marked `gpu`: each test skips
without a CUDA device.  No JAX (the GPU host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd_gpu.py
"""

import pytest
import torch

from diffews_tpu_torch.ops.attention import fused_kv_attention
from diffews_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                   flash_attention_bwd_reference,
                                                   flash_attention_lse)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(b, sq, skv, h, d, dtype, seed, device, mask=None):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda s: torch.randn((b, s, h, d), generator=g, device=device).to(dtype)
    q, k, v, go = mk(sq), mk(skv), mk(skv), mk(sq)
    out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
    return q, k, v, out, lse, go


def _close(got, want, dtype):
    """Within TOL of max |reference|; a gradient that is zero up to
    rounding (one key: p = 1, dp = delta) is held to TOL·1e-2."""
    for a, r in zip(got, want):
        assert a.dtype == dtype and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= TOL[dtype] * max(r.float().abs().max().item(), 1e-2), err


def _run(q, k, v, out, lse, go, mask):
    scale = q.shape[-1] ** -0.5
    got = flash_attention_bwd(q, k, v, out, lse, go, scale=scale, kv_mask=mask)
    want = flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                         out.float(), lse, go.float(), scale)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,d", [
    (1, 1, 64), (97, 101, 64), (64, 128, 64), (129, 257, 16), (61, 127, 32),
    (200, 64, 32), (65, 63, 16)])
def test_matches_plain_version(cuda, dtype, sq, skv, d):
    args = _case(2, sq, skv, 3, d, dtype, sq * 7 + skv, cuda)
    dq0 = flash_attention_bwd.dq_launches
    dkv0 = flash_attention_bwd.dkv_launches
    got, want = _run(*args, None)
    assert flash_attention_bwd.dq_launches == dq0 + 1
    assert flash_attention_bwd.dkv_launches == dkv0 + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", ["random", "tail_tiles", "head_tiles", "empty_row"])
@pytest.mark.parametrize("d", [16, 64])
def test_masked(cuda, dtype, pattern, d):
    b, sq, skv, h = 2, 77, 301, 2
    gen = torch.Generator(device=cuda).manual_seed(12)
    mask = torch.rand((b, skv), generator=gen, device=cuda) > 0.4
    if pattern == "tail_tiles":   # whole trailing KV tiles masked (padded shots)
        mask[:, 100:] = False
    elif pattern == "head_tiles":  # masked tiles before any valid key
        mask[:, :200] = False
    elif pattern == "empty_row":   # batch row 1 has no valid key: LSE = -inf
        mask[1] = False
    args = _case(b, sq, skv, h, d, dtype, 11, cuda, mask)
    got, want = _run(*args, mask)
    _close(got, want, dtype)
    dq, dk, dv = got
    dead = ~mask[:, :, None, None].expand_as(dk)
    assert torch.all(dk[dead] == 0) and torch.all(dv[dead] == 0)
    if pattern == "empty_row":
        assert torch.all(dq[1] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deterministic(cuda, dtype):
    """No atomics: two runs give the same bits."""
    mask = torch.ones((2, 515), dtype=torch.bool, device=cuda)
    mask[:, 300:] = False
    args = _case(2, 333, 515, 2, 64, dtype, 5, cuda, mask)
    a, _ = _run(*args, mask)
    b, _ = _run(*args, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_refuses_what_has_no_gradient(cuda):
    q = torch.randn((1, 8, 1, 512), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="backward"):
        flash_attention(q, q, q)
    with torch.no_grad():  # the frozen VAE's d = 512 runs without grad
        flash_attention(q, q, q)
    x = torch.randn((1, 8, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_lse(x, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_fused_kv_attention(cuda, dtype):
    """Gradients reach q, k and v through the kernel path and agree with
    autograd through the dense path (padded shot and additive key bias)."""
    b, n, s, h, d = 2, 3, 70, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=cuda).to(dtype).requires_grad_()
    q, ko, vo = mk(b, s, h, d), mk(b, s, h, d), mk(b, s, h, d)
    ks, vs = mk(b, n, s, h, d), mk(b, n, s, h, d)
    shot_mask = torch.tensor([[True, True, False], [True, True, True]], device=cuda)
    bias = (torch.rand((b, n * s), generator=gen, device=cuda) > 0.3).float() * -1e4
    go = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    grads = {}
    for impl in ("flash", "dense"):
        out = fused_kv_attention(q, ko, vo, ks, vs, shot_mask=shot_mask, support_bias=bias,
                                 impl=impl)
        grads[impl] = torch.autograd.grad(out, (q, ko, vo, ks, vs), go)
    for a, r in zip(grads["flash"], grads["dense"]):
        assert a is not None and torch.isfinite(a.float()).all()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= TOL[dtype] * r.float().abs().max().item(), err
    # the padded shot's keys and values get no gradient at all
    assert torch.all(grads["flash"][3][0, 2] == 0) and torch.all(grads["flash"][4][0, 2] == 0)
