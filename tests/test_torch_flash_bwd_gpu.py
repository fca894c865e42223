"""The CUDA flash-attention backward kernels against their plain version.

dq and dkv kernels on the card against `flash_attention_bwd_reference` on
the same inputs (the kernel forward's O and LSE, a random output gradient):
prime and ragged extents, every backward head dim, f32 and bf16, masks that
empty whole tiles, a row with no valid key, exact-zero gradients for masked
keys, run-to-run determinism, the refusals where a call would return no
gradient (d = 512, `flash_attention_lse`), and autograd end to end through
`fused_kv_attention`.  Around the bf16 wgmma kernels' tiles (dq: 128 query
rows, 128-key tiles; dkv: 128 keys, 64-row q-tiles): extents off those
multiples, one-tile grids, 128-key tiles wholly masked in the shot
pattern, extents whose walks split over several CTAs (f32 partials added
in a fixed order), bit-identical repeats, and padded keys whose content
changes no bit (the padded call equals the cut call).  Tolerance relative to
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


# (B, H, Sq, Skv): off the tile multiples, one-tile grids, and walks that
# split (few CTAs, long walks: dq and dkv write f32 partials)
TILE_CASES = [(2, 3, 300, 384), (2, 3, 384, 300), (1, 2, 64, 128), (3, 1, 128, 64),
              (1, 1, 256, 2048), (1, 2, 1000, 256), (1, 1, 2048, 200), (2, 5, 129, 65)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("b,h,sq,skv", TILE_CASES)
def test_tiles(cuda, dtype, d, b, h, sq, skv):
    args = _case(b, sq, skv, h, d, dtype, sq + 3 * skv + d, cuda)
    got, want = _run(*args, None)
    _close(got, want, dtype)


def _shot_mask(b, n, s, padded, device):
    """[own ‖ n shots] of s keys each, the last `padded` shots masked."""
    mask = torch.ones((b, (1 + n) * s), dtype=torch.bool, device=device)
    mask[:, (1 + n - padded) * s:] = False
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("pattern", ["shots", "middle_tiles", "partial_tiles", "empty_row"])
def test_masked_tiles(cuda, dtype, d, pattern):
    """Whole 128-key tiles masked (skipped by dq's producer, zeros from
    dkv's CTAs), masks set partly inside a tile, a batch row with no valid
    key; masked keys' dK and dV exactly zero."""
    b, h, sq = 2, 2, 256
    gen = torch.Generator(device=cuda).manual_seed(31)
    if pattern == "shots":  # 5 shots of 512 keys, the last 2 padded: dq's last split all masked
        mask = _shot_mask(b, 5, 512, 2, cuda)
    else:
        mask = torch.ones((b, 1152), dtype=torch.bool, device=cuda)
        if pattern == "middle_tiles":  # tiles 2-4 wholly masked, tile 5 half
            mask[:, 256:704] = False
        elif pattern == "partial_tiles":  # every tile partly set
            mask &= torch.rand(mask.shape, generator=gen, device=cuda) > 0.7
            mask[:, 0] = True
        elif pattern == "empty_row":
            mask[1] = False
            mask[0, 500:] = False
    args = _case(b, sq, mask.shape[1], h, d, dtype, 17, cuda, mask)
    got, want = _run(*args, mask)
    _close(got, want, dtype)
    dq, dk, dv = got
    dead = ~mask[:, :, None, None].expand_as(dk)
    assert torch.all(dk[dead] == 0) and torch.all(dv[dead] == 0)
    if pattern == "empty_row":
        assert torch.all(dq[1] == 0)


@pytest.mark.parametrize("b,h,sq,skv", [(1, 1, 256, 2048), (2, 3, 333, 515), (1, 5, 1024, 4096),
                                        (1, 2, 4096, 256)])
def test_bf16_repeats_bit_identical(cuda, b, h, sq, skv):
    """Split and unsplit walks alike: two runs give the same bits."""
    mask = torch.ones((b, skv), dtype=torch.bool, device=cuda)
    mask[:, skv * 3 // 4:] = False
    args = _case(b, sq, skv, h, 64, torch.bfloat16, 9, cuda, mask)
    a, _ = _run(*args, mask)
    r, _ = _run(*args, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("valid", [300, 384 - 1])
def test_padded_keys_change_no_bit(cuda, dtype, d, valid):
    """384 keys of which the tail is masked: dq, and dk / dv of the valid
    keys, equal the call cut to the valid keys bit for bit, whatever the
    padded keys hold; the padded keys' dk and dv are zero."""
    b, h, sq, skv = 2, 3, 200, 384
    gen = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda s: torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    q, k, v, go = mk(sq), mk(skv), mk(skv), mk(sq)
    mask = torch.zeros((b, skv), dtype=torch.bool, device=cuda)
    mask[:, :valid] = True
    scale = d ** -0.5
    out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
    padded = flash_attention_bwd(q, k, v, out, lse, go, scale=scale, kv_mask=mask)
    k2, v2 = k.clone(), v.clone()
    k2[:, valid:], v2[:, valid:] = mk(skv - valid), mk(skv - valid)
    out2, lse2 = flash_attention_lse(q, k2, v2, kv_mask=mask)
    other = flash_attention_bwd(q, k2, v2, out2, lse2, go, scale=scale, kv_mask=mask)
    kc, vc = k[:, :valid].contiguous(), v[:, :valid].contiguous()
    outc, lsec = flash_attention_lse(q, kc, vc)
    cut = flash_attention_bwd(q, kc, vc, outc, lsec, go, scale=scale)
    assert all(torch.equal(x, y) for x, y in zip(padded, other))
    assert torch.equal(padded[0], cut[0])
    assert torch.equal(padded[1][:, :valid], cut[1]) and torch.equal(padded[2][:, :valid], cut[2])
    assert torch.all(padded[1][:, valid:] == 0) and torch.all(padded[2][:, valid:] == 0)


def test_bwd_info(cuda):
    """The bf16 kernels' resources: 384 threads, dynamic shared memory
    within the card's 227 KB."""
    import ctypes

    from diffews_tpu_torch.ops import _build

    lib = _build.load("flash_attention_bwd")
    for d in (16, 32, 64):
        for kind in (0, 1):
            regs, smem, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            assert lib.flash_attention_bwd_info(d, kind, ctypes.byref(regs), ctypes.byref(smem),
                                                ctypes.byref(threads)) == 0
            assert threads.value == 384 and 0 < smem.value <= 232448 and regs.value > 0
