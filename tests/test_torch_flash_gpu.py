"""The CUDA flash-attention kernel against its plain version, on the card.

Ragged, prime and tiny extents, every built head dim, masks that empty
whole KV tiles, and a row with no valid key.  The bf16 kernels tile 128
queries x 128 keys (d <= 64) and 64 x 64 (d = 512) and skip KV tiles whose
keys are all masked: the extents straddle those tiles, batch rows with
different masks skip different tiles, and a mask that empties the trailing
tiles must equal the call cut to the valid keys, bit for bit.  Marked `gpu`: each test skips
without a CUDA device.  This file imports no JAX (the GPU host has none);
run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_flash_gpu.py
"""

import pytest
import torch

from diffews_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_lse,
                                                   flash_attention_reference)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, sq, skv, h, d, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda s: torch.randn((b, s, h, d), generator=g, device=device).to(dtype)
    return mk(sq), mk(skv), mk(skv)


def _check(out, lse, ref_o, ref_l, dtype):
    err = (out.float() - ref_o).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-4
    else:  # bf16 output rounding of an f32 computation
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    fin = torch.isfinite(ref_l)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (lse[fin] - ref_l[fin]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,d", [
    (1, 1, 64), (97, 101, 64), (64, 128, 64), (129, 257, 16), (61, 127, 32),
    (33, 17, 512), (130, 70, 512)])
def test_matches_plain_version(cuda, dtype, sq, skv, d):
    q, k, v = _inputs(2, sq, skv, 3 if d < 512 else 1, d, dtype, sq * 7 + skv, cuda)
    before = flash_attention.launches
    out, lse = flash_attention_lse(q, k, v)
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == q.shape[:3]
    ref_o, ref_l = flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=None)
    _check(out, lse, ref_o, ref_l, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", ["random", "tail_tiles", "head_tiles", "empty_row"])
@pytest.mark.parametrize("d", [64, 512])
def test_masked(cuda, dtype, pattern, d):
    b, sq, skv, h = 2, 77, 301, 2 if d < 512 else 1
    q, k, v = _inputs(b, sq, skv, h, d, dtype, 11, cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    mask = torch.rand((b, skv), generator=g, device=cuda) > 0.4
    if pattern == "tail_tiles":   # whole trailing KV tiles masked (padded shots)
        mask[:, 100:] = False
    elif pattern == "head_tiles":  # masked tiles before any valid key
        mask[:, :200] = False
    elif pattern == "empty_row":   # batch row 1 has no valid key: O = 0, LSE = -inf
        mask[1] = False
    out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
    ref_o, ref_l = flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=mask)
    assert torch.isfinite(out.float()).all()
    _check(out, lse, ref_o, ref_l, dtype)


def test_rejects_unbuilt_head_dim(cuda):
    q = torch.zeros((1, 8, 1, 80), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("d", [16, 32, 64, 512])
@pytest.mark.parametrize("skv", [1, 127, 129, 4095])
@pytest.mark.parametrize("sq", [1, 63, 127, 128, 129, 4097])
def test_extents_around_tiles(cuda, sq, skv, d):
    h = 5 if d == 64 else (2 if d < 512 else 1)  # H = 5: a 640-byte row stride at d = 64
    q, k, v = _inputs(2, sq, skv, h, d, torch.bfloat16, sq * 31 + skv + d, cuda)
    out, lse = flash_attention_lse(q, k, v)
    ref_o, ref_l = flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=None)
    _check(out, lse, ref_o, ref_l, torch.bfloat16)


def _tile_mask(pattern, b, skv, device):
    """(B, Skv) masks over 1024 keys: whole 128-key tiles (two 64-key tiles
    at d = 512) masked at the head, middle or tail, all but the last key
    masked, or batch row 0 masked in tiles while row 1 keeps every key."""
    g = torch.Generator(device=device).manual_seed(5)
    mask = torch.rand((b, skv), generator=g, device=device) > 0.3
    if pattern == "head":
        mask[:, :384] = False
    elif pattern == "middle":
        mask[:, 256:640] = False
    elif pattern == "tail":
        mask[:, 512:] = False
    elif pattern == "last_key_only":
        mask[:] = False
        mask[:, -1] = True
    elif pattern == "rows_differ":  # row 0 skips tiles, row 1 skips none
        mask[0, 128:512] = False
        mask[0, 768:] = False
        mask[1] = True
    elif pattern == "empty_row":
        mask[0, :256] = False
        mask[1] = False
    return mask


@pytest.mark.parametrize("pattern", ["head", "middle", "tail", "last_key_only",
                                     "rows_differ", "empty_row"])
@pytest.mark.parametrize("d", [16, 32, 64, 512])
def test_masked_tiles_skipped(cuda, pattern, d):
    b, sq, skv, h = 2, 200, 1024, 5 if d == 64 else 1
    q, k, v = _inputs(b, sq, skv, h, d, torch.bfloat16, 21, cuda)
    mask = _tile_mask(pattern, b, skv, cuda)
    out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
    ref_o, ref_l = flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=mask)
    assert torch.isfinite(out.float()).all()
    _check(out, lse, ref_o, ref_l, torch.bfloat16)
    if pattern == "empty_row":
        assert (out[1] == 0).all() and torch.isneginf(lse[1]).all()
    again = flash_attention_lse(q, k, v, kv_mask=mask)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])  # no atomics


@pytest.mark.parametrize("valid", [384, 300])
@pytest.mark.parametrize("d", [16, 32, 64, 512])
def test_padded_tail_equals_cut_call(cuda, valid, d):
    """The padded-shot case: keys past `valid` masked in every batch row give
    the bits of the call whose K and V stop at `valid`."""
    b, sq, skv, h = 2, 150, 1024, 5 if d == 64 else 1
    q, k, v = _inputs(b, sq, skv, h, d, torch.bfloat16, 33, cuda)
    mask = torch.ones((b, skv), dtype=torch.bool, device=cuda)
    mask[:, valid:] = False
    out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
    cut_o, cut_l = flash_attention_lse(q, k[:, :valid].contiguous(), v[:, :valid].contiguous())
    assert torch.equal(out, cut_o) and torch.equal(lse, cut_l)
