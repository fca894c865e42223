"""The CUDA 3x3 stride-2 downsample kernel against its plain version, on
the card.

Small, ragged (output H and W not multiples of the 16 x 16 bf16 tile or
the 8 x 16 f32 tile, in both extents, an odd number of tiles; Cin = 8,
24, 40, 72, not multiples of the 16-channel chunk) and full widths, Cout =
7, 8, 128, 136, 512 and 520 (not multiples of the 128-channel N block),
B = 1, 3 and 13, f32 (TF32 off) and bf16; bit-identical repeats; each
image alone equals its row of the batch (an image's bottom padding row is
never the next image's first row); a call on all-NaN input leaves nothing
behind for the next call;
inputs the kernel does not take raise; the launch counter; gradients on
the card through the autograd Function.  Tolerances: f32 max |kernel −
plain| ≤ 1e-4·max|plain|; bf16 max ≤ 2e-2·max|plain| and mean ≤
2e-3·max|plain| (both sum bf16 products in f32, in another order, and
round once).  Marked `gpu`: each test skips without a CUDA device.  This
file imports no JAX (the GPU host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_downsample_gpu.py
"""

import pytest
import torch

from diffews_tpu_torch.ops import downsample as DS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, W, Cin, Cout, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=device)
    x = r(B, H, W, Cin).to(dtype)
    w = (r(Cout, Cin, 3, 3) * (1.0 / (3 * Cin ** 0.5))).to(dtype)
    return x, w, r(Cout) * 0.1


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * top, (err.max().item(), top)
    else:
        assert err.max().item() <= 2e-2 * top and err.mean().item() <= 2e-3 * top, (
            err.max().item(), err.mean().item(), top)


SHAPES = [  # (B, H, W, Cin, Cout)
    (1, 16, 32, 16, 8), (3, 16, 32, 16, 8), (1, 2, 2, 8, 8), (3, 26, 40, 24, 128),
    (1, 48, 96, 32, 128), (3, 10, 6, 40, 136), (1, 34, 70, 8, 7), (3, 80, 160, 16, 512),
    (1, 64, 64, 128, 512), (3, 512, 512, 128, 128), (1, 512, 512, 128, 128),
    (3, 256, 256, 256, 256), (3, 128, 128, 512, 512),
    # the 16 x 16 tile's edges, chunks past Cin, partial N blocks, B = 13
    (13, 34, 50, 24, 136), (1, 30, 66, 8, 520), (13, 18, 14, 40, 8), (1, 62, 34, 72, 7),
    (13, 32, 32, 24, 520), (1, 66, 98, 40, 136)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_plain_version(cuda, shape, dtype):
    x, w, bias = _inputs(*shape, dtype, sum(shape), cuda)
    before = DS.downsample_conv2x.launches
    y = DS.downsample_conv2x(x, w, bias)
    assert DS.downsample_conv2x.launches == before + 1
    want = DS.downsample_conv2x_reference(x, w, bias)
    assert DS.downsample_conv2x.launches == before + 1   # the plain version launches nothing
    assert y.dtype == dtype and y.is_contiguous()
    assert y.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[4])
    _close(y, want, dtype)
    assert torch.equal(y, DS.downsample_conv2x(x, w, bias, "pallas"))   # and repeats
    assert torch.equal(want, DS.downsample_conv2x(x, w, bias, "xla"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_image_alone_equals_its_batch_row(cuda, dtype):
    """The bottom padding row of image b is zeros, never image b+1's first
    row, and a row's output does not depend on the other rows' content."""
    x, w, bias = _inputs(3, 24, 36, 32, 40, dtype, 10, cuda)
    y = DS.downsample_conv2x(x, w, bias)
    for i in range(3):
        yi = DS.downsample_conv2x(x[i:i + 1].contiguous(), w, bias)
        assert torch.equal(yi[0], y[i])
    xo = x.clone()
    xo[1:] = -xo[1:].flip(2)
    assert torch.equal(DS.downsample_conv2x(xo, w, bias)[0], y[0])


@pytest.mark.parametrize("cin", [24, 40])
def test_nan_call_leaves_nothing_for_the_next(cuda, cin):
    """A call on all-NaN x, then a call on finite x at a Cin that is not a
    multiple of the channel chunk: the second result is finite and matches
    the plain version (stale shared memory past Cin meets no weight)."""
    x, w, bias = _inputs(2, 40, 72, cin, 136, torch.bfloat16, 20 + cin, cuda)
    DS.downsample_conv2x(torch.full_like(x, float("nan")), w, bias)
    _close(DS.downsample_conv2x(x, w, bias), DS.downsample_conv2x_reference(x, w, bias),
           torch.bfloat16)


def test_padding_is_zeros(cuda):
    """With x = 1 and w = 1 an output counts its taps inside the image: 9·Cin
    inside, 6·Cin on the bottom row and right column, 4·Cin in the corner."""
    x = torch.ones((2, 8, 12, 8), device=cuda)
    w = torch.ones((8, 8, 3, 3), device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        y = DS.downsample_conv2x(x.to(dtype), w.to(dtype), torch.zeros(8, device=cuda)).float()
        want = torch.full((2, 4, 6, 8), 72.0, device=cuda)
        want[:, -1, :], want[:, :, -1], want[:, -1, -1] = 48.0, 48.0, 32.0
        assert torch.equal(y, want)


def test_rejects_what_the_kernel_does_not_take(cuda):
    x, w, bias = _inputs(1, 8, 8, 32, 32, torch.float32, 11, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        DS.downsample_conv2x(torch.randn((1, 32, 8, 8), device=cuda).permute(0, 2, 3, 1), w, bias)
    with pytest.raises(TypeError):
        DS.downsample_conv2x(x.half(), w.half(), bias)
    with pytest.raises(ValueError, match="even"):
        DS.downsample_conv2x(x[:, :7].contiguous(), w, bias)
    with pytest.raises(ValueError, match="is on"):
        DS.downsample_conv2x(x, w.cpu(), bias)
    with pytest.raises(ValueError, match="aligned"):
        DS.downsample_conv2x(torch.randn(1 * 8 * 8 * 32 + 1, device=cuda)[1:].view(1, 8, 8, 32),
                             w, bias)
    xb, wb, biasb = _inputs(1, 8, 8, 12, 16, torch.bfloat16, 12, cuda)
    with pytest.raises(ValueError, match="Cin"):
        DS.downsample_conv2x(xb, wb, biasb)
    with pytest.raises(ValueError, match="impl"):
        DS.downsample_conv2x(x, w, bias, "interpret")
    before = DS.downsample_conv2x.launches
    DS.downsample_conv2x(x, w, bias, "xla")
    assert DS.downsample_conv2x.launches == before


def test_gradients_on_the_card_match_the_plain_formula(cuda):
    x, w, bias = _inputs(2, 16, 16, 32, 32, torch.float32, 13, cuda)
    ts = [t.clone().requires_grad_() for t in (x, w, bias)]
    rs = [t.clone().requires_grad_() for t in (x, w, bias)]
    before = DS.downsample_conv2x.launches
    y = DS.downsample_conv2x(*ts)
    assert DS.downsample_conv2x.launches == before + 1
    assert "DownsampleConv2x" in type(y.grad_fn).__name__
    (y ** 2).sum().backward()
    (DS.downsample_conv2x_reference(*rs) ** 2).sum().backward()
    for t, r in zip(ts, rs):
        assert (t.grad - r.grad).abs().max().item() <= 1e-4 * r.grad.abs().max().item()
