"""Feed given int8 codes into the port's quantizer, and hold its own codes
against them (no JAX here: `chip_smoke.py` uses it on the card).

One code at a quantizer tie moves a tiny random model's output by many
uint8 counts (`int8_ties.py` says why), so two int8 runs that compute the
activations in front of a quantizer in another order are compared with the
first run's codes fed into the second:

  - `recording(codes)`: the port's `quant.quantize_s8` appends each code
    tensor it computes to `codes`, in call order;
  - `force(codes, stats)`: the port's `quant.quantize_s8` computes its own
    codes, appends (share of codes that differ, max |diff|) from `codes`'
    next entry to `stats`, and goes on with that entry;
  - `by_site(module, stand_in)`: a stand-in that also gets the qualified
    name of the int8 module whose input it quantizes;
  - `check_ties(stats)`: every site at most one code apart, on at most a
    small share of its codes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from diffews_tpu_torch.ops import quant as TQ


@contextlib.contextmanager
def quantizer(stand_in):
    """`quant.quantize_s8` replaced by `stand_in(own, x, s_a)` while active.
    The kernel's launcher counts on the module's `quantize_s8`, so the
    stand-in's count goes back to the wrapper afterwards."""
    own = TQ.quantize_s8
    fn = lambda x, s_a: stand_in(own, x, s_a)
    fn.launches = 0
    TQ.quantize_s8 = fn
    try:
        yield
    finally:
        TQ.quantize_s8 = own
        own.launches += fn.launches


def tie_stats(mine: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """(share of codes that differ, max |diff|) of two int8 code tensors."""
    d = (mine.int() - want.to(mine.device).int()).abs()
    return (d != 0).float().mean().item(), int(d.max().item())


@contextlib.contextmanager
def recording(codes: list):
    """Append every code tensor the port's quantizer computes to `codes`."""
    def record(own, x, s_a):
        codes.append(own(x, s_a))
        return codes[-1]

    with quantizer(record):
        yield codes


def _as_tensor(c, device) -> torch.Tensor:
    return (c if isinstance(c, torch.Tensor) else torch.from_numpy(np.array(c))).to(device)


@contextlib.contextmanager
def force(codes: list, stats: list):
    """The port's quantizer, for the calls made while active, compares with
    and then returns `codes` in order (numpy arrays or tensors); raises if
    the port reaches more sites than `codes` holds or leaves some unused."""
    it = iter(codes)

    def forced(own, x, s_a):
        mine, want = own(x, s_a), next(it, None)
        assert want is not None, "the run reached more int8 sites than the recorded one"
        want = _as_tensor(want, x.device)
        assert mine.shape == want.shape, (tuple(mine.shape), tuple(want.shape))
        stats.append(tie_stats(mine, want))
        return want

    with quantizer(forced):
        yield stats
    assert next(it, None) is None, "the recorded run reached more int8 sites than this one"


@contextlib.contextmanager
def by_site(module: torch.nn.Module, stand_in):
    """`quantizer` whose stand-in also gets the qualified name (in
    `module`) of the int8 module whose input it quantizes: `stand_in(own,
    name, x, s_a)`."""
    cur = [None]
    hooks = [m.register_forward_pre_hook(lambda _m, _a, n=n: cur.__setitem__(0, n))
             for n, m in module.named_modules()
             if isinstance(m, (TQ.Int8Conv2d, TQ.Int8Linear))]
    try:
        with quantizer(lambda own, x, s_a: stand_in(own, cur[0], x, s_a)):
            yield
    finally:
        for h in hooks:
            h.remove()


def check_ties(stats: list, max_share: float = 1e-3) -> float:
    """Every forced site's codes equal the recorded ones but at ties: at
    most one code apart, on at most `max_share` of a site's codes.  Returns
    the largest share."""
    assert stats, "no int8 site was forced"
    worst = max(s for s, _ in stats)
    assert max(m for _, m in stats) <= 1 and worst <= max_share, stats
    return worst
