"""The multi-tensor AdamW kernels (`ops/adamw.py`, `ops/csrc/adamw.cu`)
against the optimizer's plain version, on the card.

At the SD-2.1 UNet's 688 leaf shapes (4-D masters channels-last, as the
train step holds them) and at ragged sizes (1, 3, 65537, ... elements;
`helpers/adamw_leaves.py`):
  - the update, kernels against `Optimizer.plain` given the same norm (the
    plain norm replaced by the kernels' for the comparison): masters, both
    moments and the counters bit for bit, bf16 and f32 first moment,
    clipped and unclipped;
  - a NaN or an Inf in one leaf: p, mu, nu and count stay bit for bit as
    they were, and the counters move as the plain version moves them;
  - `max_nonfinite_steps` 0: every step applies, a non-finite one too, bit
    for bit as the plain version;
  - the norm within 1e-6 relative of the plain `global_norm`, and the same
    bits on two runs;
  - a gradient with other strides than its master is copied into the
    master's layout and counted, and the step's bits are those without it;
  - the profiler puts each kernel under the torch op that launched it
    (`diffews_tpu_torch::adamw_norm`, `::adamw_apply`), inside the span
    around the update, and the update bumps the version counters of the
    masters and moments it writes, and of nothing else;
  - under a 2-rank layout (gloo, both ranks on the card;
    `helpers/adamw_ranks.py`): the four group sums within 1e-6 of the plain
    ones, the norm within 1e-6 of `_sharded_norm`'s, the update bit for bit.

Marked `gpu`: each test skips without a CUDA device.  This file imports no
JAX; run it on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_adamw_gpu.py
"""

import json

import pytest
import torch

from diffews_tpu_torch.ops import adamw
from diffews_tpu_torch.training import lr, optim
from diffews_tpu_torch.utils import profiling
from helpers import adamw_leaves as L
from helpers.torch_ranks import run_ranks

pytestmark = pytest.mark.gpu
LEAVES = ("sd21", "ragged")
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int32: torch.int32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shapes(which):
    return L.sd21_shapes() if which == "sd21" else dict(L.RAGGED)


def _same(a, b) -> bool:
    """Bit for bit, NaNs included."""
    return a.dtype == b.dtype and torch.equal(a.view(_INT[a.dtype]), b.view(_INT[b.dtype]))


def _make(max_grad_norm, mu_dtype=torch.bfloat16, max_nonfinite_steps=10, layout=None):
    return optim.make_optimizer(lr.polynomial_with_warmup(1e-3, 100), max_grad_norm=max_grad_norm,
                                mu_dtype=mu_dtype, max_nonfinite_steps=max_nonfinite_steps,
                                layout=layout)


def _copies(params, state):
    return {n: p.clone() for n, p in params.items()}, L.clone_state(state)


def _assert_same(params, state, params2, state2):
    for n in params:
        assert _same(params[n], params2[n]), n
        assert _same(state.mu[n], state2.mu[n]), n
        assert _same(state.nu[n], state2.nu[n]), n
    for k in ("count", "notfinite_count", "total_notfinite"):
        assert _same(getattr(state, k), getattr(state2, k)), k


def _kernels_and_plain(tx, grads, params, state, monkeypatch):
    """The kernels' update on (params, state), then the plain version's on
    copies with the kernels' norm; returns the copies and both norms."""
    params2, state2 = _copies(params, state)
    before = adamw.apply_pass.launches
    gk = tx.update(grads, state, params)
    assert adamw.apply_pass.launches == before + 1
    monkeypatch.setattr(optim, "global_norm", lambda ts: gk.clone())
    gp = tx.plain(grads, state2, params2)
    return params2, state2, gk, gp


@pytest.mark.parametrize("clipped", [True, False])
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("leaves", LEAVES)
def test_update_bit_identical_to_plain(cuda, leaves, mu_dtype, clipped, monkeypatch):
    params, grads, state = L.draw(_shapes(leaves), cuda, seed=1, mu_dtype=mu_dtype)
    norm = float(optim.global_norm(list(grads.values())))
    tx = _make(norm / 2 if clipped else norm * 2, mu_dtype)
    before = {n: p.clone() for n, p in params.items()}
    params2, state2, gk, gp = _kernels_and_plain(tx, grads, params, state, monkeypatch)
    assert _same(gk, gp)
    _assert_same(params, state, params2, state2)
    assert int(state.count) == 4
    moved = sum(int((params[n] != before[n]).sum()) for n in params)
    assert moved > 0.9 * sum(p.numel() for p in params.values())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("leaves", LEAVES)
def test_nonfinite_step_leaves_state_unchanged(cuda, leaves, bad):
    params, grads, state = L.draw(_shapes(leaves), cuda, seed=2)
    name = list(grads)[len(grads) // 2]
    grads[name][(0,) * grads[name].ndim] = bad
    tx = _make(1.0)
    saved_params, saved_state = _copies(params, state)
    params2, state2 = _copies(params, state)
    tx.update(grads, state, params)
    tx.plain(grads, state2, params2)
    for n in params:
        assert _same(params[n], saved_params[n]), n
        assert _same(state.mu[n], saved_state.mu[n]), n
        assert _same(state.nu[n], saved_state.nu[n]), n
    assert _same(state.count, saved_state.count)
    _assert_same(params, state, params2, state2)
    assert int(state.notfinite_count) == int(state.total_notfinite) == 1


@pytest.mark.parametrize("leaves", LEAVES)
def test_without_apply_if_finite_every_step_applies(cuda, leaves, monkeypatch):
    params, grads, state = L.draw(_shapes(leaves), cuda, seed=3)
    tx = _make(1.0, max_nonfinite_steps=0)
    params2, state2, gk, gp = _kernels_and_plain(tx, grads, params, state, monkeypatch)
    _assert_same(params, state, params2, state2)
    name = list(grads)[0]
    grads[name][(0,) * grads[name].ndim] = float("nan")
    monkeypatch.undo()
    params3, state3, gk, gp = _kernels_and_plain(tx, grads, params, state, monkeypatch)
    assert torch.isnan(gk) and _same(gk, gp)
    _assert_same(params, state, params3, state3)
    assert int(state.count) == 5 and torch.isnan(params[name]).all()


@pytest.mark.parametrize("leaves", LEAVES)
def test_norm_close_to_plain_and_repeatable(cuda, leaves):
    params, grads, state = L.draw(_shapes(leaves), cuda, seed=4)
    names = list(params)
    args = ([grads[n] for n in names], [params[n] for n in names],
            [state.mu[n] for n in names], [state.nu[n] for n in names],
            [0] * len(names))
    kernels = adamw.MultiTensor((1.0,) * 7)
    a, b = kernels.norm(*args), kernels.norm(*args)
    assert _same(a.norm, b.norm) and _same(a.group_sums, b.group_sums)
    plain = float(optim.global_norm(args[0]))
    assert abs(float(a.norm) - plain) <= 1e-6 * plain, (float(a.norm), plain)
    assert bool(a.finite) and float(a.group_sums[1:].abs().sum()) == 0.0


def test_other_strides_are_copied_and_counted(cuda):
    shapes = dict(L.RAGGED, unet_conv=(320, 320, 3, 3))
    params, grads, state = L.draw(shapes, cuda, seed=5)
    # contiguous against channels-last masters: two leaves differ on dims of
    # size > 1; the 1x1 conv only on dims of size 1 (the same order)
    other = {n: g.contiguous() for n, g in grads.items()}
    params2, state2 = _copies(params, state)
    tx = _make(1.0)
    before = adamw.match_layouts.layout_copies
    gk = tx.update(other, state, params)
    assert adamw.match_layouts.layout_copies - before == 2
    gk2 = tx.update(grads, state2, params2)
    assert adamw.match_layouts.layout_copies - before == 2
    assert _same(gk, gk2)
    _assert_same(params, state, params2, state2)


def test_profiler_links_the_kernels_to_their_ops(cuda):
    from torch.profiler import ProfilerActivity, profile

    params, grads, state = L.draw(dict(L.RAGGED), cuda, seed=6)
    tx = _make(1.0)
    tx.update(grads, state, params)  # the plan and the library, outside the trace
    torch.cuda.synchronize()
    with profiling.spans_on(), profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
        with profiling.annotate("diffews.train.optimizer"):
            tx.update(grads, state, params)
        torch.cuda.synchronize()
    events = prof.events()
    span = [e for e in events if e.name == "diffews.train.optimizer"
            and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(span) == 1
    launched = {}
    for e in events:
        if e.name.startswith("diffews_tpu_torch::adamw_"):
            assert span[0].time_range.start <= e.time_range.start <= span[0].time_range.end
            launched.setdefault(e.name, []).extend(k.name for k in e.kernels)
    ours = lambda op: [k for k in ("adamw_norm_kernel", "adamw_finalise_kernel",  # noqa: E731
                                   "adamw_apply_kernel") for n in launched[op] if k in n]
    assert ours("diffews_tpu_torch::adamw_norm") == ["adamw_norm_kernel",
                                                     "adamw_finalise_kernel"], launched
    assert ours("diffews_tpu_torch::adamw_apply") == ["adamw_apply_kernel"], launched


def test_update_bumps_the_written_tensors_versions(cuda):
    params, grads, state = L.draw(dict(L.RAGGED), cuda, seed=7)
    tx = _make(1.0)
    written = [*params.values(), *state.mu.values(), *state.nu.values()]
    before = [t._version for t in written]
    read = [g._version for g in grads.values()]
    tx.update(grads, state, params)
    assert all(t._version > v for t, v in zip(written, before))
    assert [g._version for g in grads.values()] == read


def test_sharded_groups_over_gloo(cuda, tmp_path):
    run_ranks(["tests/helpers/adamw_ranks.py", str(tmp_path)], 2, timeout=300)
    for r in range(2):
        res = json.load(open(tmp_path / f"rank{r}.json"))
        assert min(res["plain_groups"]) > 0, res  # every group holds leaves
        assert res["groups_rel"] <= 1e-6 and res["norm_rel"] <= 1e-6, res
        assert res["update_bits_equal"] and res["count"] == 4, res
