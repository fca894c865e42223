"""The multi-tensor AdamW kernels' host side (`ops/adamw.py`), on the CPU.

The chunk table covers every element of every leaf exactly once at ragged
sizes, and its groups are the layout's (`sharded`, `model_sharded`); the
gradients' layout check copies (and counts) only a gradient whose strides
differ on a dim of size > 1, and raises on another dtype or shape; CPU
tensors take the plain version and launch nothing; the kernel path raises
off the card; the two ops' schemas write only the masters and moments;
`launch_counts()` reads the new counters.  The kernels
themselves run on the card: `tests/test_torch_adamw_gpu.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from diffews_tpu_torch.ops import adamw
from diffews_tpu_torch.parallel import mesh as M
from diffews_tpu_torch.training import lr, optim
from diffews_tpu_torch.utils import profiling

RAGGED = [1, 3, 4, 0, 65535, 65536, 65537, 131072, 131077, 7]


@pytest.mark.parametrize("chunk", [4, 64, adamw.CHUNK])
def test_chunk_table_covers_every_element_once(chunk):
    table = adamw.chunk_table(RAGGED, list(range(len(RAGGED))), chunk)
    assert table.dtype == np.int32 and table.shape[1] == 4
    seen = [np.zeros(n, dtype=np.int64) for n in RAGGED]
    for leaf, index, group, pad in table:
        assert group == leaf and pad == 0
        start = index * chunk
        assert 0 <= start < RAGGED[leaf]
        seen[leaf][start:start + chunk] += 1
    assert all((s == 1).all() for s in seen)
    # leaf by leaf, chunk index ascending
    assert (np.diff(table[:, 0]) >= 0).all()
    assert sum(-(-n // chunk) for n in RAGGED) == len(table)


def test_table_groups_follow_the_layout():
    specs = {"rep": (None, None), "data": ("data", None), "model": (None, "model"),
             "both": ("model", "data"), "rep1": (None,)}
    shapes = {"rep": (5, 3), "data": (70000, 2), "model": (4, 8), "both": (6, 40000),
              "rep1": (9,)}
    layout = M.ShardLayout(specs, shapes)
    names = list(specs)
    groups = optim.leaf_groups(names, layout)
    table = adamw.chunk_table([int(np.prod(shapes[n])) for n in names], groups)
    for leaf, _, group, _ in table:
        n = names[leaf]
        assert group == int(layout.sharded(n)) + 2 * int(layout.model_sharded(n))
    assert sorted(set(groups)) == [0, 1, 2, 3]
    assert optim.leaf_groups(names, None) == [0] * len(names)


def test_sharded_norm_of_one_rank_is_the_global_norm():
    specs = {"a": ("data",), "b": (None, "model"), "c": (None,)}
    layout = M.ShardLayout(specs, {"a": (6,), "b": (2, 3), "c": (4,)})
    gen = torch.Generator().manual_seed(0)
    gs = [torch.randn(s, generator=gen) for s in ((6,), (2, 3), (4,))]
    want = optim.global_norm(gs)
    assert torch.allclose(optim._sharded_norm(list(specs), gs, layout), want, rtol=1e-6)
    parts = torch.tensor([1.0, 2.0, 3.0, 10.0])
    assert float(optim.reduce_groups(parts, layout)) == pytest.approx(4.0)


def _plan(shapes):
    """A stand-in plan on the CPU holding channels-last 4-D masters'
    layouts."""
    ps = [torch.zeros(s).contiguous(memory_format=torch.channels_last) if len(s) == 4
          else torch.zeros(s) for s in shapes]
    return SimpleNamespace(layouts=[(tuple(p.shape), p.stride()) for p in ps],
                           device=torch.device("cpu")), ps


def test_layout_check_copies_only_other_orders():
    shapes = [(4, 3, 3, 3), (6, 10, 1, 1), (5, 7), (9,)]
    plan, ps = _plan(shapes)
    gen = torch.Generator().manual_seed(1)
    gs = [torch.randn(s, generator=gen) for s in shapes]  # all contiguous
    before = adamw.match_layouts.layout_copies
    out = adamw.match_layouts(gs, plan)
    assert adamw.match_layouts.layout_copies - before == 1  # the 3x3 conv only
    assert out[0] is not gs[0] and out[0].stride() == ps[0].stride()
    assert torch.equal(out[0], gs[0])
    assert all(o is g for o, g in zip(out[1:], gs[1:]))
    laid = [g.contiguous(memory_format=torch.channels_last) if g.ndim == 4 else g for g in gs]
    adamw.match_layouts(laid, plan)
    assert adamw.match_layouts.layout_copies - before == 1
    with pytest.raises(TypeError):
        adamw.match_layouts([gs[0].bfloat16()] + gs[1:], plan)
    with pytest.raises(ValueError):
        adamw.match_layouts([gs[0]] + [torch.zeros(6, 10, 1, 2)] + gs[2:], plan)


def test_dense_and_same_layout():
    x = torch.zeros(4, 3, 5, 5)
    assert adamw._dense(x) and adamw._dense(x.contiguous(memory_format=torch.channels_last))
    assert not adamw._dense(x[:, :2]) and not adamw._dense(torch.zeros(6, 4)[:, ::2])
    assert adamw._dense(torch.zeros(3, 1, 1, 5).as_strided((3, 1, 1, 5), (5, 99, 7, 1)))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse():
        raise AssertionError("the kernels' library was loaded for CPU tensors")

    monkeypatch.setattr(adamw, "_lib", refuse)
    gen = torch.Generator().manual_seed(2)
    params = {"w": torch.randn(3, 4, 3, 3, generator=gen), "b": torch.randn(5, generator=gen)}
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
    tx = optim.make_optimizer(lr.constant(1e-3))
    state = tx.init(params)
    plain_params = {n: p.clone() for n, p in params.items()}
    plain_state = tx.init(plain_params)
    before = profiling.launch_counts()
    gnorm = tx.update(grads, state, params)
    assert profiling.launch_counts() == before
    assert torch.equal(gnorm, tx.plain(grads, plain_state, plain_params))
    for n in params:
        assert torch.equal(params[n], plain_params[n])
        assert torch.equal(state.mu[n], plain_state.mu[n])
    assert int(state.count) == 1


def test_kernel_path_refuses_cpu_tensors():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        adamw.MultiTensor((1.0,) * 7).norm([p], [p], [p.bfloat16()], [p], [0])


def test_ops_write_only_the_masters_and_moments():
    written = {}
    for op in (torch.ops.diffews_tpu_torch.adamw_norm, torch.ops.diffews_tpu_torch.adamw_apply):
        schema = op.default._schema
        written[schema.name] = [a.name for a in schema.arguments
                                if a.alias_info is not None and a.alias_info.is_write]
    assert written == {"diffews_tpu_torch::adamw_norm": [],
                       "diffews_tpu_torch::adamw_apply": ["ps", "mus", "nus"]}


def test_launch_counts_has_the_optimizer_counters():
    counts = profiling.launch_counts()
    for key in ("adamw_norm", "adamw_finalise", "adamw_apply", "adamw_layout_copies"):
        assert isinstance(counts[key], int), key
