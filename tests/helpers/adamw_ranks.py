"""One rank of `tests/test_torch_adamw_gpu.py::test_sharded_groups_over_gloo`
(run by `helpers.torch_ranks.run_ranks`; gloo, whose all_reduce takes CUDA
tensors, so that two ranks share one card; no JAX).

    python tests/helpers/adamw_ranks.py <out_dir>

A layout over a "data" axis of the 2 ranks holds leaves of each norm group
(replicated, split over "data", over "model", over both; the "model" axis
is one rank, so its leaves only sort into groups), ragged and past a chunk.
Each rank draws its parts on the card and writes `<out_dir>/rank<r>.json`:
the plain group sums of squares, the kernels' group sums against them
(largest difference relative to the largest sum), the norm of the kernel
path (`optim.reduce_groups` over the data axis) against the plain
`_sharded_norm`, and whether the kernels' update equals the plain
version's bit for bit given the same norm.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from diffews_tpu_torch.ops import adamw  # noqa: E402
from diffews_tpu_torch.parallel import mesh as M  # noqa: E402
from diffews_tpu_torch.training import lr, optim  # noqa: E402
from helpers import adamw_leaves as L  # noqa: E402

SPECS = {"rep": (None,), "rep_conv": (None, None, None, None), "data": ("data", None),
         "data_big": ("data",), "model": ("model", None), "both": ("data", "model")}
PARTS = {"rep": (3,), "rep_conv": (8, 4, 3, 3), "data": (33, 17), "data_big": (65541,),
         "model": (70001, 2), "both": (5, 9)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def main():
    out_dir = sys.argv[1]
    M.maybe_initialize_distributed(device_type="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    full = {n: tuple(s * (world if SPECS[n][d] == "data" else 1) for d, s in enumerate(shape))
            for n, shape in PARTS.items()}
    layout = M.ShardLayout(SPECS, full, data_group=dist.group.WORLD)
    names = list(PARTS)
    params, grads, state = L.draw(PARTS, "cuda", seed=10 + rank)
    gs = [grads[n] for n in names]

    plain_groups = [0.0] * 4
    for group, g in zip(optim.leaf_groups(names, layout), gs):
        plain_groups[group] += float(g.float().square().sum())
    step = adamw.MultiTensor((1.0,) * 7).norm(
        gs, [params[n] for n in names], [state.mu[n] for n in names],
        [state.nu[n] for n in names], optim.leaf_groups(names, layout))
    got = step.group_sums.tolist()
    groups_rel = max(abs(a - b) for a, b in zip(got, plain_groups)) / max(plain_groups)
    kernel_norm = float(optim.reduce_groups(step.group_sums, layout))
    plain_norm = float(optim._sharded_norm(names, gs, layout))

    tx = optim.make_optimizer(lr.constant(1e-3), max_grad_norm=plain_norm / 2, layout=layout)
    params2 = {n: p.clone() for n, p in params.items()}
    state2 = L.clone_state(state)
    gk = tx.update(grads, state, params)
    optim._sharded_norm = lambda *args: gk.clone()
    tx.plain(grads, state2, params2)
    equal = all(torch.equal(_bits(a[n]), _bits(b[n])) for n in names
                for a, b in ((params, params2), (state.mu, state2.mu), (state.nu, state2.nu)))
    res = {"plain_groups": plain_groups, "kernel_groups": got, "groups_rel": groups_rel,
           "kernel_norm": kernel_norm, "plain_norm": plain_norm,
           "norm_rel": abs(kernel_norm - plain_norm) / plain_norm,
           "update_bits_equal": bool(equal) and int(state.count) == int(state2.count),
           "count": int(state.count)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
