"""Device meshes, sharding rules and the process-group bootstrap.

Port of `diffews_tpu/parallel/mesh.py`.  A JAX process drives every chip
of its host; in PyTorch one process drives one device.  So:

  - a JAX device is a torch rank;
  - a JAX process (a host) is a torch node as `torchrun` gives it
    (`GROUP_RANK`, `LOCAL_WORLD_SIZE`);
  - a mesh is a `torch.distributed.device_mesh.DeviceMesh` with JAX's axis
    names: `("data",)`, `("data", "model")`, `("shots",)` or
    `("data", "shots")`; rank r of a ("data", "model") mesh sits at
    (r // n_model, r % n_model), the layout of JAX's
    `devices.reshape(n_data, n_model)`;
  - the backend follows the mesh's device type, never a probe: NCCL for
    "cuda", gloo for "cpu".  A gloo mesh may carry CUDA tensors, but only
    through `all_reduce` and `broadcast`: that runs two ranks on one card,
    which NCCL refuses.  So every collective of the shot merge, the
    gradient mean, tensor parallelism and the pipeline's row gather is an
    `all_reduce`; only FSDP's gather of the "data" axis is an `all_gather`.

Every mesh spans the whole world: the CLIs check that `WORLD_SIZE` equals
the product of their shard counts.

The sharding rules are JAX's (`param_pspec_tree`), applied to the port's
flat name -> tensor dicts in JAX's logical dim order, so each leaf's spec
names the same logical dims as JAX's:

  - tensor parallelism (`_TP_RULES`): the attention projections and the
    feed-forward matmuls carry "model" on their matmul dim (torch stores a
    linear weight as (out, in), so JAX's `P(None, "model")` is torch's dim
    0); biases and norms stay replicated.  A rank holds whole heads and
    its blocks of the GEGLU's two halves (`parallel/tensor_parallel.py`);
  - FSDP (ZeRO-3 style): every leaf of at least `_FSDP_MIN_ELEMS` elements
    is split over "data" along its largest evenly divisible dim (the other
    dim of a tensor-parallel weight).  Each rank holds its shard of the
    float32 master, the Adam moments and the EMA, and gathers the "data"
    axis in the compute dtype before each micro-step
    (`ShardLayout.gather_data`).  Gradients are mean-reduced over "data"
    with `all_reduce` and each rank keeps its shard; gloo has no
    `reduce_scatter`, and one path serves both backends.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from diffews_tpu_torch.parallel import tensor_parallel as tp

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# Leaves smaller than this stay replicated under FSDP: sharding a tiny bias
# buys nothing and costs a gather per micro-step.
_FSDP_MIN_ELEMS = 65536

# elements of one flat buffer of the bucketed gradient all_reduce
_BUCKET_ELEMS = 1 << 25


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"no process-group backend for device type {device_type!r} "
                         f"(expected one of {sorted(BACKENDS)})")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device (NCCL); this host has none. "
                           "Use a 'cpu' mesh (gloo) for the plain path")
    return BACKENDS[device_type]


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_world_size() -> int:
    """Ranks of this node (`torchrun`'s LOCAL_WORLD_SIZE; one node by default)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank() % local_world_size()))


def host_index() -> int:
    """The node's index, JAX's `process_index`."""
    return int(os.environ.get("GROUP_RANK", rank() // local_world_size()))


def host_count() -> int:
    """Nodes in the world, JAX's `process_count`."""
    return world_size() // local_world_size()


def launched() -> bool:
    """True under `torchrun` (its environment names the world) or once the
    default process group exists."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def maybe_initialize_distributed(force: bool = False,
                                 device_type: str = "cuda") -> Tuple[int, int]:
    """Initialise the default process group from `torchrun`'s environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) with the backend of
    `device_type`, when `force` or when that environment is present; a
    no-op when the group exists or on a plain single-process run.  On "cuda"
    the rank takes the card `LOCAL_RANK`.  A failed initialisation raises.

    Returns (host_index, host_count), JAX's (process_index, process_count);
    `rank()` / `world_size()` give the torch rank and world."""
    if dist.is_initialized():
        return host_index(), host_count()
    if not force and "WORLD_SIZE" not in os.environ:
        return 0, 1
    backend = _backend(device_type)
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"multi-device runs start under torchrun (torchrun "
                           f"--nproc_per_node N -m ...): {', '.join(missing)} not set")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    return host_index(), host_count()


def _check_world(device_type: str, need: int, what: str):
    backend = _backend(device_type)
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs the process group: call "
                           "maybe_initialize_distributed under torchrun first")
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {device_type!r} mesh runs on {backend}; the process group "
                           f"is {dist.get_backend()}")
    if need != dist.get_world_size():
        raise ValueError(f"{what} needs {need} ranks and the world has "
                         f"{dist.get_world_size()}: launch with torchrun "
                         f"--nproc_per_node {need}")


def make_mesh(device_type: str, n_data: Optional[int] = None, n_model: int = 1):
    """The ("data", "model") mesh over the whole world (n_data None = the
    world // n_model), or the ("data",) mesh at n_model 1."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    n = world_size() // n_model if n_data is None else n_data
    if n_model == 1:
        _check_world(device_type, n, f"a {n}-way data mesh")
        return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
    _check_world(device_type, n * n_model, f"a {n}x{n_model} data x model mesh")
    return init_device_mesh(device_type, (n, n_model), mesh_dim_names=("data", "model"))


def make_shot_mesh(device_type: str, n_shards: int, n_data: int = 1):
    """("shots",) or ("data", "shots") mesh for shot-parallel serving
    (`DiffewsPipeline(shot_mesh=...)`): each rank encodes and runs its
    local shots, the query stream is replicated over "shots", and the
    fused KV attention merges the partial softmaxes over "shots"
    (`ops/attention.py::shot_parallel_fused_kv_attention`); n_data > 1
    also shards the episode batch over "data"."""
    from torch.distributed.device_mesh import init_device_mesh

    _check_world(device_type, n_shards * n_data,
                 f"a {n_data}x{n_shards} data x shots mesh")
    if n_data > 1:
        return init_device_mesh(device_type, (n_data, n_shards),
                                mesh_dim_names=("data", "shots"))
    return init_device_mesh(device_type, (n_shards,), mesh_dim_names=("shots",))


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    return mesh.get_local_rank(name) if name in (mesh.mesh_dim_names or ()) else 0


def axis_group(mesh, name: str):
    """The process group of axis `name`, None where the mesh lacks it."""
    return mesh.get_group(name) if name in (mesh.mesh_dim_names or ()) else None


def rows(n_rows: int, n_parts: int, part: int, what: str = "batch") -> slice:
    """The contiguous rows of `part` when `n_rows` split evenly in `n_parts`."""
    if n_rows % n_parts:
        raise ValueError(f"the data axis ({n_parts}) must divide the {what} {n_rows}")
    per = n_rows // n_parts
    return slice(part * per, (part + 1) * per)


def put_global_batch(batch: dict, mesh, dim: int = 1) -> dict:
    """This rank's rows of its host's batch: every rank of a host samples the
    host's batch alike and keeps its contiguous slice along `dim` (the
    batch axis; 1 under the training batch's leading gas axis), as JAX's
    `P(None, "data")` splits a process's local rows over its devices."""
    if mesh is None:
        return batch
    n_local = axis_size(mesh, "data") // host_count()
    part = axis_rank(mesh, "data") % n_local
    return {k: v[(slice(None),) * dim + (rows(v.shape[dim], n_local, part),)]
            for k, v in batch.items()}


class StopVote:
    """The ranks of `group` agree on a step to stop at, without a host sync
    each step.  Each call casts this step's vote (a MAX all_reduce queued on
    the device) and returns the previous call's result, read once the
    device has finished the previous step: every rank gets the same answer
    at the same call, one step after the first rank raised its flag."""

    def __init__(self, group, device):
        self.group, self.device = group, torch.device(device)
        self._pending = None  # (result on the host, event marking its copy)

    def __call__(self, flag: bool) -> bool:
        t = torch.full((1,), int(flag), dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        done = None
        if self.device.type == "cuda":
            host = torch.empty(1, dtype=torch.int32, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            t = host
        prev, self._pending = self._pending, (t, done)
        if prev is None:
            return False
        if prev[1] is not None:
            prev[1].synchronize()
        return bool(prev[0].item())


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over `group`, in place: flat buffers
    of at most `_BUCKET_ELEMS` elements, one SUM all_reduce each (none for
    a group of one)."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    bucket: List[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / n
        at = 0
        for t in bucket:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (size + t.numel() > _BUCKET_ELEMS or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        flush()


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of `group` (each the same count), in rank
    order, concatenated: an `all_reduce` of the zero-filled whole with this
    rank's rows written in, which gloo also runs on CUDA tensors."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows_ = x.shape[0]
    return tp.gather(x, 0, [(r * rows_, (r + 1) * rows_)], n * rows_, group)


# ---------------------------------------------------------------------------
# Sharding rules (JAX's `_TP_RULES`, `_fsdp_dim`, `param_pspec_tree`)
# ---------------------------------------------------------------------------

# Module-path regexes -> the "model" dim of the torch (out, in) weight.
# Attention projections shard heads (out dim of q/k/v, in dim of out-proj);
# the FFN shards its hidden dim; the CLIP text rules are JAX's too.  All
# biases and norms stay replicated.
_TP_RULES = [
    (re.compile(r"attn\d?\.(to_q|to_k|to_v)$"), ("model", None)),
    (re.compile(r"self_attn\.(q_proj|k_proj|v_proj)$"), ("model", None)),
    (re.compile(r"attn\d?\.to_out\.0$"), (None, "model")),
    (re.compile(r"self_attn\.out_proj$"), (None, "model")),
    (re.compile(r"ff\.net\.0\.proj$"), ("model", None)),
    (re.compile(r"ff\.net\.2$"), (None, "model")),
    (re.compile(r"mlp\.fc1$"), ("model", None)),
    (re.compile(r"mlp\.fc2$"), (None, "model")),
]


def _fsdp_dim(shape, n: Optional[int], avoid: Optional[int] = None,
              min_elems: int = _FSDP_MIN_ELEMS) -> Optional[int]:
    """Largest dim of `shape` evenly divisible by `n` (skipping `avoid`);
    None = keep replicated.  Ties go to the first such dim, as in JAX."""
    if not n or n <= 1 or math.prod(shape) < min_elems:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != avoid and shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def shape_pspec(shape, fsdp_size: Optional[int], min_elems: int = _FSDP_MIN_ELEMS) -> tuple:
    """Shape-only FSDP spec: "data" on the largest divisible dim, else ()
    (replicated), in the form of JAX's `PartitionSpec`."""
    d = _fsdp_dim(tuple(shape), fsdp_size, min_elems=min_elems)
    if d is None:
        return ()
    spec = [None] * len(shape)
    spec[d] = "data"
    return tuple(spec)


def _jax_order(name: str, ndim: int) -> Tuple[int, ...]:
    """The torch dim of each of JAX's dims of the leaf: a conv kernel is
    (kh, kw, in, out) in JAX and (out, in, kh, kw) here, a linear kernel
    (in, out) and (out, in); embeddings, norms and biases keep their
    order (`checkpoint.state_dict_from_jax`)."""
    module = name.rpartition(".")[0]
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2 and name.endswith(".weight") and not module.endswith("embedding"):
        return (1, 0)
    return tuple(range(ndim))


def param_pspec_tree(params: Dict[str, torch.Tensor], tensor_parallel: bool = False,
                     fsdp_size: Optional[int] = None,
                     fsdp_min_elems: int = _FSDP_MIN_ELEMS) -> Dict[str, tuple]:
    """The spec of each leaf of the port's flat name -> tensor dict: () when
    replicated, else a tuple naming the axis of each torch dim.

    JAX's rule: "model" on the matched matmul dim of a tensor-parallel
    linear weight; with `fsdp_size`, "data" on the largest other evenly
    divisible dim of every leaf of at least `fsdp_min_elems` elements.  The
    dims are compared in JAX's order, so a tie between equal dims picks the
    logical dim JAX picks, and each spec names the dims of JAX's."""
    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        order = _jax_order(name, len(shape))
        spec, tp_dim = [None] * len(shape), None
        if tensor_parallel and len(shape) == 2 and order == (1, 0):
            module = name.rpartition(".")[0]
            for rx, rule in _TP_RULES:
                if rx.search(module):
                    spec, tp_dim = list(rule), rule.index("model")
                    break
        fd = _fsdp_dim(tuple(shape[d] for d in order), fsdp_size,
                       avoid=None if tp_dim is None else order.index(tp_dim),
                       min_elems=fsdp_min_elems)
        if fd is not None:
            spec[order[fd]] = "data"
        out[name] = tuple(spec) if any(spec) else ()
    return out


def tp_units(module) -> Dict[str, Tuple[int, bool]]:
    """(unit, halves) of the model split of each tensor-parallel weight of
    `module`'s tree: an attention module's projections split in whole
    heads (unit = its `head_dim`), a GEGLU projection (`ff.net.0.proj`) in
    its two halves; the rest in single rows (1, False)."""
    units = {}
    for prefix, m in module.named_modules():
        pre = prefix + "." if prefix else ""
        head_dim = getattr(m, "head_dim", None)
        if head_dim:
            for leaf in ("to_q", "to_k", "to_v", "to_out.0"):
                units[f"{pre}{leaf}.weight"] = (head_dim, False)
        if prefix.endswith("ff.net.0"):
            units[f"{pre}proj.weight"] = (1, True)
    return units


class ShardLayout:
    """Where each leaf is split over a mesh's "data" axis (FSDP) and "model"
    axis (tensor parallelism), and the collectives that move between a
    leaf's part and the whole leaf.

    `dims[name]` is the leaf's "data" dim and `model_dims[name]` its "model"
    dim (None = not split over that axis).  A "model" split gives each rank
    its ranges of the dim (`tensor_parallel.part` / `halves`, in the units
    of `units`); a "data" split even chunks of the dim after it."""

    def __init__(self, specs: Dict[str, tuple], shapes: Dict[str, Tuple[int, ...]],
                 data_group=None, model_group=None,
                 units: Optional[Dict[str, Tuple[int, bool]]] = None):
        self.specs, self.shapes, self.units = specs, shapes, units or {}
        self.data_group, self.model_group = data_group, model_group
        self.n, self.rank = _size_rank(data_group)
        self.n_model, self.model_rank = _size_rank(model_group)
        axis = lambda s, a: s.index(a) if a in s else None  # noqa: E731
        self.dims = {k: axis(s, "data") for k, s in specs.items()}
        self.model_dims = {k: axis(s, "model") for k, s in specs.items()}

    def sharded(self, name: str) -> bool:
        return self.dims[name] is not None

    def model_sharded(self, name: str) -> bool:
        return self.model_dims[name] is not None

    def model_ranges(self, name: str) -> List[Tuple[int, int]]:
        """This rank's ranges of the leaf's "model" dim."""
        size = self.shapes[name][self.model_dims[name]]
        unit, two = self.units.get(name, (1, False))
        if two:
            return tp.halves(size // 2, self.n_model, self.model_rank, unit)
        return [tp.part(size, self.n_model, self.model_rank, unit)]

    def shard_data(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's "data" chunk of `t` (a copy; `t` itself when the leaf
        is not split over "data")."""
        d = self.dims[name]
        if d is None:
            return t
        return t.chunk(self.n, dim=d)[self.rank].clone(memory_format=torch.contiguous_format)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf `full` (a contiguous copy;
        `full` itself when the leaf is replicated)."""
        md = self.model_dims[name]
        if md is not None:
            full = tp.take(full, md, self.model_ranges(name))
            if self.dims[name] is None:
                return full.clone(memory_format=torch.contiguous_format)
        return self.shard_data(name, full)

    def gather_data(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The leaf's "model" part from every rank's "data" chunk (an
        `all_gather` over "data")."""
        d = self.dims[name]
        if d is None:
            return part
        parts = [torch.empty_like(part, memory_format=torch.contiguous_format)
                 for _ in range(self.n)]
        dist.all_gather(parts, part.contiguous(), group=self.data_group)
        return torch.cat(parts, dim=d)

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's part (collectives every rank
        joins, in the same order)."""
        x = self.gather_data(name, part)
        md = self.model_dims[name]
        if md is None:
            return x
        return tp.gather(x, md, self.model_ranges(name), self.shapes[name][md],
                         self.model_group)

    def shard_tree(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.shard(k, v) for k, v in tree.items()}

    def gather_tree(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.gather(k, v) for k, v in tree.items()}


def _size_rank(group) -> Tuple[int, int]:
    return (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))


def make_layout(params: Dict[str, torch.Tensor], mesh, *, tensor_parallel: bool = False,
                fsdp: bool = False, units: Optional[Dict[str, Tuple[int, bool]]] = None,
                fsdp_min_elems: int = _FSDP_MIN_ELEMS) -> ShardLayout:
    """The layout of `params` over `mesh`: "model" splits under
    `tensor_parallel` (the mesh needs a "model" axis), "data" splits under
    `fsdp`."""
    model_group = axis_group(mesh, "model")
    if tensor_parallel and model_group is None:
        raise ValueError('tensor parallelism needs a mesh with a "model" axis')
    specs = param_pspec_tree(params, tensor_parallel,
                             fsdp_size=axis_size(mesh, "data") if fsdp else None,
                             fsdp_min_elems=fsdp_min_elems)
    return ShardLayout(specs, {k: tuple(v.shape) for k, v in params.items()},
                       axis_group(mesh, "data"), model_group if tensor_parallel else None,
                       units)


def shard_params(params: Dict[str, torch.Tensor], mesh, tensor_parallel: bool = False,
                 fsdp: bool = False, units=None) -> Tuple[Dict[str, torch.Tensor], ShardLayout]:
    """Each rank's parts of `params` under JAX's rules, and their layout."""
    layout = make_layout(params, mesh, tensor_parallel=tensor_parallel, fsdp=fsdp,
                         units=units)
    return layout.shard_tree(params), layout


def init_state_sharded(tcfg, unet_params: Dict[str, torch.Tensor], mesh, *,
                       tensor_parallel: bool = False, fsdp: bool = True, units=None,
                       device=None, fsdp_min_elems: int = _FSDP_MIN_ELEMS):
    """A `TrainState` born sharded over `mesh`; returns (state, layout).
    Each rank slices its part of each leaf from the host copy of the
    weights and moves only the part to `device`: no rank allocates a
    full-size float32 master, first or second moment or EMA of a leaf the
    rules split (the eager `init_state` would build them all).  `units`:
    `tp_units` of the UNet module, for tensor parallelism."""
    from diffews_tpu_torch.pipeline import resolve_device
    from diffews_tpu_torch.training import ema as ema_lib
    from diffews_tpu_torch.training import state as state_lib

    dev = resolve_device(device)
    layout = make_layout(unet_params, mesh, tensor_parallel=tensor_parallel, fsdp=fsdp,
                         units=units, fsdp_min_elems=fsdp_min_elems)
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
    params = {}
    for name, full in unet_params.items():
        p = layout.shard(name, full.detach()).to(device=dev, dtype=torch.float32)
        if p.ndim == 4 and not layout.sharded(name):
            p = p.contiguous(memory_format=fmt)
        params[name] = p.requires_grad_(True)
    opt_state = state_lib.make_optimizer(tcfg, layout=layout).init(params)
    ema = ema_lib.init(params) if tcfg.use_ema else None
    state = state_lib.TrainState(params, opt_state, ema,
                                 torch.zeros((), dtype=torch.int32, device=dev))
    return state, layout


def init_state_fsdp(tcfg, unet_params: Dict[str, torch.Tensor], mesh, *,
                    tensor_parallel: bool = False, units=None, device=None,
                    fsdp_min_elems: int = _FSDP_MIN_ELEMS):
    """`init_state_sharded` with FSDP over "data" (JAX's `init_state_fsdp`;
    with `tensor_parallel` the tensor-parallel weights carry "model" too)."""
    return init_state_sharded(tcfg, unet_params, mesh, tensor_parallel=tensor_parallel,
                              fsdp=True, units=units, device=device,
                              fsdp_min_elems=fsdp_min_elems)


def shard_host_tree(host_tree: Dict[str, torch.Tensor],
                    layout: Optional[ShardLayout]) -> Dict[str, torch.Tensor]:
    """Each rank's parts of a whole host tree (a sharded resume: every rank
    reads the same checkpoint and slices its part, as JAX's
    `put_sharded_host_tree`)."""
    return host_tree if layout is None else layout.shard_tree(host_tree)
