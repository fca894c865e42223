"""Device meshes, FSDP sharding rules and the process-group bootstrap.

Port of `diffews_tpu/parallel/mesh.py`.  A JAX process drives every chip
of its host; in PyTorch one process drives one device.  So:

  - a JAX device is a torch rank;
  - a JAX process (a host) is a torch node as `torchrun` gives it
    (`GROUP_RANK`, `LOCAL_WORLD_SIZE`);
  - a mesh is a `torch.distributed.device_mesh.DeviceMesh` with JAX's axis
    names: `("data",)`, `("shots",)` or `("data", "shots")`;
  - the backend follows the mesh's device type, never a probe: NCCL for
    "cuda", gloo for "cpu".  A gloo mesh may carry CUDA tensors, but only
    through `all_reduce` and `broadcast` (what the shot merge and the
    data-parallel gradient mean need): that runs two ranks on one card,
    which NCCL refuses.

Every mesh spans the whole world: the CLIs check that `WORLD_SIZE` equals
the product of their shard counts.  Tensor parallelism (`n_model > 1`,
JAX's `_TP_RULES`) is not ported (ROADMAP A11b).

FSDP (ZeRO-3 style, `init_state_fsdp`): every leaf of at least
`_FSDP_MIN_ELEMS` elements is split over "data" along its largest evenly
divisible dim; each rank holds its shard of the float32 master, the Adam
moments and the EMA, and gathers the whole model in the compute dtype
before each micro-step (`FsdpLayout.gather`).  Gradients are mean-reduced
over "data" with `all_reduce` and each rank keeps its shard; gloo has no
`reduce_scatter`, and one path serves both backends.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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
    """The ("data",) mesh over the whole world (n_data None = every rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_model > 1:
        raise NotImplementedError("tensor parallelism (n_model > 1) is not ported "
                                  "(ROADMAP A11b)")
    n = world_size() if n_data is None else n_data
    _check_world(device_type, n, f"a {n}-way data mesh")
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


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
    return mesh.get_group(name)


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
    of at most `_BUCKET_ELEMS` elements, one SUM all_reduce each."""
    n = dist.get_world_size(group)
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
    """The rows of every rank of `group`, in rank order, concatenated."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# FSDP sharding rules
# ---------------------------------------------------------------------------


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


def param_pspec_tree(params: Dict[str, torch.Tensor], fsdp_size: Optional[int] = None,
                     fsdp_min_elems: int = _FSDP_MIN_ELEMS) -> Dict[str, tuple]:
    """The FSDP spec of each leaf of the port's flat name -> tensor dict
    (JAX's tensor-parallel rules are not ported, ROADMAP A11b).

    The rule is JAX's, applied to the torch shapes.  Torch stores a linear
    weight as (out, in) and a conv weight as (out, in, kh, kw) where JAX has
    (in, out) and (kh, kw, in, out), so where two dims tie for the largest
    (a square projection) the port splits the other logical dim than JAX
    does.  No number depends on it: the step gathers the whole model and
    checkpoints are written gathered."""
    return {n: shape_pspec(tuple(t.shape), fsdp_size, fsdp_min_elems)
            for n, t in params.items()}


class FsdpLayout:
    """Where each leaf is split over a data group, and the collectives that
    move between a leaf's shard and the whole leaf."""

    def __init__(self, specs: Dict[str, tuple], group):
        self.specs, self.group = specs, group
        self.n, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.dims = {k: (s.index("data") if "data" in s else None) for k, s in specs.items()}

    def sharded(self, name: str) -> bool:
        return self.dims[name] is not None

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf `full` (a contiguous copy)."""
        d = self.dims[name]
        if d is None:
            return full
        return full.chunk(self.n, dim=d)[self.rank].contiguous()

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's shard (a collective)."""
        d = self.dims[name]
        if d is None:
            return part
        parts = [torch.empty_like(part, memory_format=torch.contiguous_format)
                 for _ in range(self.n)]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)

    def shard_tree(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.shard(k, v) for k, v in tree.items()}

    def gather_tree(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.gather(k, v) for k, v in tree.items()}


def init_state_fsdp(tcfg, unet_params: Dict[str, torch.Tensor], mesh, *, device=None,
                    fsdp_min_elems: int = _FSDP_MIN_ELEMS):
    """A `TrainState` born sharded over `mesh`'s "data" axis; returns
    (state, layout).  Each rank slices its shard from the host copy of the
    weights and moves only the shard to `device`: no rank allocates a
    full-size float32 master, first or second moment or EMA of a leaf the
    rule shards (the eager `init_state` would build them all)."""
    from diffews_tpu_torch.pipeline import resolve_device
    from diffews_tpu_torch.training import ema as ema_lib
    from diffews_tpu_torch.training import state as state_lib

    dev = resolve_device(device)
    group = axis_group(mesh, "data")
    specs = param_pspec_tree(unet_params, fsdp_size=axis_size(mesh, "data"),
                             fsdp_min_elems=fsdp_min_elems)
    layout = FsdpLayout(specs, group)
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


def shard_host_tree(host_tree: Dict[str, torch.Tensor],
                    layout: Optional[FsdpLayout]) -> Dict[str, torch.Tensor]:
    """Each rank's shards of a whole host tree (FSDP resume: every rank
    reads the same checkpoint and slices its part, as JAX's
    `put_sharded_host_tree`)."""
    return host_tree if layout is None else layout.shard_tree(host_tree)
