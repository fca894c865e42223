"""Training checkpoints: save, rotate, resume (port of `training/checkpoints.py`).

Layout (`train_tools/train_icl_*_v3.py:1128-1160,1407-1431`):
`{output_dir}/checkpoint-{step}/unet/` in the diffusers format (plus
`unet_ema/` when EMA is on), which the reference's eval
(`--unet_ckpt_path <dir>/unet`), the JAX package and the port read.
Writes land in `checkpoint-{step}.tmp` and are renamed at the end, so a
crashed write is never picked up by `latest_checkpoint`; re-saving a step
swaps through `.old`; rotation keeps `checkpoints_total_limit`.

The optimizer, EMA and step state is the port's own file,
`train_state.pt`: `torch.save` of plain tensors and ints (`opt_state` with
`count`, `mu`, `nu`, `notfinite_count`, `total_notfinite`; `step`;
`ema_step`; in LoRA mode the raw adapters `lora` / `lora_ema`), read back
with `weights_only=True`; the bf16 first moment keeps its dtype.  The JAX
package's `train_state.msgpack` (flax serialisation) is not read: a
directory holding only that raises, naming the file.  The `unet/`
directories are shared both ways.

Multi-device runs (JAX `cli/train.py:555-580,674-694`): every rank calls
`save_checkpoint` with `write` true on rank 0 alone.  Under a sharded
state (`layout`: FSDP over "data", tensor parallelism over "model", or
both) the snapshot first gathers every split leaf over both axes
(`host_fetch`, collectives all ranks join), so the files are those an
unsharded run writes, bit for bit, in the unsharded diffusers layout.
Resume reads the whole host copy on every rank and each rank keeps its
parts (`load_checkpoint(..., layout=...)`).

The training step updates parameters in place, so the synchronous
snapshot copies every tensor to fresh host memory on every device (on the
CPU `t.cpu()` would return the live storage itself); a background write
then serialises the copy while the next steps run.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from diffews_tpu_torch import checkpoint as ckpt_lib
from diffews_tpu_torch.configs import UNetConfig
from diffews_tpu_torch.training import ema as ema_lib
from diffews_tpu_torch.training.state import TrainState

STATE_FILE = "train_state.pt"
JAX_STATE_FILE = "train_state.msgpack"


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy that shares no storage with `t`."""
    return torch.empty(t.shape, dtype=t.dtype).copy_(t.detach())


def host_snapshot(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return {n: _host_copy(t) for n, t in tensors.items()}


def host_fetch(tensors: Dict[str, torch.Tensor], layout=None) -> Dict[str, torch.Tensor]:
    """A host copy of the whole leaves: under a sharded layout every split
    leaf is gathered first (collectives: every rank calls it, in the same
    order)."""
    with torch.no_grad():
        return {n: _host_copy(t if layout is None else layout.gather(n, t))
                for n, t in tensors.items()}


def _opt_snapshot(opt, layout=None) -> dict:
    return {"count": _host_copy(opt.count), "mu": host_fetch(opt.mu, layout),
            "nu": host_fetch(opt.nu, layout), "notfinite_count": _host_copy(opt.notfinite_count),
            "total_notfinite": _host_copy(opt.total_notfinite)}


# at most one background write in flight (checkpoints are large;
# overlapping writes would thrash the disk and could reorder rotation)
_pending: list = []


class AsyncSave:
    """Handle of a background checkpoint write; `.result()` joins and
    re-raises any exception the writer hit (a failed save must not look
    like success: rotation may already have deleted older checkpoints)."""

    def __init__(self, thread: threading.Thread, ckpt_dir: str):
        self._thread = thread
        self.ckpt_dir = ckpt_dir
        self.error: Optional[BaseException] = None

    def result(self) -> str:
        self._thread.join()
        if self in _pending:
            _pending.remove(self)
        if self.error is not None:
            raise RuntimeError(
                f"background checkpoint write to {self.ckpt_dir} failed") from self.error
        return self.ckpt_dir


def wait_for_pending_saves():
    while _pending:
        _pending.pop(0).result()


def save_checkpoint(output_dir: str, step: int, state: TrainState, unet_cfg: UNetConfig,
                    total_limit: Optional[int] = None, background: bool = False,
                    params_override=None, ema_override=None,
                    extra_aux: Optional[dict] = None, stats: Optional[dict] = None,
                    layout=None, write: bool = True):
    """Write `state` under `checkpoint-{step}/`.  The snapshot to host
    memory happens here either way (the caller may change `state` right
    after); with `background=True` the disk write and the rotation run in
    a daemon thread and an `AsyncSave` is returned, else the directory.

    LoRA mode: `state.params` holds the adapters, which are no diffusers
    UNet; the caller passes the merged full weights as `params_override` /
    `ema_override` (so `unet/`, `unet_ema/` stay reference-readable) and
    the raw adapters in `extra_aux` (`{"lora": ..., "lora_ema": ...}`) for
    exact resume.  `stats`, when given, receives `snapshot_s`, and once the
    write is done `write_s` and `bytes`.

    Multi-device: every rank calls it; `layout` (a sharded state) gathers
    the parts first, and only the rank with `write` true snapshots the rest
    and writes (the others return None)."""
    wait_for_pending_saves()
    ckpt_dir = os.path.join(output_dir, f"checkpoint-{step}")
    tmp_dir = ckpt_dir + ".tmp"
    t0 = time.perf_counter()
    if layout is not None:  # the collectives, on every rank
        params = host_fetch(state.params, layout)
        ema_params = host_fetch(state.ema.params, layout) if state.ema is not None else None
        opt = _opt_snapshot(state.opt_state, layout)
    if not write:
        return None
    if layout is None:
        params = host_snapshot(params_override if params_override is not None
                               else state.params)
        if ema_override is not None:
            ema_params = host_snapshot(ema_override)
        else:
            ema_params = host_snapshot(state.ema.params) if state.ema is not None else None
        opt = _opt_snapshot(state.opt_state)
    aux = {"opt_state": opt, "step": int(state.step),
           "ema_step": int(state.ema.step) if state.ema is not None else 0}
    for k, v in (extra_aux or {}).items():
        aux[k] = host_snapshot(v)
    stats = {} if stats is None else stats
    stats["snapshot_s"] = time.perf_counter() - t0

    def write_to_disk():
        t1 = time.perf_counter()
        shutil.rmtree(tmp_dir, ignore_errors=True)
        n = ckpt_lib.save_unet(params, unet_cfg, os.path.join(tmp_dir, "unet"))
        if ema_params is not None:
            n += ckpt_lib.save_unet(ema_params, unet_cfg, os.path.join(tmp_dir, "unet_ema"))
        state_path = os.path.join(tmp_dir, STATE_FILE)
        torch.save(aux, state_path)
        n += os.path.getsize(state_path)
        if os.path.isdir(ckpt_dir):
            # replace-safe: a checkpoint of this step exists (the final save
            # re-saving a step the cadence wrote); `.old` and `.tmp` are
            # invisible to list_checkpoints either way
            old_dir = ckpt_dir + ".old"
            shutil.rmtree(old_dir, ignore_errors=True)
            os.rename(ckpt_dir, old_dir)
            os.rename(tmp_dir, ckpt_dir)
            shutil.rmtree(old_dir, ignore_errors=True)
        else:
            os.rename(tmp_dir, ckpt_dir)
        if total_limit:
            rotate_checkpoints(output_dir, total_limit)
        stats["write_s"], stats["bytes"] = time.perf_counter() - t1, n

    if background:
        handle = AsyncSave(threading.Thread(), ckpt_dir)

        def guarded():
            try:
                write_to_disk()
            except BaseException as e:  # surfaced by .result()
                handle.error = e

        handle._thread = threading.Thread(target=guarded, daemon=True)
        handle._thread.start()
        _pending.append(handle)
        return handle
    write_to_disk()
    return ckpt_dir


def list_checkpoints(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    dirs = [d for d in os.listdir(output_dir) if re.fullmatch(r"checkpoint-\d+", d)]
    return sorted(dirs, key=lambda d: int(d.split("-")[1]))


def rotate_checkpoints(output_dir: str, total_limit: int):
    ckpts = list_checkpoints(output_dir)
    while len(ckpts) > total_limit:
        shutil.rmtree(os.path.join(output_dir, ckpts.pop(0)), ignore_errors=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(output_dir)
    return os.path.join(output_dir, ckpts[-1]) if ckpts else None


@torch.no_grad()
def _restore(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
    if set(dst) != set(src):
        raise ValueError(f"{what}: the checkpoint's names differ from the state's "
                         f"({sorted(set(dst) ^ set(src))[:4]} ...)")
    for n, t in dst.items():
        if tuple(t.shape) != tuple(src[n].shape) or t.dtype != src[n].dtype:
            raise ValueError(f"{what}: {n} is {tuple(src[n].shape)} {src[n].dtype} in the "
                             f"checkpoint, {tuple(t.shape)} {t.dtype} in the state")
        t.copy_(src[n])


def read_train_state(ckpt_dir: str) -> dict:
    path = os.path.join(ckpt_dir, STATE_FILE)
    if not os.path.exists(path):
        if os.path.exists(os.path.join(ckpt_dir, JAX_STATE_FILE)):
            raise ValueError(
                f"{ckpt_dir} holds the JAX trainer's {JAX_STATE_FILE} and no {STATE_FILE}: "
                "the port does not resume a JAX optimizer state (its unet/ loads as "
                "weights, e.g. through --pretrained_model_name_or_path)")
        raise FileNotFoundError(f"{path} does not exist: {ckpt_dir} is no training "
                                "checkpoint of the port")
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_checkpoint(ckpt_dir: str, template: TrainState, lora: bool = False,
                    layout=None) -> Tuple[TrainState, int]:
    """Restore `checkpoint-{step}/` into `template` (a freshly initialised
    state of the same structure) in place, bit for bit, and return it with
    the step.  With `lora=True` the trainable tensors are the adapters
    stored in `train_state.pt`; `unet/` holds the merged model and is not
    read (the base weights come from the pretrained checkpoint).  Under a
    sharded layout every rank reads the whole files and keeps its parts
    (`parallel.mesh.shard_host_tree`)."""
    from diffews_tpu_torch.parallel.mesh import shard_host_tree

    aux = read_train_state(ckpt_dir)
    params = aux["lora"] if lora else ckpt_lib.load_unet_state(os.path.join(ckpt_dir, "unet"))
    _restore(template.params, shard_host_tree(params, layout), "params")
    opt, saved = template.opt_state, aux["opt_state"]
    _restore(opt.mu, shard_host_tree(saved["mu"], layout), "opt_state.mu")
    _restore(opt.nu, shard_host_tree(saved["nu"], layout), "opt_state.nu")
    dev = opt.count.device
    for k in ("count", "notfinite_count", "total_notfinite"):
        setattr(opt, k, saved[k].to(device=dev, dtype=torch.int32))
    if template.ema is not None:
        if lora:
            ema_params = aux["lora_ema"]
        else:
            ema_dir = os.path.join(ckpt_dir, "unet_ema")
            ema_params = (ckpt_lib.load_unet_state(ema_dir) if os.path.isdir(ema_dir)
                          else params)
        _restore(template.ema.params, shard_host_tree(ema_params, layout), "ema")
        template.ema = ema_lib.EMAState(template.ema.params,
                                        torch.tensor(aux["ema_step"], dtype=torch.int32,
                                                     device=dev))
    step = int(aux["step"])
    template.step = torch.tensor(step, dtype=torch.int32, device=dev)
    return template, step
