"""One rank of the tensor-parallel tests (`tests/test_torch_tensor_parallel.py`
on the CPU, `tests/test_torch_parallel_gpu.py` on the card), run by
`helpers.torch_ranks.run_ranks` over gloo (which also carries CUDA tensors
through `all_reduce`), without JAX.

    python tests/helpers/tp_ranks.py <inputs.pt> <out_dir> <device>

`inputs.pt` holds the tiny UNet's and VAE's state dicts, the trainer
config's fields, the text embedding, the batches and noises of the steps,
the forward's inputs, and `cases`: (name, n_data, n_model, kind) run in
turn on a ("data", "model") mesh of the whole world, kind one of

  - forward: the UNet's forward (remat off, no grad) on this rank's data
    rows with this rank's tensor-parallel parts bound (`shard_params`);
    the output rows and the rank's head count at each attention site;
  - step / step_fsdp: training steps on a state born sharded
    (`init_state_sharded`, tensor parallel, FSDP over "data" with leaves of
    >= 16 elements for step_fsdp), each rank on its rows of the global
    batch and its images' noise; the losses, grad norms, the whole
    (gathered) parameters after each step and the parts' shapes.

Each rank writes `<out_dir>/rank<r>.pt`.
"""

import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from diffews_tpu_torch import configs as TCF  # noqa: E402
from diffews_tpu_torch.cli.train import _rank_noise  # noqa: E402
from diffews_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from diffews_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from diffews_tpu_torch.parallel import mesh as M  # noqa: E402
from diffews_tpu_torch.training import checkpoints as tck  # noqa: E402
from diffews_tpu_torch.training import state as tstate  # noqa: E402

MIN_ELEMS = 16


def _models(inp, device):
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    unet = UNet2DConditionModel(TCF.UNetConfig.tiny())
    unet.load_state_dict(inp["unet_sd"])
    vae = AutoencoderKL(TCF.VAEConfig.tiny())
    vae.load_state_dict(inp["vae_sd"])
    return unet, vae.to(device, memory_format=fmt).requires_grad_(False)


def _forward(inp, mesh, device):
    unet, _ = _models(inp, device)
    unet = unet.to(device, memory_format=(torch.channels_last if device.type == "cuda"
                                          else torch.contiguous_format))
    params = {k: p.detach() for k, p in unet.named_parameters()}
    parts, layout = M.shard_params(params, mesh, tensor_parallel=True,
                                   units=M.tp_units(unet))
    f = inp["forward"]
    rows = M.rows(f["x"].shape[0], M.axis_size(mesh, "data"), M.axis_rank(mesh, "data"))
    put = lambda a: torch.as_tensor(a)[rows].to(device)  # noqa: E731
    with torch.no_grad(), tstate.bind_params(unet, parts):
        out = unet(put(f["x"]), 1, put(f["ctx"]), ref_sample=put(f["ref"]),
                   model_group=layout.model_group)
    heads = {n[:-len(".to_q.weight")]: parts[n].shape[0] // unet.get_submodule(
                 n[:-len(".to_q.weight")]).head_dim
             for n in parts if n.endswith("attn1.to_q.weight")}
    return {"rows": (rows.start, rows.stop), "out": out.float().cpu(), "heads": heads}


def _steps(inp, mesh, device, fsdp):
    unet, vae = _models(inp, device)
    tcfg = tstate.TrainerConfig(**inp["tcfg"])
    params = {k: p.detach().clone() for k, p in unet.named_parameters()}
    state, layout = M.init_state_sharded(tcfg, params, mesh, tensor_parallel=True, fsdp=fsdp,
                                         units=M.tp_units(unet), device=device,
                                         fsdp_min_elems=MIN_ELEMS)
    step = tstate.make_train_step(tcfg, unet, layout=layout)
    b, n = inp["batches"][0]["supports"].shape[1:3]
    rows = M.rows(b, M.axis_size(mesh, "data"), M.axis_rank(mesh, "data"))
    text = inp["text"].to(device)
    out = []
    for batch, noise in zip(inp["batches"], inp["noises"]):
        local = {k: v.to(device) for k, v in M.put_global_batch(batch, mesh).items()}
        state, m = step(state, local, _rank_noise(noise, b, n, rows, False).to(device), vae,
                        text)
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "params": {k: v.cpu() for k, v in tck.host_fetch(state.params,
                                                                     layout).items()}})
    shapes = {k: (tuple(params[k].shape), tuple(state.params[k].shape),
                  tuple(state.opt_state.mu[k].shape), layout.specs[k]) for k in params}
    return {"steps": out, "shapes": shapes}


def main():
    inp = torch.load(sys.argv[1], weights_only=False)
    out_dir, device = sys.argv[2], torch.device(sys.argv[3])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    M.maybe_initialize_distributed(device_type="cpu")
    res = {}
    for name, n_data, n_model, kind in inp["cases"]:
        mesh = M.make_mesh("cpu", n_data, n_model)
        res[name] = (_forward(inp, mesh, device) if kind == "forward"
                     else _steps(inp, mesh, device, fsdp=kind == "step_fsdp"))
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
