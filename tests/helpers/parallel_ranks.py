"""One rank of `tests/test_torch_parallel.py` (run by
`helpers.torch_ranks.run_ranks`, gloo on the CPU, no JAX).

    python tests/helpers/parallel_ranks.py <inputs.pt> <out_dir> <mode>

Modes, each on a ("data",) mesh of the whole world:

  - train: two training steps (gas 2, tiny f32) data-parallel, then two
    under FSDP (born sharded, leaves of >= 16 elements split), each rank
    on its rows of the global batch and its images' noise; the losses,
    grad norms and whole parameters after each step, and the shapes of the
    FSDP state's leaves;
  - serve: the episode `predict` and the support cache (`precompute_supports`
    at batch 1 and 4, `predict_cached`) under the data mesh; and the step
    at which `StopVote` stops each rank when rank 1 alone raises its stop
    flag from step 2 on;
  - ckpt (two nodes of one rank): an FSDP state with set values written
    sharded, then resumed into a fresh sharded state.
"""

import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from diffews_tpu_torch import checkpoint as TC  # noqa: E402
from diffews_tpu_torch import configs as TCF  # noqa: E402
from diffews_tpu_torch.cli.train import _rank_noise  # noqa: E402
from diffews_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from diffews_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from diffews_tpu_torch.parallel import mesh as M  # noqa: E402
from diffews_tpu_torch.pipeline import DiffewsPipeline  # noqa: E402
from diffews_tpu_torch.training import checkpoints as tck  # noqa: E402
from diffews_tpu_torch.training import state as tstate  # noqa: E402

MIN_ELEMS = 16


def _models(inp):
    unet = UNet2DConditionModel(TCF.UNetConfig.tiny())
    unet.load_state_dict(inp["unet_sd"])
    vae = AutoencoderKL(TCF.VAEConfig.tiny())
    vae.load_state_dict(inp["vae_sd"])
    return unet, vae.requires_grad_(False)


def set_values(state, full, layout=None):
    """Distinct values in every slot of a fresh state, from the whole
    weights `full`: mu = params/2 (bf16), nu = params², EMA = 2·params."""
    shard = (lambda n, t: t) if layout is None else layout.shard  # noqa: E731
    with torch.no_grad():
        for n, p in full.items():
            state.opt_state.mu[n].copy_(shard(n, p / 2))
            state.opt_state.nu[n].copy_(shard(n, p * p))
            state.ema.params[n].copy_(shard(n, 2 * p))
    state.opt_state.count = torch.tensor(3, dtype=torch.int32)
    state.step = torch.tensor(5, dtype=torch.int32)
    state.ema.step = torch.tensor(5, dtype=torch.int32)


def _train(inp, mesh, res):
    group = M.axis_group(mesh, "data")
    tcfg = tstate.TrainerConfig(**inp["tcfg"])
    b, n = inp["batches"][0]["supports"].shape[1:3]
    rows = M.rows(b, M.axis_size(mesh, "data"), M.axis_rank(mesh, "data"))
    for mode in ("dp", "fsdp"):
        unet, vae = _models(inp)
        params = {k: p.detach().clone() for k, p in unet.named_parameters()}
        if mode == "dp":
            state, layout = tstate.init_state(tcfg, params, device="cpu"), None
            step = tstate.make_train_step(tcfg, unet, data_group=group)
        else:
            state, layout = M.init_state_fsdp(tcfg, params, mesh, device="cpu",
                                              fsdp_min_elems=MIN_ELEMS)
            step = tstate.make_train_step(tcfg, unet, layout=layout)
            res["fsdp_shapes"] = {k: (tuple(params[k].shape), tuple(state.params[k].shape),
                                      tuple(state.opt_state.mu[k].shape),
                                      tuple(state.opt_state.nu[k].shape),
                                      tuple(state.ema.params[k].shape), layout.dims[k])
                                  for k in params}
        out = []
        for batch, noise in zip(inp["batches"], inp["noises"]):
            local = M.put_global_batch(batch, mesh)
            state, m = step(state, local, _rank_noise(noise, b, n, rows, False), vae,
                            inp["text"])
            out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "params": tck.host_fetch(state.params, layout)})
        res[mode] = out


def _serve(inp, mesh, res):
    bundle = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
    bundle.unet.load_state_dict(inp["unet_sd"])
    bundle.vae.load_state_dict(inp["vae_sd"])
    pipe = DiffewsPipeline(bundle, device="cpu", mesh=mesh)
    for key, e in inp["episodes"].items():
        res[key] = pipe.predict(e["q"], e["sup"], e["msk"], shot_mask=e["sm"],
                                r_threshold=0.25).seg_colored
    e = inp["episodes"]["b4n2"]
    for cb in (1, 4):
        cache = pipe.precompute_supports(e["sup"][:cb], e["msk"][:cb], shot_mask=e["sm"][:cb])
        res[f"cached_b{cb}"] = pipe.predict_cached(e["q"], cache).seg_colored


def _ckpt(inp, mesh, out_dir, res):
    tcfg = tstate.TrainerConfig(**inp["tcfg"])
    full = {k: v.clone() for k, v in inp["unet_sd"].items()}
    state, layout = M.init_state_fsdp(tcfg, full, mesh, device="cpu", fsdp_min_elems=MIN_ELEMS)
    set_values(state, full, layout)
    res["host"] = (M.host_index(), M.host_count())
    res["sharded"] = sorted(k for k in full if layout.sharded(k))
    got = tck.save_checkpoint(out_dir, 5, state, TCF.UNetConfig.tiny(), layout=layout,
                              write=M.rank() == 0)
    assert (got is not None) == (M.rank() == 0)
    dist.barrier()
    fresh, layout2 = M.init_state_fsdp(tcfg, full, mesh, device="cpu",
                                       fsdp_min_elems=MIN_ELEMS)
    fresh, step = tck.load_checkpoint(os.path.join(out_dir, "checkpoint-5"), fresh,
                                      layout=layout2)
    same = step == 5 and int(fresh.opt_state.count) == 3 and int(fresh.ema.step) == 5
    for a, b in ((state.params, fresh.params), (state.opt_state.mu, fresh.opt_state.mu),
                 (state.opt_state.nu, fresh.opt_state.nu), (state.ema.params, fresh.ema.params)):
        same &= all(torch.equal(a[k], b[k]) and a[k].shape == b[k].shape for k in a)
    res["resumed_equal"] = same


def _vote(mesh, res):
    vote = M.StopVote(M.axis_group(mesh, "data"), "cpu")
    res["vote_stop_step"] = next((step for step in range(6)
                                  if vote(M.rank() == 1 and step >= 2)), None)


def main():
    inp = torch.load(sys.argv[1], weights_only=False)
    out_dir, mode = sys.argv[2], sys.argv[3]
    M.maybe_initialize_distributed(device_type="cpu")
    mesh = M.make_mesh("cpu", 2)
    res = {}
    if mode == "train":
        _train(inp, mesh, res)
        _serve(inp, mesh, res)
        _vote(mesh, res)
    else:
        _ckpt(inp, mesh, out_dir, res)
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
