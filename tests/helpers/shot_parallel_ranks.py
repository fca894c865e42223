"""One rank of `tests/test_torch_shot_parallel.py` (run by
`helpers.torch_ranks.run_ranks`, gloo on the CPU, no JAX).

    python tests/helpers/shot_parallel_ranks.py <inputs.pt> <out_dir> <n_data> <n_shots>

Builds the ("shots",) mesh (n_data 1) or the ("data", "shots") mesh, runs
on this rank's shard of shots (and rows) what the test holds against the
JAX package, and writes the results to `<out_dir>/rank<r>.pt`:

  - ("shots",): `shot_parallel_fused_kv_attention` dense and flash (the
    plain version) with no mask, padded shots (whole ranks padded) and the
    attn-mask support bias, and the dense path's gradients with respect to
    the local support K/V; the tiny UNet's joint forward, plain and under
    the attn-mask variant; the episode `predict` and its n-shot error;
  - ("data", "shots"): the episode `predict`.
"""

import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from diffews_tpu_torch import checkpoint as TC  # noqa: E402
from diffews_tpu_torch import configs as TCF  # noqa: E402
from diffews_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from diffews_tpu_torch.ops.attention import shot_parallel_fused_kv_attention  # noqa: E402
from diffews_tpu_torch.parallel import mesh as M  # noqa: E402
from diffews_tpu_torch.pipeline import DiffewsPipeline  # noqa: E402


def _op(inp, group, k, n_shots, res):
    q, ko, vo, ks, vs = (inp["op"][x] for x in ("q", "ko", "vo", "ks", "vs"))
    n = ks.shape[1] // n_shots
    sl = slice(k * n, (k + 1) * n)
    mask, bias = inp["op"]["mask"], inp["op"]["bias"]
    b = q.shape[0]
    for impl in ("dense", "flash"):
        run = lambda **kw: shot_parallel_fused_kv_attention(  # noqa: E731
            q, ko, vo, ks[:, sl], vs[:, sl], group=group, impl=impl, **kw)
        with torch.no_grad():
            res[f"op_{impl}"] = run()
            res[f"op_{impl}_mask"] = run(shot_mask=mask[:, sl])
            res[f"op_{impl}_bias"] = run(support_bias=bias[:, sl].reshape(b, -1))
    ks_l = ks[:, sl].clone().requires_grad_(True)
    vs_l = vs[:, sl].clone().requires_grad_(True)
    out = shot_parallel_fused_kv_attention(q, ko, vo, ks_l, vs_l, group=group, impl="dense")
    # every rank holds the whole output: the loss counts it once in all
    ((out ** 2).sum() / dist.get_world_size(group)).backward()
    res["op_grad_ks"], res["op_grad_vs"] = ks_l.grad, vs_l.grad


def _unet(inp, group, k, n_shots, res):
    u = inp["unet"]
    model = UNet2DConditionModel(TCF.UNetConfig.tiny())
    model.load_state_dict(inp["unet_sd"])
    for name, key in (("unet", "ref"), ("unet_am", "ref_am")):
        ref = u[key]
        n = ref.shape[1] // n_shots
        sl = slice(k * n, (k + 1) * n)
        kw = ({"shot_mask": u["mask"][:, sl]} if name == "unet"
              else {"ref_mask": u["rmask"][:, sl]})
        sample, ctx = u["sample"], u["ctx"]
        if name == "unet_am":
            sample, ctx = sample[:1], ctx[:1]
        with torch.no_grad():
            res[name] = model(sample, 1, ctx, ref_sample=ref[:, sl], attn_impl="dense",
                              shot_group=group, **kw)


def _pipeline(inp, mesh, key, res):
    bundle = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
    bundle.unet.load_state_dict(inp["unet_sd"])
    bundle.vae.load_state_dict(inp["vae_sd"])
    pipe = DiffewsPipeline(bundle, device="cpu", shot_mesh=mesh)
    e = inp[key]
    out = pipe.predict(e["q"], e["sup"], e["msk"], shot_mask=e["sm"], r_threshold=0.25)
    res[key] = torch.from_numpy(out.seg_colored)
    if key == "episode_shots":
        try:
            pipe.predict(e["q"], e["sup"][:, :3], e["msk"][:, :3], r_threshold=0.25)
        except ValueError as err:
            res["indivisible_error"] = str(err)


def main():
    inp = torch.load(sys.argv[1], weights_only=False)
    out_dir, n_data, n_shots = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    M.maybe_initialize_distributed(device_type="cpu")
    mesh = M.make_shot_mesh("cpu", n_shots, n_data=n_data)
    res = {}
    if n_data == 1:
        group, k = M.axis_group(mesh, "shots"), M.axis_rank(mesh, "shots")
        _op(inp, group, k, n_shots, res)
        _unet(inp, group, k, n_shots, res)
        _pipeline(inp, mesh, "episode_shots", res)
    else:
        _pipeline(inp, mesh, "episode_data_shots", res)
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
