"""The shot merge and tensor parallelism on the card.

The shot merge: `shot_parallel_fused_kv_attention` through
the flash kernel's `flash_attention_lse` route, as 2 ranks over gloo on
one card (`helpers/shot_merge_ranks.py`; NCCL refuses two ranks on one
device, and gloo's all_reduce takes CUDA tensors).

Held, in f32 (TF32 off) and bf16, with every shot valid and with shots
1-3 padded (rank 1 then holds no valid key): each rank's merged output is
finite and within 1e-4 (f32) or 2e-2 (bf16) of the largest value of the
unsharded `fused_kv_attention` on the card and of the f32 dense attention;
the empty shard's own `flash_attention_lse` gives O = 0 and LSE = -inf on
every row (the kernel's empty-row branch), so its weight in the merge is
exactly 0.

Tensor parallelism (`helpers/tp_ranks.py` on "cuda", 2 ranks over gloo):
the tiny UNet's forward and two f32 (TF32 off) training steps at gas 2
with remat, plain and under FSDP, on a (data=1, model=2) mesh, each rank
holding whole heads (1 + 1 at level 0, 2 + 2 at level 1), against the same
forward and steps in this process on the card: the forward within rtol
1e-4 / atol 1e-5, loss rtol 1e-5, grad norm rtol 1e-4, params within
1e-3·lr but where the first moment is at noise level (phase tiny_train's
rule).

Marked `gpu`: skips without a CUDA device.  This file imports no JAX; run
it on the GPU host with

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers.torch_ranks import run_ranks

pytestmark = pytest.mark.gpu
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}


def test_shot_merge_with_flash_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run_ranks(["tests/helpers/shot_merge_ranks.py", str(tmp_path)], 2, timeout=300)
    for r in range(2):
        res = json.load(open(tmp_path / f"rank{r}.json"))
        for dtype, tol in TOL.items():
            for case in ("all_valid", "shots_1_3_padded"):
                got = res[f"{dtype}_{case}"]
                assert got["finite"], (r, dtype, case)
                assert got["vs_flash"] <= tol and got["vs_dense"] <= tol, (r, dtype, case, got)
            if r == 1:
                empty = res[f"{dtype}_empty_shard"]
                assert empty["max_abs_o"] == 0.0 and empty["lse_all_neg_inf"], (dtype, empty)


def _tp_inputs():
    from diffews_tpu_torch import configs as TCF
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.training import state as tstate
    from diffews_tpu_torch.utils.init import build_module

    unet = build_module(UNet2DConditionModel, TCF.UNetConfig.tiny(), seed=0)
    vae = build_module(AutoencoderKL, TCF.VAEConfig.tiny(), seed=1)
    tcfg = tstate.TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                                learning_rate=1e-3, max_train_steps=10, remat=True)
    r = np.random.default_rng(0)
    gas, b, n = 2, 2, 2

    def batch():
        f = lambda *s: torch.from_numpy(r.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
        sm = torch.ones(gas, b, n, dtype=torch.bool)
        sm[:, 0, 1] = False  # one padded shot
        return {"query": f(gas, b, 32, 32, 3), "q_mask3": f(gas, b, 32, 32, 3),
                "supports": f(gas, b, n, 32, 32, 3), "s_mask3": f(gas, b, n, 32, 32, 3),
                "shot_mask": sm}

    return {"unet_sd": unet.state_dict(), "vae_sd": vae.state_dict(),
            "tcfg": {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)},
            "text": torch.from_numpy((0.5 * r.normal(size=(1, 77, 32))).astype(np.float32)),
            "batches": [batch(), batch()],
            "noises": [torch.from_numpy(r.normal(size=(gas, 2 * b + 2 * b * n, 16, 16, 4))
                                        .astype(np.float32)) for _ in range(2)],
            "forward": {"x": r.normal(size=(2, 8, 8, 4)).astype(np.float32),
                        "ctx": r.normal(size=(2, 2, 32)).astype(np.float32),
                        "ref": r.normal(size=(2, 1, 8, 8, 8)).astype(np.float32)},
            "cases": [("forward", 1, 2, "forward"), ("step", 1, 2, "step"),
                      ("step_fsdp", 1, 2, "step_fsdp")]}


def test_tensor_parallel_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffews_tpu_torch.training import state as tstate
    from helpers.tp_ranks import _models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = _tp_inputs()
    torch.save(inp, tmp_path / "inputs.pt")
    run_ranks(["tests/helpers/tp_ranks.py", str(tmp_path / "inputs.pt"), str(tmp_path), "cuda"],
              2, timeout=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    dev = torch.device("cuda")
    unet, vae = _models(inp, dev)
    unet = unet.to(dev, memory_format=torch.channels_last)
    f = {k: torch.from_numpy(v).to(dev) for k, v in inp["forward"].items()}
    with torch.no_grad():
        want = unet(f["x"], 1, f["ctx"], ref_sample=f["ref"]).float().cpu()
    for r, res in enumerate(ranks):
        got = res["forward"]
        assert got["rows"] == (0, 2)
        np.testing.assert_allclose(got["out"].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert set(got["heads"].values()) == {1, 2}, got["heads"]

    tcfg = tstate.TrainerConfig(**inp["tcfg"])
    state = tstate.init_state(tcfg, dict(unet.named_parameters()), device=dev)
    step = tstate.make_train_step(tcfg, unet)
    lr, noisy = tcfg.learning_rate, None
    for i, (batch, noise) in enumerate(zip(inp["batches"], inp["noises"])):
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()}, noise.to(dev), vae,
                        inp["text"].to(dev))
        mu = {k: v.abs().cpu() for k, v in state.opt_state.mu.items()}
        small = {k: v <= 1e-2 * v.max() for k, v in mu.items()}
        noisy = small if noisy is None else {k: noisy[k] | small[k] for k in small}
        for mode in ("step", "step_fsdp"):
            for r, res in enumerate(ranks):
                got = res[mode]["steps"][i]
                np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
                np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
                off = total = 0
                for k, p in got["params"].items():
                    d = (p - state.params[k].detach().cpu()).abs()
                    bad = d > 1e-3 * lr
                    assert not (bad & ~noisy[k]).any(), (mode, r, i, k)
                    assert d.max() <= 2 * lr * (i + 1), (mode, r, i, k)
                    off, total = off + int(bad.sum()), total + bad.numel()
                assert off <= 1e-3 * total, (mode, r, i, off, total)
