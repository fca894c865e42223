"""Port parity of tensor parallelism (`parallel/mesh.py`'s rules and
layout, `parallel/tensor_parallel.py`, the UNet's `model_group`, the
sharded training step and the train CLI's `--num_model_shards`) against
the JAX package.

  - The spec tree: `param_pspec_tree` of the port's UNet and CLIP text
    trees equals JAX's `param_pspec_tree` dim for dim (JAX's (in, out)
    kernels mapped onto torch's (out, in) and conv weights' order), with
    and without tensor parallelism, with and without FSDP, at JAX's test
    pair (data=4, model=2).
  - The forward: 4 gloo ranks on the CPU (`helpers/tp_ranks.py`) run the
    tiny UNet with their tensor-parallel parts on their data rows at
    (data=2, model=2) and (data=1, model=4), against JAX's forward with
    `shard_params(tensor_parallel=True)` on the same meshes of the virtual
    CPU devices, at `tests/test_training.py`'s rtol 1e-4 / atol 1e-5.  At
    model=4 the level-0 attention's 2 heads do not divide the axis: ranks
    2 and 3 hold none.
  - Two training steps (gas 2, f32, remat, a padded shot) at (data=2,
    model=2), plain and under FSDP, against JAX's step on the same
    tensor-parallel mesh, at JAX's test's default lr: loss and grad norm
    rtol 1e-4, params rtol 1e-4 / atol 1e-6 but at JAX's first moments'
    noise-level entries (`test_steps_match_jax`).  The state holds parts:
    no rank holds a whole master or moment of a split leaf.
  - The train CLI with `--num_model_shards 2` as 2 ranks
    (`helpers/cli_ranks.py`) against the JAX CLI with the same flags on 2
    of the virtual devices: losses and the final `unet/` (written once, in
    the unsharded layout) under `test_torch_train_cli.py`'s bf16-moment
    rule; a resume of checkpoint-2 lands on the straight run's
    checkpoint-4 bit for bit.  With `--lora_rank` the adapters stay
    replicated: the 2 ranks write one process's checkpoint bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from diffews_tpu.cli import train as JT
from diffews_tpu_torch.cli import train as TT
from diffews_tpu.configs import CLIPTextConfig
from diffews_tpu.models import clip_text as JCT
from diffews_tpu.models import unet as JU
from diffews_tpu.parallel import mesh as jmesh
from diffews_tpu.training import state as jstate
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.models.clip_text import CLIPTextModel
from diffews_tpu_torch.parallel import mesh as M
from diffews_tpu_torch.parallel import tensor_parallel as tp
from diffews_tpu_torch.training import checkpoints as tck
from diffews_tpu_torch.training import state as tstate
from helpers.torch_ranks import run_ranks
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_cli import (GAS, LR, NSHOT, PX, STEPS, B, _common, _jax_noise,  # noqa: F401
                                  _same_unet, check_losses_and_final_unet, workdir)
from test_torch_training import episode_batch, models, n_images  # noqa: F401

SCRIPT = "tests/helpers/tp_ranks.py"
CASES = [("forward_d2m2", 2, 2, "forward"), ("forward_d1m4", 1, 4, "forward"),
         ("step", 2, 2, "step"), ("step_fsdp", 2, 2, "step_fsdp")]
N_STEPS = 2


# -- the spec tree --------------------------------------------------------


def _torch_specs(jspecs, jparams) -> dict:
    """JAX's nested spec tree as the port's flat names and torch dims."""
    out = {}

    def rec(node, pnode, path):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, pnode[k], path + [k])
                continue
            spec = tuple(v) + (None,) * (np.ndim(pnode[k]) - len(tuple(v)))
            if k == "kernel":
                spec = (spec[3], spec[2], spec[0], spec[1]) if len(spec) == 4 else spec[::-1]
            out[".".join(path + ["bias" if k == "bias" else "weight"])] = \
                spec if any(spec) else ()

    rec(jspecs, jparams, [])
    return out


def _trees():
    ucfg = TCF.UNetConfig.tiny()
    from diffews_tpu.configs import UNetConfig
    from diffews_tpu_torch.models.unet import UNet2DConditionModel

    ju = jax.eval_shape(lambda r: JU.init_params(r, UNetConfig.tiny()), jax.random.PRNGKey(0))
    jc = jax.eval_shape(lambda r: JCT.init_params(r, CLIPTextConfig.tiny()),
                        jax.random.PRNGKey(0))
    return {"unet": (ju, dict(UNet2DConditionModel(ucfg).named_parameters())),
            "clip": (jc, dict(CLIPTextModel(TCF.CLIPTextConfig.tiny()).named_parameters()))}


@pytest.mark.parametrize("fsdp", [None, 4])
@pytest.mark.parametrize("tensor_parallel", [False, True])
@pytest.mark.parametrize("tree", ["unet", "clip"])
def test_spec_tree_matches_jax(tree, tensor_parallel, fsdp):
    jtree, params = _trees()[tree]
    for min_elems in (M._FSDP_MIN_ELEMS, 8):
        want = _torch_specs(jmesh.param_pspec_tree(jtree, tensor_parallel, fsdp,
                                                   fsdp_min_elems=min_elems), jtree)
        got = M.param_pspec_tree(params, tensor_parallel, fsdp, fsdp_min_elems=min_elems)
        assert set(got) == set(want)
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        assert not diff, diff
    model = [k for k, s in got.items() if "model" in s]
    assert bool(model) == tensor_parallel
    if tensor_parallel and fsdp and tree == "unet":
        # JAX's (data=4, model=2) test: a kernel carries both mesh axes
        assert any("data" in got[k] for k in model)


def test_part_splits_whole_heads_unevenly():
    """5 heads of 64 over 2 ranks: 3 + 2; 2 heads over 4: 1, 1, 0, 0; the
    GEGLU halves' blocks line up with `ff.net.2`'s columns."""
    assert [tp.part(320, 2, r, 64) for r in range(2)] == [(0, 192), (192, 320)]
    assert [tp.part(32, 4, r, 16) for r in range(4)] == [(0, 16), (16, 32), (32, 32),
                                                         (32, 32)]
    assert tp.halves(1280, 2, 1) == [(640, 1280), (1920, 2560)]
    with pytest.raises(ValueError, match="multiple"):
        tp.part(30, 2, 0, 16)


# -- forward and steps on ranks ---------------------------------------------


def _cfgs():
    common = dict(max_train_steps=10, attn_mask_variant=False)
    return (jstate.TrainerConfig(compute_dtype=jnp.float32, adam_mu_dtype=jnp.float32,
                                 attn_impl="xla", gradient_accumulation_steps=GAS,
                                 remat=False, **common),
            tstate.TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                                 attn_impl="auto", remat=True, **common))


@pytest.fixture(scope="module")
def case(models, tmp_path_factory):
    """The inputs, each rank's results and JAX's on the same meshes."""
    ucfg, vcfg, up, vp, unet, vae, text = models
    jcfg, tcfg = _cfgs()
    root = tmp_path_factory.mktemp("tensor_parallel")
    r = np.random.default_rng(0)
    fwd = {"x": r.normal(size=(2, 8, 8, 4)).astype(np.float32),
           "ctx": r.normal(size=(2, 2, ucfg.cross_attention_dim)).astype(np.float32),
           "ref": r.normal(size=(2, 1, 8, 8, 8)).astype(np.float32)}
    batches = [episode_batch(GAS, seed=60 + i) for i in range(N_STEPS)]
    keys = [jax.random.PRNGKey(70 + i) for i in range(N_STEPS)]
    shape = (n_images(batches[0], False), 16, 16, 4)
    noises = [np.stack([np.array(jax.random.normal(k, shape))
                        for k in jax.random.split(key, GAS)]) for key in keys]
    inp = {"unet_sd": state_dict_from_jax(up), "vae_sd": state_dict_from_jax(vp),
           "tcfg": {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)},
           "text": torch.from_numpy(text), "forward": fwd, "cases": CASES,
           "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
           "noises": [torch.from_numpy(n) for n in noises]}
    torch.save(inp, root / "inputs.pt")
    run_ranks([SCRIPT, str(root / "inputs.pt"), str(root), "cpu"], 4, timeout=120)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)]

    # JAX: the forward and the steps with tensor-parallel params
    fwd_jit = jax.jit(JU.forward, static_argnames=("cfg",))
    jax_fwd = {}
    for name, nd, nm, kind in CASES:
        if kind != "forward":
            continue
        m = jmesh.make_mesh(n_data=nd, n_model=nm)
        xs = jax.device_put(jnp.asarray(fwd["x"]), NamedSharding(m, P("data")))
        jax_fwd[name] = np.asarray(fwd_jit(jmesh.shard_params(up, m, tensor_parallel=True),
                                           ucfg, xs, 1, jnp.asarray(fwd["ctx"]),
                                           ref_sample=jnp.asarray(fwd["ref"])))
    m = jmesh.make_mesh(n_data=2, n_model=2)
    jst = jstate.init_state(jcfg, up)
    jst = jst._replace(params=jmesh.shard_params(jst.params, m, tensor_parallel=True))
    jstep, jax_steps = jax.jit(jstate.make_train_step(jcfg, ucfg, vcfg)), []
    for batch, key in zip(batches, keys):
        sharded = {k: jax.device_put(v, NamedSharding(m, P(None, "data")))
                   for k, v in batch.items()}
        jst, jm = jstep(jst, sharded, key, vp, jnp.asarray(text))
        mu = state_dict_from_jax(jax.device_get(jst.opt_state.inner_state[1][0].mu))
        jax_steps.append({"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
                          "params": state_dict_from_jax(jax.device_get(jst.params)),
                          "mu": mu})
    return {"ranks": ranks, "jax_fwd": jax_fwd, "jax_steps": jax_steps, "unet": unet}


@pytest.mark.parametrize("name", ["forward_d2m2", "forward_d1m4"])
def test_forward_matches_jax(case, name):
    want = case["jax_fwd"][name]
    for r, res in enumerate(case["ranks"]):
        got = res[name]
        a, b = got["rows"]
        np.testing.assert_allclose(got["out"].numpy(), want[a:b], rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {r}")
    heads = [res[name]["heads"] for res in case["ranks"]]
    level0 = [h["down_blocks.0.attentions.0.transformer_blocks.0.attn1"] for h in heads]
    # every rank holds whole heads; all of each site's heads are held once
    n_model = 2 if name == "forward_d2m2" else 4
    for site in heads[0]:
        held = [h[site] for h in heads[:n_model]]
        assert sum(held) == case["unet"].get_submodule(site).heads, (site, held)
    assert level0 == ([1, 1, 1, 1] if n_model == 2 else [1, 1, 0, 0])


@pytest.mark.parametrize("mode", ["step", "step_fsdp"])
def test_steps_match_jax(case, mode):
    """Loss and grad norm rtol 1e-4; the params within rtol 1e-4 / atol
    1e-6 but where JAX's first moment after some step is at noise level
    (≤ 1e-2 of its leaf's largest: Adam's first steps scale a near-zero
    gradient to a full-size update, so float noise moves it by up to lr,
    `test_torch_parallel.py`'s rule), within 2·lr a step everywhere, and
    on all but 1e-3 of the entries."""
    lr, noisy = 1e-5, None
    for i, js in enumerate(case["jax_steps"]):
        small = {n: np.abs(m.numpy()) <= 1e-2 * np.abs(m.numpy()).max()
                 for n, m in js["mu"].items()}
        noisy = small if noisy is None else {n: noisy[n] | small[n] for n in small}
        for r, res in enumerate(case["ranks"]):
            got = res[mode]["steps"][i]
            np.testing.assert_allclose(got["loss"], js["loss"], rtol=1e-4)
            np.testing.assert_allclose(got["grad_norm"], js["grad_norm"], rtol=1e-4)
            assert set(got["params"]) == set(js["params"])
            off = total = 0
            for k, p in got["params"].items():
                w = js["params"][k].numpy()
                d = np.abs(p.numpy() - w)
                bad = d > 1e-6 + 1e-4 * np.abs(w)
                assert not (bad & ~noisy[k]).any(), (mode, r, i, k, d[bad & ~noisy[k]].max())
                assert d.max() <= 2 * lr * (i + 1), (mode, r, i, k, d.max())
                off, total = off + bad.sum(), total + bad.size
            assert off <= 1e-3 * total, (mode, r, i, off, total)


@pytest.mark.parametrize("mode", ["step", "step_fsdp"])
def test_state_holds_parts(case, mode):
    """The ranks hold the same whole model after each step; each rank's
    master and first moment of a split leaf are its part: a head-aligned
    block of the "model" dim (and half of the "data" dim under FSDP); the
    specs are `param_pspec_tree`'s."""
    res = [r[mode] for r in case["ranks"]]
    for a in res[1:]:
        for sa, sb in zip(res[0]["steps"], a["steps"]):
            assert sa["loss"] == sb["loss"]
            assert all(torch.equal(sa["params"][k], sb["params"][k]) for k in sa["params"])
    n_split = 0
    for r, rr in enumerate(res):
        mrank = r % 2
        for k, (full, part, mu, spec) in rr["shapes"].items():
            want = list(full)
            if "model" in spec:
                d = spec.index("model")
                unit = 16 if "attn" in k else 1
                size = full[d] // 2 if k.endswith("ff.net.0.proj.weight") else full[d]
                a, b = tp.part(size, 2, mrank, unit)
                want[d] = (b - a) * (2 if k.endswith("ff.net.0.proj.weight") else 1)
                n_split += 1
            if "data" in spec:
                want[spec.index("data")] //= 2
            assert part == mu == tuple(want), (r, k, full, part, mu, spec)
    assert n_split > 0


# -- the train CLI ------------------------------------------------------------


N_IMG = 2 * B + 2 * B * NSHOT


@pytest.fixture(scope="module")
def jax_cli(workdir, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_tp")
    JT.main(_common(workdir, root / "out", "--learning_rate", str(LR),
                    "--num_model_shards", "2", "--metrics_jsonl", str(root / "jax.jsonl")))
    lh = PX // 2  # the tiny VAE downsamples once
    torch.save([_jax_noise(0, s, (GAS, N_IMG, lh, lh, 4)) for s in range(STEPS)],
               root / "noise.pt")
    return root, [json.loads(line) for line in open(root / "jax.jsonl")]


def test_two_rank_tp_cli_matches_jax_and_resumes(workdir, jax_cli, tmp_path):
    root, jlog = jax_cli
    out = tmp_path / "out"
    argv = _common(workdir, out, "--learning_rate", str(LR), "--device", "cpu",
                   "--num_model_shards", "2", "--checkpointing_steps", "1")
    run_ranks(["tests/helpers/cli_ranks.py", "train", str(tmp_path), str(root / "noise.pt"),
               "--", *argv], 2, timeout=240)
    r0, r1 = (json.load(open(tmp_path / f"rank{r}.json")) for r in range(2))
    assert r0["global_step"] == r1["global_step"] == STEPS
    assert r1["log"] == [] and r1["saves"] == [] and r0["saves"] == [1, 2, 3, 4]
    check_losses_and_final_unet(out, root / "out", jlog, {"log": r0["log"]},
                                exact=2 ** -8 * LR * STEPS)
    state = tck.read_train_state(str(out / f"checkpoint-{STEPS}"))
    unet = _trees()["unet"][1]
    assert {k: tuple(v.shape) for k, v in state["opt_state"]["mu"].items()} == \
        {k: tuple(v.shape) for k, v in unet.items()}

    # resume checkpoint-2 in a fresh directory: checkpoint-4 bit for bit
    resumed = tmp_path / "resumed"
    (tmp_path / "r").mkdir()
    argv = _common(workdir, resumed, "--learning_rate", str(LR), "--device", "cpu",
                   "--num_model_shards", "2", "--resume_from_checkpoint",
                   str(out / "checkpoint-2"))
    run_ranks(["tests/helpers/cli_ranks.py", "train", str(tmp_path / "r"),
               str(root / "noise.pt"), "--", *argv], 2, timeout=240)
    _same_unet(resumed / f"checkpoint-{STEPS}" / "unet", out / f"checkpoint-{STEPS}" / "unet")
    a = tck.read_train_state(str(resumed / f"checkpoint-{STEPS}"))["opt_state"]
    b = state["opt_state"]
    assert all(torch.equal(a["mu"][k], b["mu"][k]) and torch.equal(a["nu"][k], b["nu"][k])
               for k in b["mu"])


def test_tp_cli_lora_keeps_adapters_replicated(workdir, jax_cli, tmp_path):
    """`--lora_rank` under a model axis: the adapters stay replicated over
    "model" (JAX's LoRA path never shards), so the 2 ranks' run writes the
    checkpoint of one process on the same noise, bit for bit."""
    root, _ = jax_cli
    noise = torch.load(root / "noise.pt", weights_only=True)
    common = lambda out, *extra: _common(  # noqa: E731
        workdir, out, "--learning_rate", str(LR), "--device", "cpu", "--lora_rank", "2",
        "--max_train_steps", "2", *extra)
    run_ranks(["tests/helpers/cli_ranks.py", "train", str(tmp_path), str(root / "noise.pt"),
               "--", *common(tmp_path / "tp", "--num_model_shards", "2")], 2, timeout=240)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "step_noise", lambda seed, step, shape: noise[step].clone())
        TT.main(common(tmp_path / "one"))
    _same_unet(tmp_path / "tp" / "checkpoint-2" / "unet",
               tmp_path / "one" / "checkpoint-2" / "unet")
    a = tck.read_train_state(str(tmp_path / "tp" / "checkpoint-2"))["lora"]
    b = tck.read_train_state(str(tmp_path / "one" / "checkpoint-2"))["lora"]
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
