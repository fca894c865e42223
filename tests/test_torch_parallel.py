"""Port parity of data-parallel training, FSDP and the data-mesh pipeline
(`diffews_tpu_torch/parallel/mesh.py`, `training/state.py`,
`training/checkpoints.py`, `pipeline.py`) against the JAX package.

The torch side runs as 2 gloo ranks on the CPU (`helpers/torch_ranks.py`,
`helpers/parallel_ranks.py`) on a ("data",) mesh:

  - two training steps (tiny, f32, gas 2, a padded shot) data-parallel and
    under FSDP (born sharded, leaves of >= 16 elements split), each rank on
    its row of the batch of 2 and its images' noise, against JAX's
    unsharded `make_train_step` and the port's unsharded step on the same
    inputs: `test_torch_train_step.py`'s rules (loss rtol 1e-5, grad norm
    rtol 1e-4, the params within 1e-3·lr where the first moment is above
    noise level);
  - the FSDP state's leaf shapes: no rank holds a whole float32 master,
    moment or EMA of a leaf the rule shards;
  - `predict` and `predict_cached` (batch-1 and batch-4 caches) under the
    data mesh against JAX's `predict` / `predict_cached`, within one uint8
    count on < 1% of pixels;
  - the depth head's raw map under the data mesh against JAX's unsharded
    depth head, within `helpers/depth_check.py`'s contract;
  - the preemption vote: every rank stops one step after the first flag;
  - two "hosts" of one rank each (mirroring `tests/test_multihost.py`): an
    FSDP state written sharded equals the same state written unsharded,
    bit for bit, and resumes to the same shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as JC
from diffews_tpu import pipeline as JP
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig
from diffews_tpu.parallel import mesh as jmesh
from diffews_tpu.training import state as jstate
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.parallel import mesh as M
from diffews_tpu_torch.training import checkpoints as tck
from diffews_tpu_torch.training import state as tstate
from diffews_tpu_torch import pipeline as TP
from helpers.depth_check import depth_close
from helpers.parallel_ranks import MIN_ELEMS, set_values
from helpers.torch_ranks import run_ranks
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_depth import _jax_raw, _mask3
from test_torch_training import _trainer_cfgs, episode_batch, models, n_images  # noqa: F401

SCRIPT = "tests/helpers/parallel_ranks.py"
GAS, STEPS = 2, 2


def _episode(b, n, seed):
    r = np.random.default_rng(seed)
    sm = np.ones((b, n), bool)
    if n > 1:
        sm[-1, -1] = False  # the last row's last shot padded
    return {"q": r.integers(0, 255, (b, 32, 32, 3), np.uint8),
            "sup": r.integers(0, 255, (b, n, 32, 32, 3), np.uint8),
            "msk": (r.random((b, n, 32, 32)) > 0.5).astype(np.uint8), "sm": sm}


@pytest.fixture(scope="module")
def case(models, tmp_path_factory):
    """The inputs, JAX's unsharded steps, and each rank's results."""
    ucfg, vcfg, up, vp, unet, vae, text = models
    jcfg, tcfg = _trainer_cfgs(False, GAS)
    root = tmp_path_factory.mktemp("parallel")
    batches = [episode_batch(GAS, seed=40 + i) for i in range(STEPS)]
    keys = [jax.random.PRNGKey(50 + i) for i in range(STEPS)]
    shape = (n_images(batches[0], False), 16, 16, 4)
    noises = [np.stack([np.array(jax.random.normal(k, shape))
                        for k in jax.random.split(key, GAS)]) for key in keys]
    episodes = {"b4n2": _episode(4, 2, 3), "b2n1": _episode(2, 1, 4)}
    tfields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    inp = {"unet_sd": state_dict_from_jax(up), "vae_sd": state_dict_from_jax(vp),
           "tcfg": tfields, "text": torch.from_numpy(text),
           "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
           "noises": [torch.from_numpy(n) for n in noises], "episodes": episodes}
    torch.save(dict(inp, tcfg=dict(tfields, use_ema=True)), root / "train.pt")
    torch.save(dict(inp, tcfg=dict(tfields, use_ema=True, adam_mu_dtype=torch.bfloat16)),
               root / "ckpt.pt")
    ranks = {}
    for mode, nodes in (("train", 1), ("ckpt", 2)):
        out = root / mode
        out.mkdir()
        run_ranks([SCRIPT, str(root / f"{mode}.pt"), str(out), mode], 2, nodes=nodes,
                  timeout=240)
        ranks[mode] = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]

    # JAX's unsharded steps on the same batches and noise
    jst, jax_steps = jstate.init_state(jcfg, up), []
    jstep = jax.jit(jstate.make_train_step(jcfg, ucfg, vcfg))
    for batch, key in zip(batches, keys):
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()}, key, vp,
                        jnp.asarray(text))
        mu = state_dict_from_jax(jax.device_get(jst.opt_state.inner_state[1][0].mu))
        jax_steps.append({"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
                          "params": state_dict_from_jax(jax.device_get(jst.params)),
                          "mu": mu})
    # the port's unsharded steps
    tst = tstate.init_state(tcfg, {n: p.detach().clone() for n, p in unet.named_parameters()},
                            device="cpu")
    tstep, port_steps = tstate.make_train_step(tcfg, unet), []
    for batch, noise in zip(inp["batches"], inp["noises"]):
        tst, tm = tstep(tst, batch, noise, vae, inp["text"])
        port_steps.append({"loss": float(tm["loss"]), "grad_norm": float(tm["grad_norm"]),
                           "params": {k: v.detach().clone() for k, v in tst.params.items()}})
    return {"inp": inp, "root": root, "ranks": ranks, "jax": jax_steps, "port": port_steps,
            "lr": tcfg.learning_rate, "models": models}


def _params_rule(got, want, noisy, lr, steps, what):
    """`test_torch_train_step.py`'s rule after `steps` steps."""
    off = total = 0
    for name, p in got.items():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        bad = d > 1e-3 * lr
        assert not (bad & ~noisy[name]).any(), (what, name, d[bad & ~noisy[name]].max() / lr)
        assert d.max() <= 2 * lr * steps, (what, name, d.max() / lr)
        off, total = off + bad.sum(), total + bad.size
    assert off <= 1e-3 * total, (what, off, total)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_train_steps_match_unsharded(case, mode):
    """Both ranks' losses, grad norms and (gathered) params after each step
    against JAX's unsharded step and the port's."""
    lr, noisy = case["lr"], None
    for i in range(STEPS):
        js, ps = case["jax"][i], case["port"][i]
        small = {n: np.abs(m.numpy()) <= 1e-2 * np.abs(m.numpy()).max()
                 for n, m in js["mu"].items()}
        noisy = small if noisy is None else {n: noisy[n] | small[n] for n in small}
        for r, res in enumerate(case["ranks"]["train"]):
            got = res[mode][i]
            np.testing.assert_allclose(got["loss"], js["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["loss"], ps["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], js["grad_norm"], rtol=1e-4)
            np.testing.assert_allclose(got["grad_norm"], ps["grad_norm"], rtol=1e-4)
            assert set(got["params"]) == set(js["params"])
            _params_rule(got["params"], js["params"], noisy, lr, i + 1, f"{mode} r{r} jax")
            _params_rule(got["params"], ps["params"], noisy, lr, i + 1, f"{mode} r{r} port")


def test_both_ranks_hold_the_same_model(case):
    a, b = case["ranks"]["train"]
    for mode in ("dp", "fsdp"):
        for sa, sb in zip(a[mode], b[mode]):
            assert sa["loss"] == sb["loss"]
            assert all(torch.equal(sa["params"][k], sb["params"][k]) for k in sa["params"])


def test_fsdp_state_is_born_sharded(case):
    """No rank holds a whole float32 master, moment or EMA of a leaf the
    rule shards: each is half the leaf along the split dim; the leaves
    the rule keeps replicated are whole."""
    n_sharded = 0
    for res in case["ranks"]["train"]:
        for name, (full, p, mu, nu, ema, dim) in res["fsdp_shapes"].items():
            if dim is None:
                assert p == mu == nu == ema == full, name
                continue
            n_sharded += 1
            want = tuple(s // 2 if i == dim else s for i, s in enumerate(full))
            assert p == mu == nu == ema == want, (name, full, p, mu, nu, ema)
    assert n_sharded > 0


def test_fsdp_rule_splits_as_jax(case):
    """The rule on the torch shapes shards the same leaves as JAX's on the
    JAX shapes, into parts of the same size (a tie between equal dims may
    pick another logical dim, `parallel/mesh.py::param_pspec_tree`)."""
    _, _, up, _, unet, _, _ = case["models"]

    def split(shape, spec):
        return shape[list(spec).index("data")] if "data" in spec else 0

    jax_split = sorted(split(x.shape, jmesh.shape_pspec(x.shape, 2, min_elems=MIN_ELEMS))
                       for x in jax.tree_util.tree_leaves(up))
    params = dict(unet.named_parameters())
    specs = M.param_pspec_tree(params, fsdp_size=2, fsdp_min_elems=MIN_ELEMS)
    torch_split = sorted(split(tuple(params[k].shape), s) for k, s in specs.items())
    assert torch_split == jax_split and max(torch_split) > 0


@pytest.mark.parametrize("shape", [(320, 4, 3, 3), (1280, 320), (77, 1024), (320,),
                                   (3, 5, 7), (4096, 4096)])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_fsdp_dim_equals_jax(shape, n):
    """`_fsdp_dim` and `shape_pspec` at the default threshold equal JAX's."""
    assert M._fsdp_dim(shape, n) == jmesh._fsdp_dim(shape, n)
    assert M.shape_pspec(shape, n) == tuple(jmesh.shape_pspec(shape, n))


def _jax_pipe(models):
    ucfg, vcfg, up, vp = models[:4]
    jb = JC.PipelineBundle(up, ucfg, vp, vcfg, None, CLIPTextConfig.tiny(),
                           SchedulerConfig.diffews())
    return JP.DiffewsPipeline(jb)


def _uint8_close(a, b, what):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 0.01, (what, d.max(), (d != 0).mean())


def test_data_mesh_predict_and_cache_match_jax(case):
    """Every rank returns the whole batch: `predict` on batch 4 (2 shots,
    one padded) and batch 2, and `predict_cached` from a batch-1 and a
    batch-4 cache, against JAX's unsharded calls."""
    jp, eps = _jax_pipe(case["models"]), case["inp"]["episodes"]
    want = {k: np.asarray(jp.predict(e["q"], e["sup"], e["msk"], shot_mask=jnp.asarray(e["sm"]),
                                     r_threshold=0.25).seg_colored) for k, e in eps.items()}
    e = eps["b4n2"]
    for cb in (1, 4):
        cache = jp.precompute_supports(e["sup"][:cb], e["msk"][:cb],
                                       shot_mask=jnp.asarray(e["sm"][:cb]))
        want[f"cached_b{cb}"] = np.asarray(jp.predict_cached(e["q"], cache).seg_colored)
    for r, res in enumerate(case["ranks"]["train"]):
        for key, w in want.items():
            assert res[key].shape == w.shape, (r, key)
            _uint8_close(np.asarray(res[key]), w, f"rank {r} {key}")


def test_data_mesh_depth_matches_jax(case):
    """The depth head's raw map under the data mesh (batch 4, 2 shots, one
    padded): every rank returns the whole batch, within the depth head's
    contract (`helpers/depth_check.py`) of JAX's unsharded depth head on
    the same episode, and of the one-process port."""
    inp = case["inp"]
    e = inp["episodes"]["b4n2"]
    jax_raw = _jax_raw(_jax_pipe(case["models"]), e["q"], e["sup"], _mask3(e["msk"]), e["sm"],
                       None)
    bundle = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
    bundle.unet.load_state_dict(inp["unet_sd"])
    bundle.vae.load_state_dict(inp["vae_sd"])
    one = TP.DiffewsPipeline(bundle, device="cpu").predict_depth_raw(
        e["q"], e["sup"], e["msk"], shot_mask=e["sm"]).numpy()
    for r, res in enumerate(case["ranks"]["train"]):
        got = res["depth_b4n2"]
        assert got.shape == jax_raw.shape == one.shape == (4, 32, 32), r
        for what, want in (("jax", jax_raw), ("one process", one)):
            _, bad = depth_close(got, want, TP.depth_output(got), TP.depth_output(want))
            assert not bad, (r, what, bad)


def test_stop_vote_agrees_one_step_late(case):
    """Rank 1 alone raises its flag at step 2: both ranks stop at step 3."""
    assert [r["vote_stop_step"] for r in case["ranks"]["train"]] == [3, 3]


def test_two_host_checkpoint_equals_unsharded(case, models, tmp_path):
    """Two hosts of one rank each: the FSDP state (set values in every slot,
    bf16 first moments, EMA) written sharded equals the same state written
    by one unsharded process, bit for bit, and resumes to the same shards."""
    res = case["ranks"]["ckpt"]
    assert [r["host"] for r in res] == [(0, 2), (1, 2)]
    assert res[0]["sharded"] and res[0]["sharded"] == res[1]["sharded"]
    assert all(r["resumed_equal"] for r in res)
    inp = case["inp"]
    tcfg = tstate.TrainerConfig(**dict(inp["tcfg"], use_ema=True,
                                       adam_mu_dtype=torch.bfloat16))
    full = {k: v.clone() for k, v in inp["unet_sd"].items()}
    state = tstate.init_state(tcfg, {k: v.clone() for k, v in full.items()}, device="cpu")
    set_values(state, full)
    tck.save_checkpoint(str(tmp_path), 5, state, TCF.UNetConfig.tiny())
    sharded = case["root"] / "ckpt" / "checkpoint-5"
    plain = tmp_path / "checkpoint-5"
    a, b = TC.load_unet_state(str(sharded / "unet")), TC.load_unet_state(str(plain / "unet"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    a, b = TC.load_unet_state(str(sharded / "unet_ema")), TC.load_unet_state(str(plain / "unet_ema"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = tck.read_train_state(str(sharded)), tck.read_train_state(str(plain))
    assert sa["step"] == sb["step"] == 5 and sa["ema_step"] == sb["ema_step"]
    for k in ("mu", "nu"):
        assert set(sa["opt_state"][k]) == set(sb["opt_state"][k])
        for n, t in sa["opt_state"][k].items():
            u = sb["opt_state"][k][n]
            assert t.dtype == u.dtype and torch.equal(t, u), (k, n)
    for k in ("count", "notfinite_count", "total_notfinite"):
        assert torch.equal(sa["opt_state"][k], sb["opt_state"][k]), k
