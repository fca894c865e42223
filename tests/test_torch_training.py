"""Port parity: `diffews_tpu_torch.training` against the JAX package.

LR schedules (1e-7 relative), EMA, the optimizer against optax (clip
triggered or not, a zero-grad leaf that must still decay, f32 and bf16
first moments, non-finite steps skipped and counted), `sample_latent` with
JAX's noise fed in (1e-5), and the episode loss with every gradient leaf
for both conditioning variants with a padded shot (loss rtol 1e-5, global
grad norm rtol 1e-4, each leaf max|Δ| ≤ 1e-4·max|g| + 1e-7).  Also:
`remat` changes no bit, and a non-finite batch is contained and counted
as `tests/test_training.py` shows for JAX.  Tiny configs, f32, CPU; the
JAX side takes `attn_impl="xla"`, the port "auto" (its plain versions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.configs import UNetConfig, VAEConfig
from diffews_tpu.models import unet as JU
from diffews_tpu.models import vae as JV
from diffews_tpu.training import ema as jema
from diffews_tpu.training import lr as jlr
from diffews_tpu.training import state as jstate
from diffews_tpu_torch import configs as TC
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from diffews_tpu_torch.models.vae import AutoencoderKL
from diffews_tpu_torch.training import ema as tema
from diffews_tpu_torch.training import lr as tlr
from diffews_tpu_torch.training import state as tstate
from diffews_tpu_torch.training.optim import global_norm
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

def _random_tree(init, cfg, seed):
    """A JAX parameter tree of `init`'s structure drawn with numpy (fan-in
    uniform kernels, small biases, norm scales near one)."""
    shapes = jax.eval_shape(lambda r: init(r, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        kind = path[-1].key
        if kind == "kernel":
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif kind == "scale":
            a = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            a = 0.05 * rng.normal(size=s.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def models():
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    up, vp = _random_tree(JU.init_params, ucfg, 0), _random_tree(JV.init_params, vcfg, 1)
    unet = UNet2DConditionModel(TC.UNetConfig.tiny())
    unet.load_state_dict(state_dict_from_jax(up), strict=True)
    vae = AutoencoderKL(TC.VAEConfig.tiny())
    vae.load_state_dict(state_dict_from_jax(vp), strict=True)
    text = (0.5 * np.random.default_rng(2).normal(size=(1, 77, ucfg.cross_attention_dim))
            ).astype(np.float32)
    return ucfg, vcfg, up, vp, unet, vae.requires_grad_(False), text


def episode_batch(gas, b=2, n=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.uniform(-1, 1, sh).astype(np.float32)
    shot_mask = np.ones((gas, b, n), dtype=bool)
    shot_mask[:, 0, 1] = False  # one padded shot
    return {"query": f(gas, b, s, s, 3), "q_mask3": f(gas, b, s, s, 3),
            "supports": f(gas, b, n, s, s, 3), "s_mask3": f(gas, b, n, s, s, 3),
            "shot_mask": shot_mask}


def n_images(batch, variant):
    b, n = batch["supports"].shape[1:3]
    return 2 * b + b * n * (1 if variant else 2)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# --- LR schedules and EMA ---------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", ["polynomial", "constant", "cosine", "linear"])
def test_lr_schedule_matches_jax(name, warmup):
    """1e-7 relative; the cosine to 3e-7 (two float32 ulps), because
    torch's and XLA's float32 cos differ in the last bit."""
    want = jlr.get_schedule(name, 1e-4, 10, warmup, power=1.0)
    got = tlr.get_schedule(name, 1e-4, 10, warmup, power=1.0)
    for step in range(13):
        w = float(np.asarray(want(jnp.asarray(step, jnp.int32)), np.float32))
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g), w, rtol=3e-7 if name == "cosine" else 1e-7,
                                   atol=0, err_msg=f"step {step}")


def test_ema_matches_jax():
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    js, ts = jema.init({k: jnp.asarray(v) for k, v in params.items()}), \
        tema.init(_torch_tree(params))
    for name, e in ts.params.items():  # a copy, not an alias
        assert e.data_ptr() != torch.from_numpy(params[name]).data_ptr()
    for i in range(4):
        new = {k: (v + 0.1 * (i + 1)).astype(np.float32) for k, v in params.items()}
        js = jema.update(js, {k: jnp.asarray(v) for k, v in new.items()})
        tema.update(ts, _torch_tree(new))
        assert int(ts.step) == int(js.step) == i + 1
        for k in params:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]),
                                       rtol=1e-6, atol=1e-7)


# --- the optimizer against optax --------------------------------------------


def _opt_pair(mu_dtype, **kw):
    base = dict(learning_rate=1e-2, max_train_steps=10, max_grad_norm=1.0, **kw)
    jtx = jstate.make_optimizer(jstate.TrainerConfig(
        adam_mu_dtype=jnp.bfloat16 if mu_dtype == "bf16" else jnp.float32, **base))
    ttx = tstate.make_optimizer(tstate.TrainerConfig(
        adam_mu_dtype=torch.bfloat16 if mu_dtype == "bf16" else torch.float32, **base))
    return jtx, ttx


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
            "lin": rng.normal(size=(6, 7)).astype(np.float32),
            "bias": rng.normal(size=(7,)).astype(np.float32),
            "unused": rng.normal(size=(2, 8)).astype(np.float32)}


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    g = {k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
    g["unused"] = np.zeros_like(params["unused"])  # e.g. conv_in_ref, attn-mask variant
    return g


def _close_to_leaf_max(got, want, rel):
    """|got − want| ≤ rel·max|want|: where (1−b1)·g and b1·mu nearly
    cancel, one rounding more or less (an FMA in XLA) is a large relative
    error of a small element but not of the leaf."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_optimizer_matches_optax(mu_dtype, clip):
    """Three steps: params to 1e-6 relative, mu and nu to 1e-6 of the
    leaf's max, for either moment dtype.  A bf16 mu decays as optax's does
    under jit: the Python b1 is weak-typed, so it is rounded to bf16
    (0.8984375) before it multiplies the stored moment, and XLA keeps the
    product and the sum in f32 until the result is stored; the port does
    the same (`training/optim.py`), far inside one bf16 ulp (2^-7)."""
    jtx, ttx = _opt_pair(mu_dtype)
    params = _params(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _torch_tree({k: v.copy() for k, v in params.items()})
    js, ts = jtx.init(jp), ttx.init(tp)
    decay = 1.0
    for i in range(3):
        g = _grads(params, 10 + i, 3.0 if clip else 0.02)
        gnorm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values())))
        assert (gnorm > 1.0) == clip
        upd, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tnorm = ttx.update(_torch_tree(g), ts, tp)
        np.testing.assert_allclose(float(tnorm), gnorm, rtol=1e-6)
        inner = js.inner_state[1][0]  # chain(clip, adamw) -> adamw's scale_by_adam
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9)
            if mu_dtype == "f32":
                _close_to_leaf_max(ts.mu[k].numpy(), inner.mu[k], 1e-6)
            elif k != "unused":
                assert ts.mu[k].dtype == torch.bfloat16
                _close_to_leaf_max(ts.mu[k].float().numpy(), inner.mu[k], 1e-6)
            if k != "unused":
                _close_to_leaf_max(ts.nu[k].numpy(), inner.nu[k], 1e-6)
        assert int(ts.count) == int(inner.count) == i + 1
        # the zero-grad leaf decays every step: p ← p − lr·wd·p, with
        # lr(i) = (1e-2 − 1e-7)·(1 − i/10) + 1e-7 (polynomial, 10 steps)
        assert torch.all(ts.mu["unused"] == 0) and torch.all(ts.nu["unused"] == 0)
        decay *= 1 - ((1e-2 - 1e-7) * (1 - i / 10) + 1e-7) * 1e-2
        np.testing.assert_allclose(tp["unused"].numpy(), params["unused"] * decay, rtol=1e-6)
        np.testing.assert_allclose(tp["unused"].numpy(), np.asarray(jp["unused"]), rtol=1e-6)


def test_optimizer_skips_and_counts_nonfinite_like_optax():
    """A non-finite step changes nothing and is counted; after more than
    `max_nonfinite_steps` in a row the update goes through, as optax's
    apply_if_finite does; a finite step resets the run."""
    jtx, ttx = _opt_pair("f32", max_nonfinite_steps=2)
    params = _params(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _torch_tree({k: v.copy() for k, v in params.items()})
    js, ts = jtx.init(jp), ttx.init(tp)
    for i, bad in enumerate([False, True, True, True, False]):
        g = _grads(params, 20 + i, 0.02)
        if bad:
            g["lin"][1, 2] = np.nan
        before = {k: v.clone() for k, v in tp.items()}
        upd, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        ttx.update(_torch_tree(g), ts, tp)
        assert int(ts.notfinite_count) == int(js.notfinite_count)
        assert int(ts.total_notfinite) == int(js.total_notfinite)
        assert int(ts.count) == int(js.inner_state[1][0].count)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9, equal_nan=True)
        if i in (1, 2):  # skipped: bit for bit unchanged
            assert all(torch.equal(before[k], tp[k]) for k in params)
    assert int(ts.total_notfinite) == 3 and int(ts.notfinite_count) == 0


# --- the VAE sample and the episode loss -------------------------------------


def test_sample_latent_matches_jax(models):
    _, vcfg, _, vp, _, vae, _ = models
    x = np.random.default_rng(4).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = JV.sample_latent(vp, vcfg, jnp.asarray(x), key, attn_impl="xla")
    noise = np.array(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = vae.sample_latent(torch.from_numpy(x), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _trainer_cfgs(variant, gas=1, **kw):
    common = dict(max_train_steps=10, attn_mask_variant=variant, remat=False,
                  learning_rate=1e-3, **kw)
    return (jstate.TrainerConfig(compute_dtype=jnp.float32, adam_mu_dtype=jnp.float32,
                                 attn_impl="xla", gradient_accumulation_steps=gas, **common),
            tstate.TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                                 attn_impl="auto", **common))


def assert_grads_close(got, want_tree):
    want = state_dict_from_jax(jax.device_get(want_tree))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7, (name, err, np.abs(w).max())


@pytest.mark.parametrize("variant", [False, True], ids=["kv_fusion", "attn_mask"])
def test_episode_loss_and_grads_match_jax(models, variant):
    ucfg, vcfg, up, vp, unet, vae, text = models
    jcfg, tcfg = _trainer_cfgs(variant)
    micro = {k: v[0] for k, v in episode_batch(1, seed=6).items()}
    key = jax.random.PRNGKey(7)
    jloss = jax.value_and_grad(jstate.make_episode_loss(jcfg, ucfg, vcfg))
    args = (up, vp, jnp.asarray(text), {k: jnp.asarray(v) for k, v in micro.items()}, key)
    want_loss, want_grads = jax.jit(jloss)(*args)
    noise = jax.random.normal(key, (n_images(episode_batch(1), variant), 16, 16, 4))
    params = {n: p.detach().clone().requires_grad_() for n, p in unet.named_parameters()}
    loss, grads = tstate.make_grad_fn(tcfg, unet)(
        params, vae, torch.from_numpy(text), _torch_tree(micro),
        torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(
        want_grads))))
    np.testing.assert_allclose(float(global_norm(grads.values())), want_norm, rtol=1e-4)
    assert_grads_close(grads, want_grads)
    if variant:  # conv_in_ref is unused: a zero gradient, not a missing one
        assert torch.all(grads["conv_in_ref.weight"] == 0)


def test_remat_is_bit_identical(models):
    *_, unet, vae, text = models
    micro = _torch_tree({k: v[0] for k, v in episode_batch(1, seed=8).items()})
    out = []
    for remat in (False, True):
        _, cfg = _trainer_cfgs(False)
        cfg = dataclasses.replace(cfg, remat=remat)
        params = {n: p.detach().clone().requires_grad_() for n, p in unet.named_parameters()}
        out.append(tstate.make_grad_fn(cfg, unet)(params, vae, torch.from_numpy(text), micro,
                                                  torch.Generator().manual_seed(0)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_nonfinite_batch_is_contained_and_counted(models):
    *_, unet, vae, text = models
    _, cfg = _trainer_cfgs(False)
    state = tstate.init_state(cfg, {n: p.detach().clone() for n, p in unet.named_parameters()},
                              device="cpu")
    step = tstate.make_train_step(cfg, unet)
    bad = episode_batch(1, seed=9)
    bad["query"] = bad["query"] + np.nan
    p0 = state.params["conv_in.weight"].detach().clone()
    state, m = step(state, _torch_tree(bad), torch.Generator().manual_seed(0), vae,
                    torch.from_numpy(text))
    assert not np.isfinite(float(m["loss"]))
    assert int(m["total_notfinite"]) == 1 and int(m["notfinite_count"]) == 1
    assert torch.equal(state.params["conv_in.weight"], p0)
    assert int(state.step) == 1 and int(state.opt_state.count) == 0
    state, m = step(state, _torch_tree(episode_batch(1, seed=10)),
                    torch.Generator().manual_seed(1), vae, torch.from_numpy(text))
    assert np.isfinite(float(m["loss"]))
    assert int(m["notfinite_count"]) == 0 and int(m["total_notfinite"]) == 1
    assert not torch.allclose(state.params["conv_in.weight"], p0)
    assert int(state.step) == 2 and int(state.opt_state.count) == 1


def test_entry_points_run_on_cuda_unless_told(models, monkeypatch):
    *_, unet, _, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tstate.TrainerConfig()
    params = {n: p.detach().clone() for n, p in unet.named_parameters()}
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.init_state(cfg, params)
    state = tstate.init_state(cfg, params, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in state.params.values())
    assert state.opt_state.mu["conv_in.weight"].dtype == torch.bfloat16
