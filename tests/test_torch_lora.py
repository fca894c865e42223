"""Port parity of LoRA (`diffews_tpu_torch/training/lora.py`) against
`diffews_tpu/training/lora.py`, mirroring `tests/test_lora.py`.

Held on tiny configs, f32, on the CPU: the adapted sites equal the JAX
package's for both target sets (B zero, A N(0, 1/sqrt(in))); a zero-init
merge is the identity bit for bit; the merge of bumped adapters equals the
JAX merge (1e-6) and changes only adapted sites; a LoRA step trains only
the adapters with an adapter-sized optimizer state and EMA; the gas path
runs; two LoRA steps against `make_lora_train_step` on `lora_from_jax`
adapters with JAX's noise (loss rtol 1e-5, grad norm rtol 1e-4, adapters
under `test_torch_train_step.py`'s rule at lr 1e-3).  The CLI with `--lora_rank 2 --use_ema` in bf16 under
remat: its `unet/` and `unet_ema/` are f32, read by
`diffews_tpu.checkpoint.load_unet`, equal to the host merge of the f32
base and the stored adapters bit for bit and differ from the base only at
adapted sites; a resume from the mid-run checkpoint restores the adapters
and lands bit for bit on the straight run (mirrors `test_cli.py:372-427`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as C
from diffews_tpu.training import lora as jlora
from diffews_tpu.training import state as jstate
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.cli import train as TT
from diffews_tpu_torch.checkpoint import load_unet_state
from diffews_tpu_torch.training import checkpoints as tck
from diffews_tpu_torch.training import lora as tlora
from diffews_tpu_torch.training import state as tstate
from test_torch_train_cli import _common, workdir  # noqa: F401  (fixture)
from test_torch_training import (_torch_tree, _trainer_cfgs, episode_batch,  # noqa: F401
                                 models, n_images)
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _base(models):
    return {n: p.detach() for n, p in models[4].named_parameters()}


def _fwd(unet, params, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(2, 2, 32)).astype(np.float32))
    ref = torch.from_numpy(rng.normal(size=(2, 1, 8, 8, 8)).astype(np.float32))
    with torch.no_grad(), tstate.bind_params(unet, params):
        return unet(x, 1, ctx, ref_sample=ref)


@pytest.mark.parametrize("targets", ["attn", "attn+ff"])
def test_sites_match_jax(models, targets):
    up, base = models[2], _base(models)
    want = jlora.init_lora(jax.random.PRNGKey(0), up, 2, jlora.target_filter(targets))
    got = tlora.init_lora(0, base, 2, tlora.target_filter(targets))
    assert set(got) == set(tlora.lora_from_jax(want))
    for path, ab in got.items():
        dout, din = base[path + ".weight"].shape
        assert ab["lora_a"].shape == (2, din) and ab["lora_b"].shape == (dout, 2)
        assert not ab["lora_b"].any()
        assert abs(float(ab["lora_a"].std()) * np.sqrt(din) - 1) < 0.5
    attn = tlora.init_lora(0, base, 2, tlora.attn_target)
    assert all(".attn1." in p or ".attn2." in p for p in attn)
    if targets == "attn+ff":
        assert len(got) > len(attn)


def test_zero_init_merge_is_identity(models):
    base = _base(models)
    merged = tlora.merge_lora(base, tlora.init_lora(0, base, 4), 1.0)
    assert torch.equal(_fwd(models[4], merged), _fwd(models[4], base))


def test_merge_applies_delta_as_jax(models):
    up, base = models[2], _base(models)
    lj = jax.tree_util.tree_map(lambda x: x + 0.05,
                                jlora.init_lora(jax.random.PRNGKey(0), up, 4))
    want = state_dict_from_jax(jax.device_get(jlora.merge_lora(up, lj, 0.5)))
    merged = tlora.merge_lora(base, tlora.lora_from_jax(lj), 0.5)
    for n, t in merged.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    adapted = {p + ".weight" for p in tlora.lora_from_jax(lj)}
    for n in base:
        assert (merged[n] is base[n]) == (n not in adapted), n
    assert not torch.allclose(_fwd(models[4], merged), _fwd(models[4], base))


def _lora_state(cfg, lora):
    return tstate.init_state(cfg, tlora.flatten(lora), device="cpu")


def test_step_trains_only_adapters(models):
    unet, vae, text = models[4], models[5], torch.from_numpy(models[6])
    _, cfg = _trainer_cfgs(False, lora_rank=4, use_ema=True)
    base = _base(models)
    before = {n: p.clone() for n, p in base.items()}
    state = _lora_state(cfg, tlora.init_lora(0, base, 4))
    step = tlora.make_lora_train_step(cfg, unet)
    gen = torch.Generator().manual_seed(0)
    state, m1 = step(state, _torch_tree(episode_batch(1)), gen, base, vae, text)
    assert np.isfinite(float(m1["loss"])) and float(m1["grad_norm"]) > 0
    assert any(t.abs().max() > 0 for n, t in state.params.items() if n.endswith("lora_b"))
    n_opt = sum(t.numel() for d in (state.opt_state.mu, state.opt_state.nu) for t in d.values())
    assert n_opt < sum(p.numel() for p in base.values()) / 10
    state, m2 = step(state, _torch_tree(episode_batch(1, seed=1)), gen, base, vae, text)
    assert np.isfinite(float(m2["loss"])) and int(state.ema.step) == 2
    assert all(torch.equal(before[n], p) for n, p in base.items())
    assert all(p.grad is None for p in unet.parameters())


def test_gas_path(models):
    unet, vae, text = models[4], models[5], torch.from_numpy(models[6])
    _, cfg = _trainer_cfgs(False, gas=2, lora_rank=2)
    base = _base(models)
    state = _lora_state(cfg, tlora.init_lora(0, base, 2))
    state, m = tlora.make_lora_train_step(cfg, unet)(
        state, _torch_tree(episode_batch(2)), torch.Generator().manual_seed(0), base, vae, text)
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


def test_two_lora_steps_match_jax(models):
    ucfg, vcfg, up, vp, unet, vae, text = models
    jcfg, tcfg = _trainer_cfgs(False, lora_rank=2)
    lr = tcfg.learning_rate
    lj = jax.tree_util.tree_map(lambda x: x + 0.01,
                                jlora.init_lora(jax.random.PRNGKey(0), up, 2))
    jst = jstate.init_state(jcfg, lj)
    tst = _lora_state(tcfg, tlora.lora_from_jax(lj))
    jstep = jax.jit(jlora.make_lora_train_step(jcfg, ucfg, vcfg))
    tstep = tlora.make_lora_train_step(tcfg, unet)
    jtext, ttext = jnp.asarray(text), torch.from_numpy(text)
    base = _base(models)
    for i in range(2):
        batch, key = episode_batch(1, seed=40 + i), jax.random.PRNGKey(50 + i)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()}, key, up, vp,
                        jtext)
        shape = (n_images(batch, False), 16, 16, 4)
        noise = np.array(jax.random.normal(jax.random.split(key, 1)[0], shape))[None]
        tst, tm = tstep(tst, _torch_tree(batch), torch.from_numpy(noise), base, vae, ttext)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        want = tlora.flatten(tlora.lora_from_jax(jax.device_get(jst.params)))
        assert set(want) == set(tst.params)
        # test_torch_train_step.py's rule: off by more than 1e-3·lr only
        # where the first moment is at noise level (an Adam sign flip)
        mu = tlora.flatten(tlora.lora_from_jax(
            jax.device_get(jst.opt_state.inner_state[1][0].mu)))
        small = {n: m.abs() <= 1e-2 * m.abs().max() for n, m in mu.items()}
        noisy = small if i == 0 else {n: noisy[n] | small[n] for n in small}
        off = total = 0
        for n, p in tst.params.items():
            d = (p.detach() - want[n]).abs()
            bad = d > 1e-3 * lr
            assert not (bad & ~noisy[n]).any(), (n, d[bad & ~noisy[n]].max().item() / lr)
            assert d.max().item() <= 2 * lr * (i + 1), (n, d.max().item() / lr)
            off, total = off + int(bad.sum()), total + bad.numel()
        assert off <= 1e-3 * total, (off, total)
    assert int(tst.step) == int(jst.step) == 2


@pytest.fixture(scope="module")
def lora_runs(workdir, tmp_path_factory):  # noqa: F811
    """The port CLI with --lora_rank 2 --use_ema in bf16 under remat: a
    straight 4-step run and a resume of its checkpoint-2 in a fresh dir."""
    root = tmp_path_factory.mktemp("lora_cli")
    flags = ["--device", "cpu", "--lora_rank", "2", "--use_ema"]

    def argv(out, *extra):
        a = _common(workdir, out, *flags, *extra)
        a[a.index("--mixed_precision") + 1] = "bf16"
        a.remove("--no_remat")
        return a

    straight = TT.main(argv(root / "straight"))
    resumed = TT.main(argv(root / "resumed", "--resume_from_checkpoint",
                           str(root / "straight" / "checkpoint-2")))
    return root, straight, resumed


def test_cli_writes_merged_f32_unet_read_by_jax(workdir, lora_runs):  # noqa: F811
    root, straight, _ = lora_runs
    assert straight["trainable_params"] > 0
    ck = root / "straight" / "checkpoint-4"
    base = load_unet_state(str(workdir / "ckpt" / "unet"))
    aux = tck.read_train_state(str(ck))
    for sub, key in (("unet", "lora"), ("unet_ema", "lora_ema")):
        p, _ = C.load_unet(str(ck / sub))  # the JAX package's loader
        assert "conv_in_ref" in p
        assert all(np.asarray(x).dtype == np.float32 for x in jax.tree_util.tree_leaves(p))
        got = load_unet_state(str(ck / sub))
        assert all(t.dtype == torch.float32 for t in got.values())
        want = tlora.merge_lora(base, tlora.unflatten(aux[key]), 1.0)
        adapted = {n + ".weight" for n in tlora.unflatten(aux[key])}
        for n, t in got.items():
            assert torch.equal(t, want[n]), n
            assert torch.equal(t, base[n]) == (n not in adapted), n


def test_cli_resume_restores_adapters_bit_for_bit(lora_runs):
    root, _, resumed = lora_runs
    assert resumed["global_step"] == 4
    a = tck.read_train_state(str(root / "straight" / "checkpoint-4"))
    b = tck.read_train_state(str(root / "resumed" / "checkpoint-4"))
    for key in ("lora", "lora_ema"):
        assert set(a[key]) == set(b[key])
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key]), key
    for sub in ("unet", "unet_ema"):
        x = load_unet_state(str(root / "straight" / "checkpoint-4" / sub))
        y = load_unet_state(str(root / "resumed" / "checkpoint-4" / sub))
        assert all(torch.equal(x[n], y[n]) for n in x), sub
