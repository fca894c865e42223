"""Port parity: two full training steps against the JAX `make_train_step`.

Tiny configs, f32 compute and f32 Adam moments, JAX's posterior-sample
noise fed to the port, a padded shot: here gas 1 with the KV-fusion
conditioning; `test_torch_train_step_accum.py` runs gas 2 with the
attn-mask variant (whose `conv_in_ref` gets a zero gradient and still
decays), so that the two JAX compilations run on two test workers.  Held: loss rtol 1e-5 and the pre-clip
grad norm rtol 1e-4 at each step; after each step the params within
1e-3·lr on at least 99.9% of the entries and within 2·lr per step
everywhere.  An entry whose gradient is within float noise of zero can
flip the sign of an Adam step, so the entries off by more than 1e-3·lr must
be ones whose first moment was within 1e-2 of their leaf's largest.  lr is
1e-3, so that 1e-3·lr stays above a float32 ulp of a unit-size weight.  The
step and apply_if_finite counters are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffews_tpu.training import state as jstate
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.training import state as tstate
from test_torch_training import (_torch_tree, _trainer_cfgs, episode_batch,  # noqa: F401
                                 models, n_images)
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def check_two_steps(models, gas, variant):
    ucfg, vcfg, up, vp, unet, vae, text = models
    jcfg, tcfg = _trainer_cfgs(variant, gas)
    lr = tcfg.learning_rate
    jst = jstate.init_state(jcfg, up)
    tst = tstate.init_state(tcfg, {n: p.detach().clone() for n, p in unet.named_parameters()},
                            device="cpu")
    tstep = tstate.make_train_step(tcfg, unet)
    jtext, ttext = jnp.asarray(text), torch.from_numpy(text)
    jstep = jax.jit(jstate.make_train_step(jcfg, ucfg, vcfg))
    for i in range(2):
        batch, key = episode_batch(gas, seed=20 + i), jax.random.PRNGKey(30 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jst, jm = jstep(jst, jb, key, vp, jtext)
        shape = (n_images(batch, variant), 16, 16, 4)
        noise = np.stack([np.array(jax.random.normal(k, shape))
                          for k in jax.random.split(key, gas)])
        tst, tm = tstep(tst, _torch_tree(batch), torch.from_numpy(noise), vae, ttext)

        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for name in ("notfinite_count", "total_notfinite"):
            assert int(tm[name]) == int(jm[name]) == 0
        assert int(tst.step) == int(jst.step) == i + 1
        want = state_dict_from_jax(jax.device_get(jst.params))
        assert set(want) == set(tst.params)
        # entries with a small first moment: there the gradients' float
        # noise (~1e-5 of a leaf's largest) is a sizeable part of the Adam
        # step, and at noise level it sets its sign; a flip then persists
        mu = state_dict_from_jax(jax.device_get(jst.opt_state.inner_state[1][0].mu))
        small = {n: np.abs(m.numpy()) <= 1e-2 * np.abs(m.numpy()).max() for n, m in mu.items()}
        noisy = small if i == 0 else {n: noisy[n] | small[n] for n in small}
        off = total = 0
        for name, p in tst.params.items():
            d = np.abs(p.detach().numpy() - want[name].numpy())
            bad = d > 1e-3 * lr
            assert not (bad & ~noisy[name]).any(), (name, d[bad & ~noisy[name]].max() / lr)
            assert d.max() <= 2 * lr * (i + 1), (name, d.max() / lr)
            off, total = off + bad.sum(), total + bad.size
        assert off <= 1e-3 * total, (off, total)
    if variant:  # unused by the variant: zero gradient, decayed twice
        ref = dict(unet.named_parameters())["conv_in_ref.weight"].detach()
        got = tst.params["conv_in_ref.weight"].detach()
        nz = ref != 0
        assert torch.all(got[nz].abs() < ref[nz].abs())


def test_two_train_steps_match_jax(models):
    check_two_steps(models, gas=1, variant=False)
