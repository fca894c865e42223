"""Port weights: carry-over from JAX trees, diffusers directories, configs.

The carry-over round-trips bit-exact at tiny width; at the full SD-2.1
widths the port's modules (built on the meta device, nothing allocated)
have exactly the keys and shapes of `pytree_to_torch_state` of the JAX
`init_params` shapes (`jax.eval_shape`).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as JC
from diffews_tpu import configs as JCF
from diffews_tpu.models import clip_text as JCLIP
from diffews_tpu.models import unet as JU
from diffews_tpu.models import vae as JV
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch.models.clip_text import CLIPTextModel
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from diffews_tpu_torch.models.vae import AutoencoderKL
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODELS = {
    "unet": (JU, JCF.UNetConfig, UNet2DConditionModel, TCF.UNetConfig, "sd21"),
    "vae": (JV, JCF.VAEConfig, AutoencoderKL, TCF.VAEConfig, "sd"),
    "clip": (JCLIP, JCF.CLIPTextConfig, CLIPTextModel, TCF.CLIPTextConfig, "sd21"),
}


def _tiny_params(name, seed=0):
    jmod, jcfg = MODELS[name][:2]
    cfg = jcfg.tiny()
    return jax.device_get(jax.jit(lambda r: jmod.init_params(r, cfg))(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name", list(MODELS))
def test_carry_over_round_trips_bit_exact(name):
    params = _tiny_params(name)
    _, _, tcls, tcfg, _ = MODELS[name]
    model = tcls(tcfg.tiny())
    model.load_state_dict(TC.state_dict_from_jax(params), strict=True)
    got = model.state_dict()
    want = JC.pytree_to_torch_state(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_full_width_keys_and_shapes(name):
    jmod, jcfg, tcls, tcfg, preset = MODELS[name]
    shapes = jax.eval_shape(lambda r: jmod.init_params(r, getattr(jcfg, preset)()),
                            jax.random.PRNGKey(0))
    # zero-stride views: the layout rules apply, nothing full-size is allocated
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in JC.pytree_to_torch_state(views).items()}
    with torch.device("meta"):
        model = tcls(getattr(tcfg, preset)())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_configs_match_the_jax_package():
    for jcls, tcls in ((JCF.UNetConfig, TCF.UNetConfig), (JCF.VAEConfig, TCF.VAEConfig),
                       (JCF.CLIPTextConfig, TCF.CLIPTextConfig),
                       (JCF.SchedulerConfig, TCF.SchedulerConfig)):
        for preset in ("sd21", "sd", "tiny", "diffews", None):
            if preset is None:
                j, t = jcls(), tcls()
            elif hasattr(jcls, preset):
                j, t = getattr(jcls, preset)(), getattr(tcls, preset)()
            else:
                continue
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            if hasattr(j, "to_diffusers_dict"):
                d = j.to_diffusers_dict()
                assert t.to_diffusers_dict() == d
                assert tcls.from_diffusers_dict(d) == t


def test_diffusers_directory_loads(tmp_path):
    """A tiny checkpoint in diffusers layout: the JAX writer's UNet
    safetensors, a VAE .bin with the legacy attention names, a text encoder
    .bin with the `text_model.` prefix and a position_ids buffer."""
    up, vp, cp = _tiny_params("unet"), _tiny_params("vae", 1), _tiny_params("clip", 2)
    JC.save_unet(up, JCF.UNetConfig.tiny(), str(tmp_path / "unet"))
    (tmp_path / "vae").mkdir()
    legacy = {}
    for k, v in JC.pytree_to_torch_state(vp).items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
        legacy[k] = torch.from_numpy(np.array(v))
    torch.save(legacy, tmp_path / "vae" / TC.WEIGHTS_BIN)
    (tmp_path / "vae" / "config.json").write_text(
        json.dumps(JCF.VAEConfig.tiny().to_diffusers_dict()))
    (tmp_path / "text_encoder").mkdir()
    text = {"text_model." + k: torch.from_numpy(np.array(v))
            for k, v in JC.pytree_to_torch_state(cp).items()}
    text["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(text, tmp_path / "text_encoder" / TC.TEXT_BIN)
    (tmp_path / "text_encoder" / "config.json").write_text(json.dumps(
        dataclasses.asdict(JCF.CLIPTextConfig.tiny())))
    (tmp_path / "scheduler").mkdir()
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(
        json.dumps(JCF.SchedulerConfig.diffews().to_diffusers_dict()))

    bundle = TC.load_pipeline_bundle(str(tmp_path))
    assert bundle.unet_cfg == TCF.UNetConfig.tiny()
    assert bundle.vae_cfg == TCF.VAEConfig.tiny()
    assert bundle.scheduler_cfg == TCF.SchedulerConfig.diffews()
    for module, params in ((bundle.unet, up), (bundle.vae, vp), (bundle.text, cp)):
        got = module.state_dict()
        for k, v in JC.pytree_to_torch_state(params).items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_random_bundle_is_seeded():
    cfgs = (TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), TCF.CLIPTextConfig.tiny(),
            TCF.SchedulerConfig.diffews())
    a = TC.random_pipeline_bundle(*cfgs, seed=3)
    b = TC.random_pipeline_bundle(*cfgs, seed=3)
    c = TC.random_pipeline_bundle(*cfgs, seed=4)
    sa, sb, sc = (x.unet.state_dict() for x in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_in.weight"], sc["conv_in.weight"])
    w = sa["down_blocks.0.resnets.0.conv1.weight"]
    bound = 1 / np.sqrt(w.shape[1] * 9)
    assert w.abs().max() <= bound and w.std() > bound / 3
    assert torch.equal(sa["conv_norm_out.weight"], torch.ones_like(sa["conv_norm_out.weight"]))
