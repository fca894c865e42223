"""Port parity: the CLIP text tower against the JAX one (tiny config, f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.configs import CLIPTextConfig
from diffews_tpu.models import clip_text as JC
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.configs import CLIPTextConfig as TCLIPTextConfig
from diffews_tpu_torch.models import clip_text as TC
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def models():
    cfg = CLIPTextConfig.tiny()
    params = jax.device_get(jax.jit(lambda r: JC.init_params(r, cfg))(jax.random.PRNGKey(3)))
    model = TC.CLIPTextModel(TCLIPTextConfig.tiny())
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model.eval()


@pytest.mark.parametrize("ids", [
    [[5, 17, 999, 3]],                 # in-vocabulary ids, batch 1
    [[1, 2, 3, 0, 0, 0], [7, 8, 9, 10, 11, 12]],
])
def test_forward(models, ids):
    params, model = models
    ids = np.asarray(ids, dtype=np.int32)
    want = JC.forward(params, CLIPTextConfig.tiny(), jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_to", [None, 77])
def test_empty_prompt(models, pad_to):
    """The eval protocol's [bos, eos] ids (clamped into the tiny vocabulary,
    as the JAX gather clamps them) and the 77-token padded form."""
    params, model = models
    jids = JC.empty_prompt_ids(CLIPTextConfig.tiny(), pad_to)
    tids = TC.empty_prompt_ids(TCLIPTextConfig.tiny(), pad_to)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    want = JC.forward(params, CLIPTextConfig.tiny(), jids)
    with torch.no_grad():
        got = model(tids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
