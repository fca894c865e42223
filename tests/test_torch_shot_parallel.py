"""Port parity of shot-parallel serving (`diffews_tpu_torch.ops.attention.
shot_parallel_fused_kv_attention`, the UNet's `shot_group` and the
pipeline's `shot_mesh`) against the JAX package, mirroring
`tests/test_shot_parallel.py`.

The torch side runs as 4 gloo ranks on the CPU (`helpers/torch_ranks.py`,
`helpers/shot_parallel_ranks.py`): a ("shots",) mesh of 4 (8 shots, 2 a
rank) and a 2 x 2 ("data", "shots") mesh.  The JAX side runs the op under
`shard_map` on 4 of the conftest's virtual CPU devices, and the UNet and
pipeline unsharded (`tests/test_shot_parallel.py` holds JAX's sharded
UNet and pipeline equal to them).  Tolerances are that file's: the op to
2e-5 (gradients 1e-4), the UNet to 5e-4, the episode's uint8 image within
one count (on < 1% of pixels, the port's episode contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from diffews_tpu import checkpoint as JC
from diffews_tpu import pipeline as JP
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu.models import unet as JU
from diffews_tpu.models import vae as JV
from diffews_tpu.ops.attention import fused_kv_attention, shot_parallel_fused_kv_attention
from diffews_tpu_torch import checkpoint as TC
from helpers.torch_ranks import run_ranks
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RANKS = 4
B, S, SR, H, D, N = 2, 16, 12, 3, 8, 8


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX results, and each torch rank's results."""
    root = tmp_path_factory.mktemp("shot_parallel")
    rng = np.random.default_rng(0)
    proj = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    op = {"q": proj(B, S, H, D), "ko": proj(B, S, H, D), "vo": proj(B, S, H, D),
          "ks": proj(B, N, SR, H, D), "vs": proj(B, N, SR, H, D)}
    mask = np.ones((B, N), bool)
    mask[:, 4:] = False  # ranks 2 and 3 wholly padded
    m = rng.random((B, N, SR)) > 0.4
    bias = ((1.0 - m.astype(np.float32)) * -10000.0).astype(np.float32)

    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    up = jax.device_get(jax.jit(lambda r: JU.init_params(r, ucfg))(jax.random.PRNGKey(0)))
    vp = jax.device_get(jax.jit(lambda r: JV.init_params(r, vcfg))(jax.random.PRNGKey(1)))
    s = 16
    unet_in = {"sample": proj(2, s, s, ucfg.in_channels),
               "ref": proj(2, N, s, s, ucfg.ref_in_channels),
               "ref_am": proj(1, N, s, s, ucfg.in_channels),
               "ctx": proj(2, 2, ucfg.cross_attention_dim),
               "rmask": (rng.random((1, N, s * 8, s * 8)) > 0.5).astype(np.float32)}
    umask = np.ones((2, N), bool)
    umask[:, -3:] = False  # rank 3 wholly padded, rank 2 half

    def episode(b, n, sm, seed):
        r = np.random.default_rng(seed)
        return {"q": r.integers(0, 255, (b, 32, 32, 3), np.uint8),
                "sup": r.integers(0, 255, (b, n, 32, 32, 3), np.uint8),
                "msk": (r.random((b, n, 32, 32)) > 0.5).astype(np.uint8), "sm": sm}

    sm1 = np.ones((1, N), bool)
    sm1[:, -2:] = False
    sm2 = np.ones((4, 2), bool)
    sm2[1, 1] = False
    eps = {"episode_shots": episode(1, N, sm1, 3), "episode_data_shots": episode(4, 2, sm2, 11)}

    torch.save({"op": {**{k: _t(v) for k, v in op.items()}, "mask": torch.from_numpy(mask),
                       "bias": _t(bias)},
                "unet": {**{k: _t(v) for k, v in unet_in.items()},
                         "mask": torch.from_numpy(umask)},
                "unet_sd": TC.state_dict_from_jax(up), "vae_sd": TC.state_dict_from_jax(vp),
                **eps}, root / "inputs.pt")
    script = "tests/helpers/shot_parallel_ranks.py"
    ranks = {}
    for label, (nd, ns) in (("shots", (1, RANKS)), ("data_shots", (2, 2))):
        out = root / label
        out.mkdir()
        run_ranks([script, str(root / "inputs.pt"), str(out), str(nd), str(ns)], RANKS,
                  timeout=240)
        ranks[label] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                        for r in range(RANKS)]

    jb = JC.PipelineBundle(up, ucfg, vp, vcfg, None, CLIPTextConfig.tiny(),
                           SchedulerConfig.diffews())
    return {"op": op, "mask": mask, "bias": bias, "up": up, "ucfg": ucfg, "unet_in": unet_in,
            "umask": umask, "eps": eps, "jax_pipe": JP.DiffewsPipeline(jb), "ranks": ranks}


def _jax_sharded_op(op, **kw):
    """JAX's shot-parallel op under shard_map on 4 virtual devices."""
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("shots",))
    mask, bias = kw.get("shot_mask"), kw.get("support_bias")
    args = [jnp.asarray(op[k]) for k in ("q", "ko", "vo", "ks", "vs")]
    specs = [P(), P(), P(), P(None, "shots"), P(None, "shots")]
    extra = [jnp.asarray(x) for x in (mask, bias) if x is not None]

    def f(q, ko, vo, ks, vs, *rest):
        rest = list(rest)
        sm = rest.pop(0) if mask is not None else None
        sb = rest.pop(0).reshape(q.shape[0], -1) if bias is not None else None
        return shot_parallel_fused_kv_attention(q, ko, vo, ks, vs, axis_name="shots",
                                                shot_mask=sm, support_bias=sb)

    return np.asarray(shard_map(f, mesh=mesh, in_specs=tuple(specs + [P(None, "shots")] * len(extra)),
                                out_specs=P(), check_rep=False)(*args, *extra))


@pytest.fixture(scope="module")
def jax_op(case):
    """Per variant: JAX's single-device op, checked against its sharded op."""
    op, out = case["op"], {}
    for variant in ("plain", "mask", "bias"):
        kw = {"mask": {"shot_mask": case["mask"]},
              "bias": {"support_bias": case["bias"]}}.get(variant, {})
        single_kw = dict(kw)
        if "support_bias" in single_kw:
            single_kw["support_bias"] = jnp.asarray(case["bias"].reshape(B, -1))
        elif "shot_mask" in single_kw:
            single_kw["shot_mask"] = jnp.asarray(case["mask"])
        want = np.asarray(fused_kv_attention(*(jnp.asarray(op[k]) for k in
                                               ("q", "ko", "vo", "ks", "vs")), **single_kw))
        np.testing.assert_allclose(_jax_sharded_op(op, **kw), want, rtol=2e-5, atol=2e-5)
        out[variant] = want
    return out


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("variant", ["plain", "mask", "bias"])
def test_op_matches_jax(case, jax_op, impl, variant):
    """Every rank's merged output equals JAX's single-device op and its
    sharded op over the same shots, padded whole ranks included."""
    want = jax_op[variant]
    key = f"op_{impl}" + ("" if variant == "plain" else f"_{variant}")
    for r, res in enumerate(case["ranks"]["shots"]):
        got = res[key].numpy()
        assert np.isfinite(got).all(), r
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")


def test_dense_grads_flow_through_all_reduce(case):
    """The dense path is differentiable through the all_reduce: the
    gradients with respect to each rank's support K/V equal JAX's
    single-device gradients of the same slice."""
    op = case["op"]
    q, ko, vo = (jnp.asarray(op[k]) for k in ("q", "ko", "vo"))

    def loss(ks, vs):
        return (fused_kv_attention(q, ko, vo, ks, vs) ** 2).sum()

    gk, gv = jax.grad(loss, (0, 1))(jnp.asarray(op["ks"]), jnp.asarray(op["vs"]))
    per = N // RANKS
    for r, res in enumerate(case["ranks"]["shots"]):
        sl = slice(r * per, (r + 1) * per)
        np.testing.assert_allclose(res["op_grad_ks"].numpy(), np.asarray(gk)[:, sl],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res["op_grad_vs"].numpy(), np.asarray(gv)[:, sl],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["kv_fusion", "attn_mask"])
def test_unet_joint_forward_matches_jax(case, variant):
    """The tiny UNet with 8 shots over 4 ranks (padded shots filling a whole
    rank; or the attn-mask variant's per-level key biases) against JAX's
    unsharded joint forward."""
    u, cfg, up = case["unet_in"], case["ucfg"], case["up"]
    fwd = jax.jit(lambda p, x, c, **kw: JU.forward(p, cfg, x, 1, c, **kw))
    if variant == "kv_fusion":
        want = fwd(up, jnp.asarray(u["sample"]), jnp.asarray(u["ctx"]),
                   ref_sample=jnp.asarray(u["ref"]), shot_mask=jnp.asarray(case["umask"]))
        key = "unet"
    else:
        want = fwd(up, jnp.asarray(u["sample"][:1]), jnp.asarray(u["ctx"][:1]),
                   ref_sample=jnp.asarray(u["ref_am"]), ref_mask=jnp.asarray(u["rmask"]))
        key = "unet_am"
    for r, res in enumerate(case["ranks"]["shots"]):
        np.testing.assert_allclose(res[key].numpy(), np.asarray(want), rtol=5e-4, atol=5e-4,
                                   err_msg=f"rank {r}")


def _uint8_close(a, b, what):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 0.01, (what, d.max(), (d != 0).mean())


@pytest.mark.parametrize("mesh", ["shots", "data_shots"])
def test_pipeline_matches_jax(case, mesh):
    """The episode with 8 shots over a ("shots",) mesh of 4 (two trailing
    shots padded: rank 3 holds no valid shot), and batch 4 x 2 shots over
    a 2 x 2 ("data", "shots") mesh (one shot padded), against JAX's
    unsharded `predict`: every rank returns the whole batch."""
    e = case["eps"][f"episode_{mesh}"]
    want = case["jax_pipe"].predict(e["q"], e["sup"], e["msk"], shot_mask=jnp.asarray(e["sm"]),
                                    r_threshold=0.25)
    want = np.asarray(want.seg_colored)
    for r, res in enumerate(case["ranks"][mesh]):
        got = res[f"episode_{mesh}"].numpy()
        assert got.shape == want.shape, (r, got.shape)
        _uint8_close(got, want, f"rank {r}")


def test_pipeline_rejects_indivisible_nshot(case):
    for res in case["ranks"]["shots"]:
        assert "must divide n-shot 3" in res["indivisible_error"]
