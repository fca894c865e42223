"""The port's checkpoint I/O against the JAX package and the `safetensors`
package: the safetensors codec (`utils/safetensors_codec.py`), the savers
and loaders (`checkpoint.py`), the surgery and its CLI, and the training
checkpoints (`training/checkpoints.py`).

Held, bit for bit: the codec's files read by the package and the package's
read by the codec, in F32, F16, BF16 and the integer types, with metadata
and sharded `.index.json` directories; a port-written `unet/` and `vae/`
read by the JAX loaders, a JAX-written one by the port; the surgery equal
to `make_ref_conv_surgery` and the surgery CLI's output to the JAX one's.
Mirroring `tests/test_training.py:184-300`: save and load restore the
params, both moments (the bf16 one in bf16), the counters and the EMA;
rotation; the same-step replace; `.tmp` isolation; a background failure
surfacing from `result()`; the snapshot not aliasing the live parameters
on the CPU.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors import numpy as st_np
from safetensors import safe_open
from safetensors import torch as st_torch

from diffews_tpu import checkpoint as JC
from diffews_tpu.configs import UNetConfig as JUNetConfig
from diffews_tpu.configs import VAEConfig as JVAEConfig
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch.cli import surgery as TS
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from diffews_tpu_torch.models.vae import AutoencoderKL
from diffews_tpu_torch.checkpoint import load_unet_state
from diffews_tpu_torch.training import checkpoints as tck
from diffews_tpu_torch.training import state as tstate
from diffews_tpu_torch.utils import safetensors_codec as codec
from diffews_tpu_torch.utils.init import build_module
from helpers.jax_checkpoint import tiny_params
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.int8, torch.uint8, torch.bool]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn((3, i + 1, 2), generator=g) * 50
        out[f"t{i}.{str(dt)[6:]}"] = x.to(dt) if dt != torch.bool else x > 0
    out["scalar"] = torch.tensor(1.5)
    out["empty"] = torch.zeros((0, 4))
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_codec_file_read_by_safetensors(tmp_path):
    t = _tensors()
    n = codec.save_file(t, str(tmp_path / "a.safetensors"), metadata={"format": "pt", "k": "v"})
    assert n == os.path.getsize(tmp_path / "a.safetensors")
    _assert_same(st_torch.load_file(str(tmp_path / "a.safetensors")), t)
    with safe_open(str(tmp_path / "a.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt", "k": "v"}


def test_safetensors_file_read_by_codec(tmp_path):
    t = _tensors(1)
    st_torch.save_file(t, str(tmp_path / "b.safetensors"), metadata={"format": "pt"})
    _assert_same(codec.load_file(str(tmp_path / "b.safetensors")), t)
    assert codec.read_header(str(tmp_path / "b.safetensors"))[0]["__metadata__"] == \
        {"format": "pt"}


def test_codec_numpy_inputs_and_bad_offsets(tmp_path):
    arr = {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}
    codec.save_file(arr, str(tmp_path / "c.safetensors"))
    np.testing.assert_array_equal(st_np.load_file(str(tmp_path / "c.safetensors"))["x"], arr["x"])
    raw = (tmp_path / "c.safetensors").read_bytes()
    (tmp_path / "d.safetensors").write_bytes(raw[:-4])
    with pytest.raises(ValueError):
        codec.load_file(str(tmp_path / "d.safetensors"))


def _sharded(model_dir, state, writer):
    """Two shards and the diffusers `.index.json` of `state`."""
    os.makedirs(model_dir, exist_ok=True)
    names = sorted(state)
    shards = {"m-00001-of-00002.safetensors": names[::2],
              "m-00002-of-00002.safetensors": names[1::2]}
    for fname, keys in shards.items():
        writer({k: state[k] for k in keys}, os.path.join(model_dir, fname))
    with open(os.path.join(model_dir, TC.WEIGHTS_SAFETENSORS + ".index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: fn for fn, ks in shards.items()
                                                  for k in ks}}, f)


def test_sharded_index_both_ways(tmp_path):
    state = {k: v for k, v in _tensors(2).items() if v.dtype == torch.float32}
    state.update({f"w{i}": torch.full((2, 2), float(i)) for i in range(5)})
    _sharded(str(tmp_path / "pkg"), state, lambda s, p: st_torch.save_file(s, p))
    _assert_same(TC._load_torch_weights(str(tmp_path / "pkg"), (TC.WEIGHTS_SAFETENSORS,)), state)
    _sharded(str(tmp_path / "port"), state, codec.save_file)
    got = JC._load_torch_weights(str(tmp_path / "port"), (JC.WEIGHTS_SAFETENSORS,))
    assert set(got) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(got[k], v.numpy())


@pytest.fixture(scope="module")
def tiny_jax():
    ucfg, vcfg = JUNetConfig.tiny(), JVAEConfig.tiny()
    up, vp = tiny_params()
    return ucfg, vcfg, up, vp


def test_port_written_unet_and_vae_read_by_jax(tmp_path):
    unet = build_module(UNet2DConditionModel, TCF.UNetConfig.tiny(), seed=3)
    vae = build_module(AutoencoderKL, TCF.VAEConfig.tiny(), seed=4)
    TC.save_unet(unet, TCF.UNetConfig.tiny(), str(tmp_path / "unet"))
    TC.save_vae(vae.state_dict(), TCF.VAEConfig.tiny(), str(tmp_path / "vae"))
    for sub, module, load in (("unet", unet, JC.load_unet), ("vae", vae, JC.load_vae)):
        assert set(os.listdir(tmp_path / sub)) == {"config.json", TC.WEIGHTS_SAFETENSORS}
        tree, cfg = load(str(tmp_path / sub))
        got = JC.pytree_to_torch_state(jax.device_get(tree))
        want = {k: v.numpy() for k, v in module.state_dict().items()}
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert JC.load_unet(str(tmp_path / "unet"))[1].ref_in_channels == 8


def test_jax_written_unet_and_vae_read_by_port(tiny_jax, tmp_path):
    ucfg, vcfg, up, vp = tiny_jax
    JC.save_unet(up, ucfg, str(tmp_path / "unet"))
    JC.save_vae(vp, vcfg, str(tmp_path / "vae"))
    unet, cfg = TC.load_unet(str(tmp_path / "unet"))
    vae, _ = TC.load_vae(str(tmp_path / "vae"))
    assert cfg == TCF.UNetConfig.tiny()
    for module, tree in ((unet, up), (vae, vp)):
        want = TC.state_dict_from_jax(tree)
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_surgery_matches_jax(tiny_jax):
    up = tiny_jax[2]
    want = TC.state_dict_from_jax(jax.device_get(JC.make_ref_conv_surgery(up)))
    state = TC.state_dict_from_jax(up)
    got = TC.make_ref_conv_surgery(state)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["conv_in_ref.weight"].shape[1] == 2 * state["conv_in.weight"].shape[1]


def test_surgery_cli_matches_jax(tiny_jax, tmp_path, capsys):
    ucfg, vcfg, up, vp = tiny_jax
    src = tmp_path / "sd"
    vanilla = {k: v for k, v in up.items() if k != "conv_in_ref"}
    JC.save_unet(vanilla, ucfg, str(src / "unet"))
    JC.save_vae(vp, vcfg, str(src / "vae"))
    (src / "model_index.json").write_text('{"_class_name": "StableDiffusionPipeline"}')
    JC.surgery_checkpoint(str(src), str(tmp_path / "jax"))
    TS.main([str(src), str(tmp_path / "port")])
    assert "wrote" in capsys.readouterr().out
    for sub in ("unet", "vae"):
        a = load_unet_state(str(tmp_path / "jax" / sub))
        b = load_unet_state(str(tmp_path / "port" / sub))
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), sub
    ja, pa = (json.load(open(tmp_path / d / "unet" / "config.json")) for d in ("jax", "port"))
    assert ja == pa
    assert (tmp_path / "port" / "model_index.json").read_text() == \
        (src / "model_index.json").read_text()
    assert TC.load_unet(str(tmp_path / "port" / "unet"))[1].ref_in_channels == 8


# --- training checkpoints ---------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """A tiny UNet's train state after one step, with EMA and a bf16 first
    moment."""
    ucfg, vcfg = TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny()
    unet = build_module(UNet2DConditionModel, ucfg, seed=0)
    vae = build_module(AutoencoderKL, vcfg, seed=1).requires_grad_(False)
    cfg = tstate.TrainerConfig(compute_dtype=torch.float32, remat=False, use_ema=True,
                               learning_rate=1e-3)
    state = tstate.init_state(cfg, {n: p.detach().clone() for n, p in unet.named_parameters()},
                              device="cpu")
    rng = np.random.default_rng(0)
    batch = {"query": rng.integers(0, 256, (1, 1, 32, 32, 3), dtype=np.uint8),
             "q_mask3": rng.integers(0, 2, (1, 1, 32, 32), dtype=np.uint8),
             "supports": rng.integers(0, 256, (1, 1, 1, 32, 32, 3), dtype=np.uint8),
             "s_mask3": rng.integers(0, 2, (1, 1, 1, 32, 32), dtype=np.uint8),
             "shot_mask": np.ones((1, 1, 1), bool)}
    text = torch.zeros((1, 77, ucfg.cross_attention_dim))
    state, _ = tstate.make_train_step(cfg, unet)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0), vae, text)
    return ucfg, cfg, unet, state


def _fresh(cfg, unet):
    return tstate.init_state(cfg, {n: torch.zeros_like(p) for n, p in unet.named_parameters()},
                             device="cpu")


def test_save_load_round_trip(trained, tmp_path):
    ucfg, cfg, unet, state = trained
    stats = {}
    assert tck.save_checkpoint(str(tmp_path), 1, state, ucfg, stats=stats) == \
        str(tmp_path / "checkpoint-1")
    assert stats["bytes"] > 0 and stats["snapshot_s"] >= 0
    assert sorted(os.listdir(tmp_path / "checkpoint-1")) == [
        tck.STATE_FILE, "unet", "unet_ema"]
    got, step = tck.load_checkpoint(tck.latest_checkpoint(str(tmp_path)), _fresh(cfg, unet))
    assert step == 1 and int(got.step) == 1 and int(got.ema.step) == 1
    opt, want = got.opt_state, state.opt_state
    assert int(opt.count) == int(want.count) == 1
    assert int(opt.total_notfinite) == int(want.total_notfinite)
    for a, b in ((got.params, state.params), (opt.mu, want.mu), (opt.nu, want.nu),
                 (got.ema.params, state.ema.params)):
        for n in b:
            assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    assert opt.mu["conv_in.weight"].dtype == torch.bfloat16


def test_snapshot_does_not_alias_live_params(trained, tmp_path, monkeypatch):
    """The background write serialises a copy: a step changing the live
    tensors in place after `save_checkpoint` returns changes nothing on
    disk."""
    ucfg, _, _, state = trained
    release = __import__("threading").Event()
    save = TC.save_unet

    def slow(*a, **kw):
        release.wait(30)
        return save(*a, **kw)

    monkeypatch.setattr(TC, "save_unet", slow)
    want = {n: p.detach().clone() for n, p in state.params.items()}
    h = tck.save_checkpoint(str(tmp_path), 3, state, ucfg, background=True)
    snap = {n: p.data_ptr() for n, p in state.params.items()}
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    release.set()
    h.result()
    got = load_unet_state(str(tmp_path / "checkpoint-3" / "unet"))
    with torch.no_grad():
        for p in state.params.values():
            p.sub_(1.0)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert snap == {n: p.data_ptr() for n, p in state.params.items()}


def test_rotation(trained, tmp_path):
    ucfg, _, _, state = trained
    for s in (1, 2, 3):
        tck.save_checkpoint(str(tmp_path), s, state, ucfg, total_limit=2)
    assert tck.list_checkpoints(str(tmp_path)) == ["checkpoint-2", "checkpoint-3"]


def test_resave_same_step_is_replace_safe(trained, tmp_path):
    ucfg, cfg, unet, state = trained
    tck.save_checkpoint(str(tmp_path), 2, state, ucfg)
    tck.save_checkpoint(str(tmp_path), 2, state, ucfg)
    assert tck.list_checkpoints(str(tmp_path)) == ["checkpoint-2"]
    assert not os.path.exists(tmp_path / "checkpoint-2.old")
    assert not os.path.exists(tmp_path / "checkpoint-2.tmp")
    assert tck.load_checkpoint(tck.latest_checkpoint(str(tmp_path)),
                               _fresh(cfg, unet))[1] == int(state.step)


def test_background_save_failure_surfaces(trained, tmp_path, monkeypatch):
    ucfg, _, _, state = trained

    def boom(*a, **k):
        raise IOError("disk full")

    monkeypatch.setattr(TC, "save_unet", boom)
    h = tck.save_checkpoint(str(tmp_path), 1, state, ucfg, background=True)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        h.result()
    tck.wait_for_pending_saves()  # the handle is drained; the queue is clean
    assert tck.list_checkpoints(str(tmp_path)) == []


def test_background_save_and_tmp_isolation(trained, tmp_path):
    ucfg, cfg, unet, state = trained
    os.makedirs(tmp_path / "checkpoint-99.tmp" / "unet")  # a crashed write
    h = tck.save_checkpoint(str(tmp_path), 5, state, ucfg, total_limit=2, background=True)
    assert h.result().endswith("checkpoint-5")
    assert tck.list_checkpoints(str(tmp_path)) == ["checkpoint-5"]
    assert tck.latest_checkpoint(str(tmp_path)).endswith("checkpoint-5")
    assert tck.load_checkpoint(tck.latest_checkpoint(str(tmp_path)),
                               _fresh(cfg, unet))[1] == int(state.step)
