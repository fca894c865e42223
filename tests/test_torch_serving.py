"""Port parity of the AOT serving artifact: `diffews_tpu_torch.serving` and
`diffews_tpu_torch.cli.export` (mirroring `tests/test_serving.py`).

One tiny checkpoint written by the JAX savers feeds the port's export CLI
(`--device cpu`), the port's pipeline and the JAX pipeline.  Held: the
artifact, loaded in a fresh process that imports only
`diffews_tpu_torch.serving`, equals the port pipeline's uint8 episode bit
for bit, and the JAX pipeline's within the episode contract (uint8 within 1
count on < 1% of pixels); the manifest's keys; the default all-valid shot
mask; the `--vae_impl int8` artifact equal to the int8 `predict` bit for
bit; a wrong shape raising; a card artifact refusing to load on a host
without a card; and, rehearsing the card's route on the CPU (every kernel
call through its custom op, as on the card), each kernel call is one op
node of the exported program and the program equals the eager episode.
"""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import pipeline as JP
from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch import serving
from diffews_tpu_torch.cli import export as TX
from diffews_tpu_torch.ops import flash_attention as FA
from diffews_tpu_torch.ops import groupnorm as GN
from helpers.int8_ties import small_calibration
from helpers.jax_checkpoint import write_jax_checkpoint
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, S = 2, 2, 32


def _episode(b, n, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (b, s, s, 3), np.uint8),
            rng.integers(0, 255, (b, n, s, s, 3), np.uint8),
            (rng.random((b, n, s, s)) > 0.5).astype(np.uint8))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_jax_checkpoint(str(tmp_path_factory.mktemp("torch_serving") / "ckpt"))


@pytest.fixture(scope="module")
def art_dir(ckpt):
    """The artifact, written by the export CLI on the CPU."""
    out = os.path.join(os.path.dirname(ckpt), "art")
    assert TX.main(["--checkpoint", ckpt, "--out", out, "--bsz", str(B), "--nshot", str(N),
                    "--img-size", str(S), "--device", "cpu"]) == out
    return out


@pytest.fixture(scope="module")
def mod(art_dir):
    return serving.load(art_dir)


@pytest.fixture(scope="module")
def pipe(ckpt):
    return TP.DiffewsPipeline.from_pretrained(ckpt, device="cpu")


def test_fresh_process_matches_pipelines(art_dir, ckpt, pipe, tmp_path):
    q, sup, msk = _episode(B, N, S)
    sm = np.ones((B, N), bool)
    sm[1, 1] = False
    np.savez(tmp_path / "episode.npz", q=q, sup=sup, msk=msk, sm=sm)
    # the fresh process runs torch on one intra-op thread, as `pipe.predict`
    # here does (`one_torch_thread`): oneDNN's CPU convolutions sum in
    # another order on another thread count, and the comparison is bit for bit
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import diffews_tpu_torch.serving as serving\n"
        f"e = np.load({str(tmp_path / 'episode.npz')!r})\n"
        f"mod = serving.load({art_dir!r})\n"
        "out = mod(e['q'], e['sup'], e['msk'], e['sm'])\n"
        "assert out.dtype == __import__('torch').uint8, out.dtype\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'diffews_tpu.'))\n"
        "       or m == 'diffews_tpu']\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert r.returncode == 0, r.stderr
    got = np.load(tmp_path / "out.npy")
    assert got.dtype == np.uint8 and got.shape == (B, S, S, 3)
    np.testing.assert_array_equal(got, pipe.predict(q, sup, msk, shot_mask=sm).seg_colored)

    jpipe = JP.DiffewsPipeline.from_pretrained(ckpt)
    want = np.asarray(jpipe._predict_jit(
        jpipe.unet_params, jpipe.vae_params, jnp.asarray(q), jnp.asarray(sup),
        jnp.asarray(msk), jpipe.empty_text_embed, jnp.asarray(sm), 1))
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 0.01, (d.max(), (d != 0).mean())


def test_int8_artifact_equals_int8_predict(ckpt, tmp_path):
    """`cli/export.py --vae_impl int8` (as the JAX CLI offers it): the
    loaded artifact equals the int8 pipeline's `predict` bit for bit (both
    calibrate at 64 px), and its program holds the int8 weights."""
    out = str(tmp_path / "art_int8")
    with small_calibration():
        TX.main(["--checkpoint", ckpt, "--out", out, "--bsz", str(B), "--nshot", str(N),
                 "--img-size", str(S), "--vae_impl", "int8", "--device", "cpu"])
        pipe = TP.DiffewsPipeline.from_pretrained(ckpt, device="cpu", vae_impl="int8")
    art = serving.load(out)
    q, sup, msk = _episode(B, N, S, seed=3)
    np.testing.assert_array_equal(art(q, sup, msk).numpy(),
                                  pipe.predict(q, sup, msk).seg_colored)
    names = art._call.state_dict().keys()
    assert any(k.endswith("weight_q") for k in names) and any(k.endswith(".s_a") for k in names)


def test_manifest_describes_the_contract(mod):
    m = mod.manifest
    assert set(m) == {"bsz", "nshot", "img_size", "denoising_steps", "platforms", "inputs",
                      "output", "torch_version"}
    assert (m["bsz"], m["nshot"], m["img_size"], m["denoising_steps"]) == (B, N, S, 1)
    assert m["platforms"] == ["cpu"] and m["torch_version"] == torch.__version__
    assert set(m["inputs"]) == {"query", "supports", "masks", "shot_mask"}


def test_default_shot_mask_is_all_valid(mod):
    q, sup, msk = _episode(B, N, S, seed=3)
    got = mod(q, sup, msk)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, S, S, 3)
    assert torch.equal(got, mod(q, sup, msk, np.ones((B, N), bool)))


def test_artifact_shape_mismatch_raises(mod):
    q, sup, msk = _episode(B + 1, N, S)  # wrong batch for the artifact
    with pytest.raises(ValueError, match="query"):
        mod(q, sup, msk, np.ones((B + 1, N), bool))


def test_card_artifact_refuses_a_host_without_a_card(art_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    card = tmp_path / "card_art"
    shutil.copytree(art_dir, card)
    with open(card / serving.MANIFEST) as f:
        manifest = json.load(f)
    with open(card / serving.MANIFEST, "w") as f:
        json.dump({**manifest, "platforms": ["cuda"]}, f)
    with pytest.raises(RuntimeError, match="exported on a CUDA device"):
        serving.load(str(card))


def test_card_route_exports_one_node_per_kernel_call(pipe, monkeypatch):
    """The card's route, rehearsed on the CPU: with every flash and GroupNorm
    call going through its custom op (as `_forward` does for a CUDA
    tensor), the exported program holds one op node per kernel call, the
    counts a launch counter would show, and equals the eager episode."""
    monkeypatch.setattr(FA, "_forward", lambda q, k, v, scale, kv_mask:
                        FA.flash_attention_fwd(q, k, v, kv_mask, float(scale)))
    plain = GN._forward
    monkeypatch.setattr(GN, "_forward", lambda x, w, b, g, eps, act, impl:
                        GN._kernels(x, w, b, g, eps, act) if x.ndim == 4
                        else plain(x, w, b, g, eps, act, impl))
    q, sup, msk = _episode(1, 1, S, seed=5)
    sm = np.ones((1, 1), bool)
    program, _ = serving.export_predict(pipe, bsz=1, nshot=1, img_size=S)
    nodes = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("diffews_tpu_torch."):
            nodes[str(node.target)] = nodes.get(str(node.target), 0) + 1
    # flash: 2 calls at each of the tiny UNet's 4 self-attention sites and
    # 1 in each VAE mid block; GroupNorm: every 4-D GroupNorm of the UNet,
    # the encoder and the decoder
    assert nodes == {"diffews_tpu_torch.flash_attention_fwd.default": 10,
                     "diffews_tpu_torch.gn_stats.default": 38,
                     "diffews_tpu_torch.gn_apply.default": 38}
    got = program.module()(*(torch.as_tensor(x) for x in (q, sup, msk, sm)))
    np.testing.assert_array_equal(got.numpy(),
                                  pipe.predict(q, sup, msk, shot_mask=sm).seg_colored)
