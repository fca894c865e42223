"""Port parity of the eval harness: `diffews_tpu_torch.cli.evaluate.main`
(on the CPU, `--device cpu`) against `diffews_tpu.cli.evaluate.main` on one
tiny JAX-saved checkpoint (UNet, VAE, CLIP text encoder, scheduler) and the
synthetic benchmark trees.

Held: (mIoU, FB-IoU) equal to the JAX CLI's within 1e-9 on COCO fold 0
over 8 episodes and on every other benchmark; `--bsz 2`,
`--mask_on_device`, `--dispatch_ahead 1` and `raw_images=False` equal the
default run; `--use_original_imgsize` equals the JAX CLI's; the
`_TEST_<bench>_<stamp>.log/log.txt` contract with its `[Batch: ...]`
markers; the flag mapping onto the pipeline; the int8 (A12) flags against
the JAX CLI's past quantizer ties (`helpers/int8_ties.py`); the
multi-device (A11) flags outside `torchrun` raise; without `--device` a
host with no card raises.
"""

import os

import jax
import numpy as np
import pytest
import torch

from diffews_tpu.cli import evaluate as JE
from diffews_tpu_torch.cli import evaluate as TE
from helpers import synthetic_data as syn
from helpers.int8_ties import int8_parity
from helpers.jax_checkpoint import write_jax_checkpoint
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny checkpoint written by the JAX savers (as `tests/test_cli.py`
    writes it) and a synthetic COCO tree."""
    root = tmp_path_factory.mktemp("torch_cli")
    write_jax_checkpoint(str(root / "ckpt"))
    syn.make_coco(str(root / "data"))
    return root


def _argv(workdir, bench="coco", datapath=None, episodes=8, logs="logs", fold=0):
    return ["--checkpoint", str(workdir / "ckpt"),
            "--datapath", str(datapath or workdir / "data"),
            "--benchmark", bench, "--fold", str(fold), "--nshot", "1",
            "--img-size", "32", "--denoise_steps", "1", "--ensemble_size", "1",
            "--threshold", "0", "--r_threshold", "0.25",
            "--log-root", str(workdir / logs), "--max_episodes", str(episodes)]


def _close(a, b):
    assert abs(a[0] - b[0]) <= TOL and abs(a[1] - b[1]) <= TOL, (a, b)


@pytest.fixture(scope="module")
def coco_port(workdir):
    return TE.main(_argv(workdir) + ["--device", "cpu"])


def test_coco_metrics_equal_jax(workdir, coco_port):
    want = JE.main(_argv(workdir))
    _close(coco_port, want)
    assert np.isfinite(coco_port).all() and coco_port[0] > 0


@pytest.mark.parametrize("extra", [["--bsz", "2", "--max_episodes", "4"],
                                   ["--mask_on_device"], ["--dispatch_ahead", "1"],
                                   ["--nworker", "2"]],
                         ids=["bsz2", "mask_on_device", "dispatch_ahead1", "nworker2"])
def test_variants_equal_default(workdir, coco_port, extra):
    """`--max_episodes` counts batches: 4 batches of 2 are the same 8
    episodes."""
    _close(TE.main(_argv(workdir) + ["--device", "cpu"] + extra), coco_port)


def test_host_normalised_images_equal_raw(workdir, coco_port):
    args = TE.build_parser().parse_args(_argv(workdir) + ["--device", "cpu"])
    _close(TE.evaluate(args, raw_images=False), coco_port)


def test_original_imgsize_equals_jax(workdir):
    argv = _argv(workdir, episodes=4) + ["--use_original_imgsize"]
    _close(TE.main(argv + ["--device", "cpu"]), JE.main(argv))


@pytest.mark.parametrize("bench,fold,maker", [
    ("pascal", 1, syn.make_pascal), ("fss", 0, syn.make_fss), ("lvis", 0, syn.make_lvis),
    ("paco_part", 0, lambda r: syn.make_paco(r, n_classes=448, imgs_per_class=3)),
    ("pascal_part", 0, syn.make_pascal_part), ("pascal_cd", 1, syn.make_pascal_cd)])
def test_other_benchmarks_equal_jax(workdir, tmp_path, bench, fold, maker):
    maker(str(tmp_path))
    argv = _argv(workdir, bench, datapath=tmp_path, episodes=4, fold=fold)
    got = TE.main(argv + ["--device", "cpu"])
    assert np.isfinite(got).all()
    _close(got, JE.main(argv))


def test_log_dir_contract(workdir, tmp_path):
    """`_TEST_<bench>_<stamp>.log/log.txt`: the argument table, a
    `[Batch: ...]` line every 50 batches from the first, the result, the
    throughput and the final mIoU line; the same metric lines as the JAX
    CLI's log."""
    logs = {}
    for name, mod, extra in (("t", TE, ["--device", "cpu"]), ("j", JE, [])):
        argv = _argv(workdir, episodes=3, logs=f"contract_{name}")
        mod.main(argv + extra)
        d = workdir / f"contract_{name}"
        (sub,) = os.listdir(d)
        assert sub.startswith("_TEST_coco_") and sub.endswith(".log")
        with open(d / sub / "log.txt") as f:
            logs[name] = f.read().splitlines()
    t = logs["t"]
    assert any(s.startswith("[Batch: 0001/1000] mIoU:") for s in t)
    assert sum(s.startswith("[Batch:") for s in t) == 1
    assert any(s.startswith("throughput:") and s.endswith("s)") for s in t)
    assert t[-1].startswith("mIoU:") and "FB-IoU:" in t[-1]
    assert any("device" in s and "cpu" in s for s in t if s.startswith("|"))
    metric = lambda lines: [s for s in lines if "IoU" in s]
    assert metric(t) == metric(logs["j"]) and metric(t)


def test_flags_map_onto_the_pipeline(workdir, monkeypatch):
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    seen = {}

    class Stop(Exception):
        pass

    def fake(checkpoint, unet_dir=None, scheduler_dir=None, **kw):
        seen.update(kw, checkpoint=checkpoint, unet_dir=unet_dir, scheduler_dir=scheduler_dir)
        raise Stop

    monkeypatch.setattr(DiffewsPipeline, "from_pretrained", staticmethod(fake))
    with pytest.raises(Stop):
        TE.main(_argv(workdir) + ["--device", "cpu", "--half_precision", "--attn_impl", "xla",
                                  "--test_timestep", "500", "--encode_chunks", "3",
                                  "--vae_impl", "mixed", "--attn_mask_variant",
                                  "--unet_ckpt_path", "U", "--scheduler_load_path", "S"])
    assert seen["compute_dtype"] is torch.bfloat16 and seen["attn_impl"] == "dense"
    assert seen["device"] == torch.device("cpu") and seen["test_timestep"] == 500
    assert seen["encode_chunks"] == 3 and seen["vae_impl"] == "mixed"
    assert seen["attn_mask_variant"] is True and seen["unet_int8"] is False
    assert (seen["unet_dir"], seen["scheduler_dir"]) == ("U", "S")
    assert {TE.ATTN_IMPLS[k] for k in ("auto", "pallas")} == {"auto", "flash"}


def test_parser_matches_jax_plus_device():
    """The same flags, defaults and choices as the JAX CLI, and `--device`."""
    def table(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required)
                for a in p._actions if a.dest != "help"}

    got, want = table(TE.build_parser()), table(JE.build_parser())
    assert got.pop("device") == (("--device",), None, None, False)
    got["attn_impl"] = got["attn_impl"][:2] + (sorted(want["attn_impl"][2]),) + \
        got["attn_impl"][3:]
    want["attn_impl"] = want["attn_impl"][:2] + (sorted(want["attn_impl"][2]),) + \
        want["attn_impl"][3:]
    assert got == want


@pytest.mark.parametrize("extra,match", [
    pytest.param(["--num_data_shards", "2"], "torchrun", id="extra0-A11"),
    pytest.param(["--num_shot_shards", "2"], "torchrun", id="extra1-A11"),
    pytest.param(["--vae_impl", "int8"], "A12", id="extra2-A12"),
    pytest.param(["--vae_impl", "int8", "--unet_int8"], "A12", id="extra3-A12")])
def test_unported_flags_raise(workdir, extra, match):
    """The multi-device flags (A11) outside a `torchrun` launch raise,
    saying how to launch them.  The int8 flags (A12, ported) run against
    the JAX CLI with the same flags over 4 episodes: the int8 codes equal
    JAX's but at ties and, with JAX's codes fed forward past each tie
    (`helpers/int8_ties.py`), (mIoU, FB-IoU) equal within 1e-9 (both
    calibrate at 64 px)."""
    if match == "torchrun":
        with pytest.raises(RuntimeError, match=match):
            TE.main(_argv(workdir) + ["--device", "cpu"] + extra)
        return
    argv = _argv(workdir, episodes=4, logs="int8") + extra
    with int8_parity() as ties:
        ties.take()
        want = JE.main(argv)
        jax.effects_barrier()
        with ties.force(ties.take()):
            got = TE.main(argv + ["--device", "cpu"])
    ties.check_ties()
    _close(got, want)
    assert np.isfinite(got).all()


def test_no_card_without_device_raises(workdir, monkeypatch):
    """Without `--device cpu` the harness runs on the card; with none it
    raises before it loads or logs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.main(_argv(workdir, logs="no_card"))
    assert not (workdir / "no_card").exists()


def test_port_written_checkpoint_loads_and_evaluates(workdir, tmp_path):
    """The checkpoint writer the GPU test and `chip_smoke.py` use: its
    weights load back bit for bit and the harness runs from it."""
    from diffews_tpu_torch import checkpoint as TC
    from diffews_tpu_torch import configs as TCF
    from helpers.port_checkpoint import write_checkpoint

    cfgs = (TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), TCF.CLIPTextConfig.tiny(),
            TCF.SchedulerConfig.diffews())
    root = write_checkpoint(str(tmp_path / "ckpt"), *cfgs, seed=3)
    got, want = TC.load_pipeline_bundle(root), TC.random_pipeline_bundle(*cfgs, seed=3)
    for a, b in ((got.unet, want.unet), (got.vae, want.vae), (got.text, want.text)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert (got.unet_cfg, got.text_cfg, got.scheduler_cfg) == (cfgs[0], cfgs[2], cfgs[3])
    argv = _argv(workdir, episodes=2) + ["--device", "cpu"]
    argv[argv.index("--checkpoint") + 1] = root
    assert np.isfinite(TE.main(argv)).all()
