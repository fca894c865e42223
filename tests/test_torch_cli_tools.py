"""The port's host-side CLIs against the JAX package's (CPU):

  - `cli/launcher.py`: every emitted command parses with the port's
    `cli/evaluate.build_parser` and equals JAX's but for the module (and
    the `--device` passed through), locally and in sbatch files;
  - `cli/measure_baseline.py`: the `cmd` subject's marker timing, warm-up
    exclusion, write guard, training markers and watchdog as
    `tests/test_measure_baseline.py` holds JAX's; the `reference` and
    `reference-train` commands equal JAX's; the `self` subject times the
    port's eval CLI on a tiny checkpoint with `--device cpu`;
  - `cli/verify_parity.py`: phase A against `tools/make_golden.py
    --oracle` on a tiny checkpoint (every error under 5e-3), and from a
    given `--golden`; phase B's mIoU equal to the port eval CLI's on the
    same protocol; the verdict around `--ref_miou`;
  - `examples/torch/serve_client.py --device cpu` drives the port's daemon.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from diffews_tpu.cli import launcher as JL
from diffews_tpu.cli import measure_baseline as JMB
from diffews_tpu_torch.cli import evaluate as TEv
from diffews_tpu_torch.cli import launcher as TL
from diffews_tpu_torch.cli import measure_baseline as TMB
from diffews_tpu_torch.cli import verify_parity as TVP
from helpers import synthetic_data as syn
from helpers.jax_checkpoint import write_jax_checkpoint
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module_swapped(cmd):
    return [a.replace("diffews_tpu_torch.", "diffews_tpu.") for a in cmd]


@pytest.mark.parametrize("extra", [[], ["--device", "cpu"], ["--nshot", "5", "--folds", "2",
                                                             "--r_threshold", "0.3"]])
def test_launcher_commands_parse_and_equal_jax(extra, tmp_path):
    argv = ["--checkpoints", str(tmp_path / "run_a"), str(tmp_path / "run_b"),
            "--base_checkpoint", "/ck", "--dry_run"] + extra
    jargs = JL.build_parser().parse_args([a for a in argv if a not in ("--device", "cpu")])
    targs = TL.build_parser().parse_args(argv)
    for ckpt in targs.checkpoints:
        for fold in targs.folds:
            got, want = TL.eval_command(targs, ckpt, fold), JL.eval_command(jargs, ckpt, fold)
            assert got[:3] == [sys.executable, "-m", "diffews_tpu_torch.cli.evaluate"]
            parsed = TEv.build_parser().parse_args(got[3:])
            assert parsed.fold == fold and parsed.half_precision
            if "--device" in extra:
                assert got[-2:] == ["--device", "cpu"] and parsed.device == "cpu"
                got = got[:-2]
            assert _module_swapped(got) == want


def test_launcher_scan_and_slurm_equal_jax(tmp_path, capsys):
    logs = tmp_path / "logs"
    for exp in ("exp_a", "exp_b_eval", "other"):
        (logs / exp / "checkpoint-20000" / "unet").mkdir(parents=True)
    out = {}
    for name, mod in (("jax", JL), ("torch", TL)):
        sl = tmp_path / name
        mod.main(["--scan_logs", str(logs), "--match", "exp", "--base_checkpoint", "/ck",
                  "--mode", "slurm", "--slurm_dir", str(sl)])
        out[name] = {f: (sl / f).read_text() for f in sorted(os.listdir(sl))}
    assert list(out["torch"]) == list(out["jax"]) and len(out["jax"]) == 4
    for f, text in out["torch"].items():
        assert text.replace("diffews_tpu_torch.", "diffews_tpu.") == out["jax"][f]
    with pytest.raises(SystemExit, match="no checkpoints"):
        TL.main(["--base_checkpoint", "/ck"])


# --- measure_baseline: the harness ------------------------------------------

_FAKE_SUBJECT = (
    "import time\n"
    "print('[Batch: 0001/0120] mIoU: 1.0', flush=True)\n"
    "time.sleep(0.5)\n"
    "print('[Batch: 0051/0120] mIoU: 1.0', flush=True)\n"
    "time.sleep(0.5)\n"
    "print('[Batch: 0101/0120] mIoU: 1.0', flush=True)\n"
)
_FAKE_TRAINER = (
    "import sys, time\n"
    "w = sys.stdout\n"
    "w.write('Steps:   0%|          | 0/300 [00:00<?, ?it/s]\\r')\n"
    "w.flush()\n"
    "time.sleep(0.3)\n"
    "print('step 1/300 loss 0.12345 (1.00 opt-steps/s)', flush=True)\n"
    "time.sleep(0.4)\n"
    "print('step 21/300 loss 0.10000 (1.00 opt-steps/s)', flush=True)\n"
)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cmd_subject_times_markers_and_excludes_warmup(capsys):
    rc = TMB.main(["--subject", "cmd", "--cmd", f"{sys.executable} -c \"{_FAKE_SUBJECT}\"",
                   "--bsz", "2"])
    rec = _last_json(capsys)
    assert rc == 0 and rec["markers"] == 3 and rec["episodes_timed"] == 200
    assert 0.8 <= rec["wall_timed_s"] <= 3.0
    assert rec["qps"] == pytest.approx(200 / rec["wall_timed_s"], rel=2e-2)


def test_train_markers_and_zero_tick(capsys):
    rc = TMB.main(["--subject", "cmd", "--train_markers", "--min_steps", "15",
                   "--cmd", f"{sys.executable} -c \"{_FAKE_TRAINER}\""])
    rec = _last_json(capsys)
    assert rc == 0 and rec["steps_timed"] == 20 and rec["wall_timed_s"] < 0.75


def test_harness_errors_guard_and_watchdog(tmp_path):
    one = "print('[Batch: 0001/0002] x', flush=True)"
    with pytest.raises(SystemExit, match="progress marker"):
        TMB.main(["--subject", "cmd", "--cmd", f"{sys.executable} -c \"{one}\""])
    qps_file = str(tmp_path / "ref_qps.json")
    with pytest.raises(SystemExit, match="refusing"):
        TMB.main(["--subject", "cmd", "--cmd", f"{sys.executable} -c \"{_FAKE_SUBJECT}\"",
                  "--write", "--qps_file", qps_file])
    assert not os.path.exists(qps_file)
    assert TMB.main(["--subject", "cmd", "--cmd", f"{sys.executable} -c \"{_FAKE_SUBJECT}\"",
                     "--write", "--force_write", "--qps_file", qps_file, "--nshot", "5"]) == 0
    assert json.load(open(qps_file))["5shot"]["qps"] > 0
    import time as _t

    t0 = _t.monotonic()
    with pytest.raises(SystemExit, match="watchdog"):
        TMB.main(["--subject", "cmd", "--timeout", "1.5",
                  "--cmd", f"{sys.executable} -c \"import time; time.sleep(60)\""])
    assert _t.monotonic() - t0 < 30


@pytest.mark.parametrize("subject", ["reference", "reference-train", "self", "self-train"])
def test_subject_commands_equal_jax(subject):
    argv = ["--subject", subject, "--reference_repo", "/ref", "--checkpoint", "/ck",
            "--datapath", "/data", "--unet_ckpt_path", "/u", "--scheduler_load_path", "/s",
            "--nshot", "5", "--fold", "2", "--bsz", "4", "--max_episodes", "7"]
    want, wcwd, wenv = JMB.subject_command(JMB.build_parser().parse_args(argv))
    for extra in ([], ["--device", "cpu"]):
        got, cwd, env = TMB.subject_command(TMB.build_parser().parse_args(argv + extra))
        assert env == wenv
        if subject.startswith("reference"):
            assert (got, cwd) == (want, wcwd)
            continue
        assert cwd == ROOT and wcwd == ROOT
        if extra:
            assert got[-2:] == extra
            got = got[:-2]
        assert _module_swapped(got) == want
        assert "diffews_tpu_torch.cli." in got[2]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tiny JAX-saved checkpoint (both packages read it) and a synthetic
    COCO tree."""
    root = tmp_path_factory.mktemp("port_clis")
    ck = write_jax_checkpoint(str(root / "ckpt"))
    syn.make_coco(str(root / "data"))
    return SimpleNamespace(root=root, ck=ck, data=str(root / "data"))


def test_self_subject_times_the_port_eval_cli(tree, capsys, monkeypatch):
    # the subject is a fresh process: one intra-op thread, as the tests run
    # (a tiny model on a pool of threads a core spends its time spinning)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = TMB.main(["--subject", "self", "--checkpoint", tree.ck, "--datapath", tree.data,
                   "--img-size", "32", "--max_episodes", "60", "--device", "cpu",
                   "--log-root", str(tree.root / "mb"), "--timeout", "600"])
    rec = _last_json(capsys)
    assert rc == 0 and rec["subject"] == "self" and rec["markers"] >= 2
    assert rec["episodes_timed"] >= 50 and rec["qps"] > 0 and rec["warmup_excluded_s"] > 0


# --- verify_parity --------------------------------------------------------------

def _vp(tree, out, *extra):
    return TVP.main(["--checkpoint", tree.ck, "--datapath", tree.data, "--benchmark", "coco",
                     "--fold", "0", "--nshot", "1", "--img-size", "32", "--max_episodes", "4",
                     "--out", str(out), "--device", "cpu", *extra])


def _report(out):
    with open(os.path.join(out, "parity_report.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def recorded(tree):
    """One verify_parity run with phase A generating its golden."""
    out = tree.root / "rec"
    return _vp(tree, out), out


def test_verify_parity_golden_phase_and_eval_cli(tree, recorded, tmp_path):
    rc, out = recorded
    assert rc == 0
    rep = _report(out)
    g = rep["golden"]
    assert g["status"] == "pass" and g["generator"] == "oracle", g
    for key in ("unet_max_abs", "unet_ref_max_abs", "vae_enc_max_abs", "vae_dec_max_abs"):
        assert g[key] is not None and g[key] < TVP.GOLDEN_TOL, (key, g)
    # phase B is the port eval CLI on the same protocol
    args = TVP.build_parser().parse_args(["--checkpoint", tree.ck, "--datapath", tree.data,
                                          "--img-size", "32", "--max_episodes", "4",
                                          "--out", str(tmp_path / "cli"), "--device", "cpu"])
    miou, fb = TEv.main(TVP.eval_argv(args))
    assert rep["miou"] == round(miou, 4) and rep["fb_iou"] == round(fb, 4)
    # the same golden handed over with --golden gives the same errors
    out2 = tmp_path / "given"
    assert _vp(tree, out2, "--golden", str(out / "golden" / "golden.npz")) == 0
    g2 = _report(out2)["golden"]
    assert g2["generator"] == "given" and all(g2[k] == g[k] for k in (
        "unet_max_abs", "unet_ref_max_abs", "vae_enc_max_abs", "vae_dec_max_abs"))


def test_verify_parity_golden_fails_on_other_outputs(tree, recorded, tmp_path):
    """A golden whose UNet output is off by 0.1 fails phase A and the run
    (exit 1)."""
    g = dict(np.load(recorded[1] / "golden" / "golden.npz"))
    g["unet_out"] = g["unet_out"] + 0.1
    golden = tmp_path / "other.npz"
    np.savez(golden, **g)
    assert _vp(tree, tmp_path / "bad", "--golden", str(golden)) == 1
    bad = _report(tmp_path / "bad")["golden"]
    assert bad["status"] == "fail" and bad["unet_max_abs"] > 0.09


def test_verify_parity_verdict_around_ref(tree, tmp_path):
    assert _vp(tree, tmp_path / "a", "--skip_golden") == 0
    rep = _report(tmp_path / "a")
    assert rep["golden"]["status"] == "skipped" and rep["verdict"].startswith("recorded")
    miou = rep["miou"]
    assert _vp(tree, tmp_path / "b", "--skip_golden", "--ref_miou", str(miou)) == 0
    assert _report(tmp_path / "b")["verdict"] == "PASS"
    assert _vp(tree, tmp_path / "c", "--skip_golden", "--ref_miou", str(miou + 10)) == 1
    assert _report(tmp_path / "c")["verdict"] == "FAIL"


def test_torch_serve_client_example_runs_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = os.path.join(ROOT, "examples", "torch", "serve_client.py")
    r = subprocess.run([sys.executable, script, "--device", "cpu"], capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("daemon:") and "'platform': 'cpu'" in lines[0]
    assert sum(ln.startswith("frame ") for ln in lines) == 3
    assert lines[-1].startswith("stats: 4 queries")
