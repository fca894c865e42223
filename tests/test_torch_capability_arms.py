"""The capability arms of `tools/torch_train_capability.py` (`--task
incontext | incontext_nshot`, `--shot_curve`, `--curve_episodes`,
`--attn_mask_variant`):

  - each arm's eval and train CLI argv equal the JAX tool's
    (`tools/train_capability.py`) but for the port's `--device`, with the
    same synthetic-data call (the stages are recorded, not run);
  - a few-step smoke of each arm through the port's real CLIs on the CPU,
    with the JAX tool's report keys.
"""

import json
import os
import sys

import pytest

from helpers import synthetic_data
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_train_capability as TCap  # noqa: E402
import train_capability as JCap  # noqa: E402

ARMS = {"attnmask": ["--task", "incontext", "--attn_mask_variant"],
        "multishot": ["--task", "incontext_nshot", "--nshot", "3"],
        "incontext": ["--task", "incontext", "--lr", "7e-4"],
        "curve": ["--task", "visible", "--shot_curve", "1,2", "--curve_episodes", "3"]}
REPORT_KEYS = {"task", "steps", "lr", "nshot_train", "attn_mask_variant", "shot_curve",
               "curve_episodes", "vae_pretrain", "episodes", "miou_random_init",
               "miou_trained", "fb_iou_random_init", "fb_iou_trained", "improvement_x",
               "loss_first", "loss_last", "mid_run_validation", "wall_s", "workdir"}


def _record(monkeypatch, evaluate, train, tool, calls):
    """Stand-ins for the tool's stages: the data call, the VAE pretraining,
    the checkpoint and the two CLIs are recorded."""
    def make_coco(root, **kw):
        calls.append(("make_coco", kw))

    def fake_train(argv):
        calls.append(("train", list(argv)))
        out = argv[argv.index("--output_dir") + 1]
        steps = argv[argv.index("--max_train_steps") + 1]
        os.makedirs(os.path.join(out, f"checkpoint-{steps}", "unet"), exist_ok=True)
        with open(os.path.join(out, "eval_results.txt"), "w") as f:
            f.write("step 1: val\nstep 2: val\n")
        return {"log": [{"loss": 1.0}, {"loss": 0.5}]}

    class _Vae:
        def cpu(self):
            return self

    monkeypatch.setattr(synthetic_data, "make_coco", make_coco)
    monkeypatch.setattr(tool, "pretrain_vae", lambda *a, **kw: (_Vae(), 0.01, 0.99))
    monkeypatch.setattr(tool, "build_checkpoint", lambda *a, **kw: None)
    monkeypatch.setattr(evaluate, "main", lambda argv: calls.append(("eval", list(argv)))
                        or (50.0, 60.0))
    monkeypatch.setattr(train, "main", fake_train)


def _strip_device(argv):
    if "--device" in argv:
        i = argv.index("--device")
        argv = argv[:i] + argv[i + 2:]
    return argv


@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_argv_equal_jax(arm, monkeypatch, tmp_path):
    from diffews_tpu.cli import evaluate as JE
    from diffews_tpu.cli import train as JT
    from diffews_tpu_torch.cli import evaluate as TE
    from diffews_tpu_torch.cli import train as TT

    argv = ["--workdir", str(tmp_path / "w"), "--steps", "6", "--episodes", "5"] + ARMS[arm]
    calls = {"jax": [], "torch": []}
    with monkeypatch.context() as m:
        _record(m, JE, JT, JCap, calls["jax"])
        JCap.main(argv + ["--out", str(tmp_path / "jax.json")])
    with monkeypatch.context() as m:
        _record(m, TE, TT, TCap, calls["torch"])
        report = TCap.main(argv + ["--device", "cpu", "--out", str(tmp_path / "torch.json")])
    got = [(kind, _strip_device(a) if kind != "make_coco" else a)
           for kind, a in calls["torch"]]
    assert got == calls["jax"]
    assert all("--device" in a and a[a.index("--device") + 1] == "cpu"
               for kind, a in calls["torch"] if kind != "make_coco")
    want = json.load(open(tmp_path / "jax.json"))
    assert REPORT_KEYS <= set(report) and REPORT_KEYS <= set(want)
    for key in ("task", "steps", "nshot_train", "attn_mask_variant", "curve_episodes"):
        assert report[key] == want[key], key
    assert (report["shot_curve"] or {}).keys() == (want["shot_curve"] or {}).keys()


@pytest.mark.parametrize("arm", ["attnmask", "multishot", "incontext"])
def test_arm_smoke_on_the_cpu(arm, tmp_path):
    """Two steps of each arm through the port's real CLIs."""
    extra = ARMS[arm] + (["--shot_curve", "1,3", "--curve_episodes", "2"]
                         if arm == "multishot" else [])
    report = TCap.main(["--device", "cpu", "--steps", "2", "--vae_steps", "2",
                        "--episodes", "2", "--validation_episodes", "1",
                        "--workdir", str(tmp_path / arm),
                        "--out", str(tmp_path / f"{arm}.json")] + extra)
    assert REPORT_KEYS <= set(report)
    assert report["task"].startswith(ARMS[arm][1])
    assert report["attn_mask_variant"] == (arm == "attnmask")
    assert os.path.isdir(tmp_path / arm / "train" / "checkpoint-2" / "unet")
    if arm == "multishot":
        assert report["nshot_train"] == 3 and set(report["shot_curve"]) == {"1", "3"}
    assert len(report["mid_run_validation"]) == 2
