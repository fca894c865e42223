"""Port parity of the training CLI: `diffews_tpu_torch.cli.train.main`
(`--device cpu`, f32) against `diffews_tpu.cli.train.main`, both with
`--num_data_shards 1`, on one tiny JAX-saved checkpoint and the synthetic
COCO tree, with the JAX run's posterior noise for `fold_in(PRNGKey(seed),
step)` handed to the port through `train.step_noise`.

Held: the episode batches fed to the step equal the JAX CLI's bit for bit;
the loss of every step within rtol 1e-5; the final `unet/` (written by the
port, read with the port's loader next to the JAX-written one) within
`test_torch_train_step.py`'s parameter rule at lr 1e-3; both with float32
first moments and with the trainers' default bf16 ones.  Then, mirroring
`tests/test_cli.py:181-345` on the port alone: an exact resume from a
mid-run checkpoint in a fresh directory, the foreign-resume final save, the
preemption save plus a bitwise `latest` resume, the signal handler's set
and restore, the `--metrics_jsonl` records, the validation strip and
`eval_results.txt`, the profiler trace.  The multi-device flags outside
`torchrun` (tensor parallelism's included) and a JAX msgpack train state
raise.  Two
JAX CLI runs for the whole file (float32 and bf16 first moments).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as C
from diffews_tpu.cli import train as JT
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu.models import clip_text, unet, vae
from diffews_tpu.parallel import mesh as jmesh
from diffews_tpu.training import state as jstate
from diffews_tpu_torch.cli import train as TT
from diffews_tpu_torch.checkpoint import load_unet_state
from diffews_tpu_torch.training import checkpoints as tck
from helpers import synthetic_data as syn
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-3
STEPS, GAS, B, NSHOT, PX = 4, 2, 2, 2, 32


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny checkpoint written by the JAX savers (as `tests/test_cli.py`
    writes it) and a synthetic COCO tree."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    ucfg, vcfg, tcfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    ck = root / "ckpt"
    C.save_unet(jax.jit(lambda r: unet.init_params(r, ucfg))(jax.random.PRNGKey(0)),
                ucfg, str(ck / "unet"))
    C.save_vae(jax.jit(lambda r: vae.init_params(r, vcfg))(jax.random.PRNGKey(1)),
               vcfg, str(ck / "vae"))
    tp = clip_text.init_params(jax.random.PRNGKey(2), tcfg)
    state = {"text_model." + k: v for k, v in C.pytree_to_torch_state(tp).items()}
    C.save_torch_weights(state, str(ck / "text_encoder"), C.TEXT_SAFETENSORS)
    with open(ck / "text_encoder" / "config.json", "w") as f:
        json.dump({"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4}, f)
    (ck / "scheduler").mkdir()
    with open(ck / "scheduler" / "scheduler_config.json", "w") as f:
        json.dump(SchedulerConfig.diffews().to_diffusers_dict(), f)
    syn.make_coco(str(root / "data"))
    return root


def _common(workdir, out, *extra):
    return ["--pretrained_model_name_or_path", str(workdir / "ckpt"),
            "--datapath", str(workdir / "data"), "--benchmark", "coco", "--fold", "0",
            "--nshot", str(NSHOT), "--resolution", str(PX),
            "--train_batch_size", str(B), "--num_data_shards", "1",
            "--gradient_accumulation_steps", str(GAS), "--checkpointing_steps", "2",
            "--logging_steps", "1", "--output_dir", str(out), "--mixed_precision", "no",
            "--no_remat", "--seed", "0", "--max_train_steps", str(STEPS), *extra]


def _jax_noise(seed, step, shape):
    sub = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return torch.from_numpy(np.stack([np.array(jax.random.normal(k, shape[1:]))
                                      for k in jax.random.split(sub, shape[0])]))


def _parity_run(workdir, root, f32_moments):
    """The JAX CLI and the port CLI on the same flags, lr 1e-3, the batches
    each fed to its step recorded, the port on the JAX noise; with
    `f32_moments` both trainers keep float32 first moments, else their
    default bf16 ones."""
    jax_batches, port_batches = [], []
    put = jmesh.put_global_batch
    make_step = TT.make_train_step

    def record_put(batch, *a, **kw):
        jax_batches.append({k: np.array(v) for k, v in batch.items()})
        return put(batch, *a, **kw)

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, *rest):
            port_batches.append({k: v.numpy().copy() for k, v in batch.items()})
            return step(state, batch, *rest)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "put_global_batch", record_put)
        if f32_moments:
            mp.setattr(jstate, "TrainerConfig",
                       functools.partial(jstate.TrainerConfig, adam_mu_dtype=jnp.float32))
        JT.main(_common(workdir, root / "jax", "--learning_rate", str(LR),
                        "--metrics_jsonl", str(root / "jax.jsonl")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "make_train_step", recording_step)
        mp.setattr(TT, "step_noise", _jax_noise)
        if f32_moments:
            mp.setattr(TT, "TrainerConfig",
                       functools.partial(TT.TrainerConfig, adam_mu_dtype=torch.float32))
        # a checkpoint after every step keeps the first moments of each
        # (the cadence changes no number: see the resume tests)
        report = TT.main(_common(workdir, root / "port", "--learning_rate", str(LR),
                                 "--device", "cpu", "--checkpointing_steps", "1"))
    jlog = [json.loads(line) for line in open(root / "jax.jsonl")]
    return root, jlog, report, jax_batches, port_batches


@pytest.fixture(scope="module")
def parity(workdir, tmp_path_factory):
    """`_parity_run` with float32 first moments on both sides."""
    return _parity_run(workdir, tmp_path_factory.mktemp("parity"), True)


@pytest.fixture(scope="module")
def parity_bf16(workdir, tmp_path_factory):
    """`_parity_run` with both trainers' default bf16 first moments: the
    port's decays by bf16(b1), as optax's under jit (`training/optim.py`)."""
    return _parity_run(workdir, tmp_path_factory.mktemp("parity_bf16"), False)


@pytest.fixture(scope="module")
def port_run(workdir, tmp_path_factory):
    """The port CLI's straight run on its own noise, with validation,
    `--metrics_jsonl` and a profiled step."""
    out = tmp_path_factory.mktemp("port_run") / "run"
    report = TT.main(_common(workdir, out, "--device", "cpu", "--validation_steps", "2",
                             "--validation_episodes", "2", "--validation_image_grids", "1",
                             "--metrics_jsonl", str(out / "metrics.jsonl"),
                             "--profile_step", "2", "--profile_num_steps", "1"))
    return out, report


def _same_unet(a_dir, b_dir):
    a, b = load_unet_state(str(a_dir)), load_unet_state(str(b_dir))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_episode_batches_equal_jax(parity):
    _, _, _, jax_batches, port_batches = parity
    assert len(jax_batches) == len(port_batches) == STEPS
    for jb, tb in zip(jax_batches, port_batches):
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k


def test_losses_and_final_unet_match_jax(parity):
    root, jlog, report, _, _ = parity
    check_losses_and_final_unet(root / "port", root / "jax", jlog, report)


def test_losses_and_final_unet_match_jax_with_bf16_moments(parity_bf16):
    """The trainers' default bf16 first moments: the losses within rtol
    1e-5, as with float32 moments.  The weights under the same rule, but
    with its bound (outside the noise-level entries, and on all but 1e-3 of
    the entries) raised from 1e-3·lr to 2^-8·lr a step: float noise in a gradient (~1e-6 relative between XLA
    and torch) can flip the bf16 rounding of a stored moment that lies near
    a rounding boundary, and one flip moves that entry's Adam update (at
    most about lr) by one bf16 ulp, 2^-8 of it."""
    root, jlog, report, _, _ = parity_bf16
    check_losses_and_final_unet(root / "port", root / "jax", jlog, report,
                                exact=2 ** -8 * LR * STEPS)
    mu = tck.read_train_state(str(root / "port" / f"checkpoint-{STEPS}"))["opt_state"]["mu"]
    assert mu["conv_in.weight"].dtype == torch.bfloat16


def check_losses_and_final_unet(port_dir, jax_dir, jlog, report, exact=1e-3 * LR):
    """The losses within rtol 1e-5; the final `unet/` within `exact` except
    where the port's first moment after some step (a checkpoint after each)
    was at noise level, within 2·lr a step everywhere, and at most 1e-3 of
    the entries off by more than `exact`."""
    assert [r["step"] for r in jlog] == [r["step"] for r in report["log"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([r["loss"] for r in report["log"]],
                               [r["loss"] for r in jlog], rtol=1e-5)
    got = load_unet_state(str(port_dir / f"checkpoint-{STEPS}" / "unet"))
    want = load_unet_state(str(jax_dir / f"checkpoint-{STEPS}" / "unet"))
    assert set(got) == set(want)
    # test_torch_train_step.py's rule, with the port's first moments after
    # each step marking the entries at noise level
    mus = [tck.read_train_state(str(port_dir / f"checkpoint-{s}"))["opt_state"]["mu"]
           for s in range(1, STEPS + 1)]
    off = total = 0
    for name, p in got.items():
        d = (p - want[name]).abs()
        noisy = torch.zeros(d.shape, dtype=torch.bool)
        for mu in mus:
            m = mu[name].float().abs()
            noisy |= m <= 1e-2 * m.max()
        far = (d > exact) & ~noisy
        assert not far.any(), (name, d[far].max().item() / LR)
        assert d.max().item() <= 2 * LR * STEPS, (name, d.max().item() / LR)
        off, total = off + int((d > exact).sum()), total + d.numel()
    assert off <= 1e-3 * total, (off, total)


def test_exact_resume_from_mid_run_checkpoint(workdir, port_run, tmp_path):
    """The stream is a pure function of (seed, step): resuming the straight
    run's checkpoint-2 in a fresh directory lands bit for bit on its
    checkpoint-4 (the straight run alone validated and profiled)."""
    out, _ = port_run
    out2 = tmp_path / "resumed"
    report = TT.main(_common(workdir, out2, "--device", "cpu",
                             "--resume_from_checkpoint", str(out / "checkpoint-2")))
    assert report["global_step"] == STEPS and report["resume_s"] > 0
    _same_unet(out / "checkpoint-4" / "unet", out2 / "checkpoint-4" / "unet")
    a = tck.read_train_state(str(out / "checkpoint-4"))
    b = tck.read_train_state(str(out2 / "checkpoint-4"))
    assert a["step"] == b["step"] == STEPS
    for k in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][k][n], b["opt_state"][k][n])
                   for n in a["opt_state"][k])
    assert a["opt_state"]["mu"]["conv_in.weight"].dtype == torch.bfloat16


def test_foreign_resume_writes_final_checkpoint(workdir, port_run, tmp_path):
    out, _ = port_run
    b = tmp_path / "b"
    argv = _common(workdir, b, "--device", "cpu",
                   "--resume_from_checkpoint", str(out / "checkpoint-2"))
    argv[argv.index("--max_train_steps") + 1] = "2"
    TT.main(argv)
    _same_unet(out / "checkpoint-2" / "unet", b / "checkpoint-2" / "unet")


def test_preemption_checkpoint_and_exact_resume(workdir, port_run, tmp_path, monkeypatch):
    """The stop event trips after step 3 (off the cadence): checkpoint-3 is
    written, checkpoint-4 is not, and resuming `latest` lands bit for bit
    on the straight run's checkpoint-4."""
    out, _ = port_run

    class _TripAfter:
        def __init__(self, n):
            self.n, self.calls = n, 0

        def is_set(self):
            self.calls += 1
            return self.calls >= self.n

    monkeypatch.setattr(TT, "_install_preemption_handler",
                        lambda: (_TripAfter(3), lambda: None))
    out2 = tmp_path / "preempted"
    report = TT.main(_common(workdir, out2, "--device", "cpu"))
    assert report["preempted"] and report["global_step"] == 3
    assert (out2 / "checkpoint-3" / "unet").is_dir()
    assert not (out2 / "checkpoint-4").exists()
    monkeypatch.undo()
    TT.main(_common(workdir, out2, "--device", "cpu", "--resume_from_checkpoint", "latest"))
    _same_unet(out / "checkpoint-4" / "unet", out2 / "checkpoint-4" / "unet")


def test_preemption_handler_sets_event_and_restores():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    stop, restore = TT._install_preemption_handler()
    assert not stop.is_set()
    signal.raise_signal(signal.SIGTERM)
    assert stop.is_set()  # and the process is still alive
    restore()
    assert signal.getsignal(signal.SIGTERM) is before


def test_metrics_validation_and_profile_outputs(port_run):
    out, report = port_run
    recs = [json.loads(line) for line in (out / "metrics.jsonl").open()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all({"loss", "steps_per_s", "wall_s", "total_notfinite"} == set(r) - {"step"}
               for r in recs)
    assert [round(r["loss"], 6) for r in report["log"]] == [r["loss"] for r in recs]
    assert (out / "validation" / "step-2_ep-0.jpg").is_file()
    assert (out / "validation" / "step-4_ep-0.jpg").is_file()
    lines = (out / "eval_results.txt").read_text().splitlines()
    assert [l.split(":")[0] for l in lines] == ["step 2", "step 4"]
    assert all("val mIoU" in l for l in lines)
    traces = list((out / "profile").glob("*.json"))
    assert len(traces) == 1
    events = json.load(traces[0].open())["traceEvents"]
    assert any(e.get("name") == "diffews.train.optimizer" for e in events)
    assert [s["step"] for s in report["saves"]] == [2, 4]
    assert all(s["bytes"] > 0 and s["write_s"] > 0 for s in report["saves"])


@pytest.mark.parametrize("flag", [["--fsdp"], ["--multihost"], ["--num_data_shards", "2"],
                                  ["--num_model_shards", "2"]])
def test_multi_device_flags_raise(workdir, tmp_path, flag):
    """The data-parallel, FSDP and tensor-parallel flags outside a
    `torchrun` launch raise, saying how to launch them
    (`test_torch_parallel_train_cli.py` and `test_torch_tensor_parallel.py`
    run them under one)."""
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"
                       if flag[-1] == "2" else "torchrun"):
        TT.main(_common(workdir, tmp_path / "x", "--device", "cpu", *flag))


@pytest.mark.parametrize("raises", [False, True])
def test_cuda_run_sets_and_restores_cudnn_setting(monkeypatch, raises):
    """On a CUDA device `main` trains under `cudnn.deterministic` (exact
    resume) and puts the process's setting back when it returns or raises,
    so that what runs after it in the process keeps its own numerics."""
    seen = []

    def train(args, device):
        seen.append(torch.backends.cudnn.deterministic)
        if raises:
            raise RuntimeError("stopped")
        return {"device": str(device)}

    monkeypatch.setattr(TT, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(TT, "_train", train)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    argv = ["--pretrained_model_name_or_path", "unused"]
    if raises:
        with pytest.raises(RuntimeError, match="stopped"):
            TT.main(argv)
    else:
        assert TT.main(argv) == {"device": "cuda"}
    assert seen == [True]
    assert torch.backends.cudnn.deterministic is False


def test_jax_msgpack_state_raises(workdir, parity, tmp_path):
    root = parity[0]
    jax_ckpt = root / "jax" / "checkpoint-2"
    assert (jax_ckpt / "train_state.msgpack").is_file()
    with pytest.raises(ValueError, match="train_state.msgpack"):
        TT.main(_common(workdir, tmp_path / "y", "--device", "cpu",
                        "--resume_from_checkpoint", str(jax_ckpt)))


def test_missing_train_state_raises(port_run, tmp_path):
    out, _ = port_run
    import shutil

    shutil.copytree(out / "checkpoint-2" / "unet", tmp_path / "checkpoint-2" / "unet")
    with pytest.raises(FileNotFoundError, match="train_state.pt"):
        tck.read_train_state(str(tmp_path / "checkpoint-2"))


def test_without_a_card_the_cli_raises(workdir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(_common(workdir, tmp_path / "z"))
