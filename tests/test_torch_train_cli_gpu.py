"""The training CLI on the card: `diffews_tpu_torch.cli.train.main` with
the kernels against the same run on the CPU (plain versions).

A tiny checkpoint written by the port's savers and a synthetic COCO tree;
f32 with TF32 off and float32 first moments (card-vs-CPU gradient noise
must not flip a bf16 rounding), 32px, 2 shots, batch 2, gas 2, 4 steps
with a checkpoint after each.  Held: the losses per step within rtol 1e-4;
checkpoint-4's weights (LoRA: its adapters) within phase tiny_train's rule
of `chip_smoke.py` (1e-3·lr on 99.9% of the entries, 2·lr per step
everywhere, larger only where a first moment was at noise level); a
resume of checkpoint-2 on the card bit for bit equal to the straight run;
the LoRA checkpoint's `unet/` float32, different from the base exactly at
the adapted sites; the kernel launches of each CLI step equal those of
bare `make_train_step` micro-steps.  Marked `gpu`: each test skips without
a CUDA device.  This file imports no JAX; run it on the GPU host with

    python -m pytest --noconftest -m gpu tests/test_torch_train_cli_gpu.py
"""

import functools
import json

import numpy as np
import pytest
import torch

from diffews_tpu_torch.cli import train as TT
from diffews_tpu_torch.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch.ops import groupnorm
from diffews_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
from diffews_tpu_torch.checkpoint import load_unet_state
from diffews_tpu_torch.training import checkpoints as tck
from diffews_tpu_torch.training import lora as lora_lib
from helpers import synthetic_data as syn
from helpers.port_checkpoint import write_checkpoint

pytestmark = pytest.mark.gpu
LR, STEPS = 1e-3, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli_gpu")
    write_checkpoint(str(root / "ckpt"), UNetConfig.tiny(), VAEConfig.tiny(),
                     CLIPTextConfig.tiny(), SchedulerConfig.diffews(), seed=0,
                     safetensors=True)
    syn.make_coco(str(root / "data"))
    return root


def _argv(workdir, out, device, *extra):
    return ["--pretrained_model_name_or_path", str(workdir / "ckpt"),
            "--datapath", str(workdir / "data"), "--benchmark", "coco", "--fold", "0",
            "--nshot", "2", "--resolution", "32", "--train_batch_size", "2",
            "--gradient_accumulation_steps", "2", "--max_train_steps", str(STEPS),
            "--checkpointing_steps", "1", "--logging_steps", "1",
            "--learning_rate", str(LR), "--mixed_precision", "no", "--seed", "0",
            "--output_dir", str(out), "--metrics_jsonl", str(out / "metrics.jsonl"),
            "--device", device, *extra]


def _counts():
    return (flash_attention.launches, flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches, groupnorm.gn_stats_kernel.launches,
            groupnorm.gn_apply_kernel.launches)


def _run(workdir, out, device, monkeypatch, *extra):
    """The CLI with float32 first moments; each step's launches recorded."""
    monkeypatch.setattr(TT, "TrainerConfig",
                        functools.partial(TT.TrainerConfig, adam_mu_dtype=torch.float32))
    steps, make = [], TT.make_train_step

    def counted(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            before = _counts()
            out = step(*args)
            steps.append(tuple(x - y for x, y in zip(_counts(), before)))
            return out

        return run

    monkeypatch.setattr(TT, "make_train_step", counted)
    report = TT.main(_argv(workdir, out, device, *extra))
    monkeypatch.undo()
    return report, steps


def _close(got, want, mu_hist, what):
    off = total = 0
    for name, p in got.items():
        d = (p - want[name]).abs()
        bad = d > 1e-3 * LR
        noisy = torch.zeros_like(bad)
        for mu in mu_hist:
            m = mu[name].abs()
            noisy |= m <= 1e-2 * m.max()
        assert not (bad & ~noisy).any(), (what, name, d[bad & ~noisy].max().item() / LR)
        assert d.max().item() <= 2 * LR * STEPS, (what, name, d.max().item() / LR)
        off, total = off + int(bad.sum()), total + bad.numel()
    assert off <= 1e-3 * total, (what, off, total)


def _losses(out):
    return [json.loads(line)["loss"] for line in (out / "metrics.jsonl").open()]


@pytest.mark.parametrize("lora", [False, True])
def test_cli_on_the_card_matches_cpu(cuda, workdir, tmp_path, monkeypatch, lora):
    extra = ("--lora_rank", "2", "--use_ema") if lora else ()
    _run(workdir, tmp_path / "cpu", "cpu", monkeypatch, *extra)
    _run(workdir, tmp_path / "gpu", cuda, monkeypatch, *extra)
    np.testing.assert_allclose(_losses(tmp_path / "gpu"), _losses(tmp_path / "cpu"), rtol=1e-4)
    state = lambda d, s: tck.read_train_state(str(tmp_path / d / f"checkpoint-{s}"))  # noqa
    mu_hist = [state("cpu", s)["opt_state"]["mu"] for s in range(1, STEPS + 1)]
    if lora:
        _close(state("gpu", STEPS)["lora"], state("cpu", STEPS)["lora"], mu_hist, "lora")
    else:
        _close(load_unet_state(str(tmp_path / "gpu" / f"checkpoint-{STEPS}" / "unet")),
               load_unet_state(str(tmp_path / "cpu" / f"checkpoint-{STEPS}" / "unet")),
               mu_hist, "unet")


def test_resume_on_the_card_is_bit_exact(cuda, workdir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _run(workdir, tmp_path / "a", cuda, monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _run(workdir, tmp_path / "b", cuda, monkeypatch, "--resume_from_checkpoint",
         str(tmp_path / "a" / "checkpoint-2"))
    a = load_unet_state(str(tmp_path / "a" / f"checkpoint-{STEPS}" / "unet"))
    b = load_unet_state(str(tmp_path / "b" / f"checkpoint-{STEPS}" / "unet"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert _losses(tmp_path / "a")[2:] == _losses(tmp_path / "b")


def test_lora_checkpoint_is_merged_f32(cuda, workdir, tmp_path, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = True
    argv = _argv(workdir, tmp_path / "l", cuda, "--lora_rank", "2")
    argv[argv.index("--mixed_precision") + 1] = "bf16"
    TT.main(argv)
    merged = load_unet_state(str(tmp_path / "l" / f"checkpoint-{STEPS}" / "unet"))
    base = load_unet_state(str(workdir / "ckpt" / "unet"))
    sites = {p + ".weight" for p in lora_lib.lora_sites(base, lora_lib.attn_target)}
    assert set(merged) == set(base) and sites
    for n, t in merged.items():
        assert t.dtype == torch.float32, n
        assert torch.equal(t, base[n]) == (n not in sites), n


def test_cli_step_launches_equal_bare_micro_steps(cuda, workdir, tmp_path, monkeypatch):
    """Each CLI step (gas 2) launches what two bare micro-steps of
    `make_train_step` launch on the same shapes: every flash forward, dq,
    dkv and GroupNorm launch of the path, none elsewhere."""
    _, steps = _run(workdir, tmp_path / "c", cuda, monkeypatch)
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.training.state import TrainerConfig, init_state, make_train_step
    from diffews_tpu_torch.utils.init import build_module

    cl = torch.channels_last
    unet = build_module(UNet2DConditionModel, UNetConfig.tiny(), seed=0, device=cuda).to(
        memory_format=cl)
    vae = build_module(AutoencoderKL, VAEConfig.tiny(), seed=1, device=cuda).to(
        memory_format=cl).requires_grad_(False)
    cfg = TrainerConfig(compute_dtype=torch.float32)
    state = init_state(cfg, dict(unet.named_parameters()), device=cuda)
    rng = np.random.default_rng(0)
    batch = {"query": rng.integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8),
             "q_mask3": rng.integers(0, 2, (2, 2, 32, 32), dtype=np.uint8),
             "supports": rng.integers(0, 256, (2, 2, 2, 32, 32, 3), dtype=np.uint8),
             "s_mask3": rng.integers(0, 2, (2, 2, 2, 32, 32), dtype=np.uint8),
             "shot_mask": np.array([[[True, False], [True, True]]] * 2)}
    before = _counts()
    make_train_step(cfg, unet)(state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()},
                               torch.Generator(device=cuda).manual_seed(0), vae,
                               torch.zeros((1, 77, 32), device=cuda))
    bare = tuple(x - y for x, y in zip(_counts(), before))
    assert len(steps) == STEPS and all(s == bare for s in steps), (steps, bare)
    assert all(n > 0 for n in bare), bare
