"""The eval harness on the card: `diffews_tpu_torch.cli.evaluate.main` with
the kernels against the same run on the CPU (plain versions).

A tiny checkpoint written from the port's seeded modules and a synthetic
COCO tree; f32 with TF32 off; 8 episodes at 32px under `vae_impl` "xla"
and "auto" (the fused encode on the card, "xla" on the CPU).  Held: equal
(mIoU, FB-IoU), every episode's uint8 prediction within 1 count on < 1% of
pixels and < 1% of mask pixels flipped, and the flash and GroupNorm kernels
launched; uploads return while the device is held busy (they do not wait
for it).  Marked `gpu`: each test skips without a CUDA device.  This
file imports no JAX (the GPU host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_evaluate_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch.cli import evaluate as TE
from diffews_tpu_torch.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch.ops import fused_resnet, groupnorm
from diffews_tpu_torch.ops.flash_attention import flash_attention
from helpers import synthetic_data as syn
from helpers.port_checkpoint import write_checkpoint

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_gpu")
    write_checkpoint(str(root / "ckpt"), UNetConfig.tiny(), VAEConfig.tiny(),
                     CLIPTextConfig.tiny(), SchedulerConfig.diffews(), seed=0)
    syn.make_coco(str(root / "data"))
    return root


def _run(workdir, device, vae_impl, monkeypatch):
    """The CLI's metrics and every episode's `SegOutput`, in order."""
    outs = []
    orig = TP.PendingSeg.result

    def keep(self, need_seg=True):
        out = orig(self, need_seg)
        outs.append(out)
        return out

    monkeypatch.setattr(TP.PendingSeg, "result", keep)
    metrics = TE.main([
        "--checkpoint", str(workdir / "ckpt"), "--datapath", str(workdir / "data"),
        "--benchmark", "coco", "--fold", "0", "--nshot", "1", "--img-size", "32",
        "--threshold", "0", "--r_threshold", "0.25", "--max_episodes", "8",
        "--log-root", str(workdir / f"logs_{device}"), "--vae_impl", vae_impl,
        "--device", device])
    monkeypatch.setattr(TP.PendingSeg, "result", orig)
    return metrics, outs


@pytest.mark.parametrize("vae_impl", ["xla", "auto"])
def test_harness_on_the_card_equals_cpu(cuda, workdir, vae_impl, monkeypatch):
    want, cpu = _run(workdir, "cpu", vae_impl, monkeypatch)
    flash_attention.launches = 0
    groupnorm.gn_stats_kernel.launches = groupnorm.gn_apply_kernel.launches = 0
    fused_resnet.gn_silu_conv3x3.launches = 0
    got, gpu = _run(workdir, cuda, vae_impl, monkeypatch)
    assert flash_attention.launches > 0 and groupnorm.gn_apply_kernel.launches > 0
    assert (fused_resnet.gn_silu_conv3x3.launches > 0) == (vae_impl == "auto")
    assert len(gpu) == len(cpu) == 8
    for a, b in zip(gpu, cpu):
        d = np.abs(a.seg_colored.astype(np.int32) - b.seg_colored.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() < 0.01, (d.max(), (d != 0).mean())
        assert (a.mask != b.mask).mean() < 0.01
    assert abs(got[0] - want[0]) <= 1e-9 and abs(got[1] - want[1]) <= 1e-9, (got, want)


def test_uploads_do_not_wait_for_the_device(cuda):
    """Dispatch-ahead needs `PendingSeg.result()` to be the wait: with a spin
    kernel holding the device for about a second, the pipeline's upload and
    `to_device` return long before the device is free, and the values
    arrive."""
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.utils import to_device

    pipe = TP.DiffewsPipeline(random_pipeline_bundle(
        UNetConfig.tiny(), VAEConfig.tiny(), None, SchedulerConfig.diffews()), device=cuda)
    q = np.random.default_rng(0).integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)
    torch.cuda.synchronize()
    t0 = time.time()
    torch.cuda._sleep(10 ** 8)
    torch.cuda.synchronize()
    cycles = int(10 ** 8 / (time.time() - t0))
    for put in (pipe._put, lambda x: to_device(torch.from_numpy(x), torch.device(cuda))):
        torch.cuda._sleep(cycles)
        t0 = time.time()
        got = put(q)
        host = time.time() - t0
        torch.cuda.synchronize()
        total = time.time() - t0
        assert host < 0.5 and total > 0.8, (host, total)
        np.testing.assert_array_equal(got.cpu().numpy(), q)
