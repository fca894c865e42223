"""Each metric reader on a synthetic profiler event list and window, with
the numbers worked out by hand."""

import json

import pytest

from benchmark import core, trace, work
from benchmark.reference.model import Work
from benchmark.tests import tiny


def _events():
    """Two steps on one stream.  Step 1 at host 0–100 µs queues a VAE op
    (flash 10 µs, conv 30 µs) and a UNet op (flash 20 µs, GroupNorm 8+2
    µs); step 2 at 100–200 µs queues the same.  Device ops run at 10–50,
    60–90 (step 1) and 110–150, 160–190 (step 2); idle 50–60, 90–110 and
    150–160 inside the window 10–200."""
    ev = []
    for k in range(2):
        o = 100.0 * k
        ev += [dict(name="bench.step", device_type="cpu", start=o, end=o + 100, kernels=[]),
               dict(name="bench.enqueue", device_type="cpu", start=o + 1, end=o + 40, kernels=[]),
               dict(name="bench.vae", device_type="cpu", start=o + 2, end=o + 10, kernels=[]),
               dict(name="aten::conv", device_type="cpu", start=o + 3, end=o + 5,
                    kernels=[("flash_fwd_kernel<64>", 10.0), ("cudnn_fprop", 30.0)]),
               dict(name="bench.unet", device_type="cpu", start=o + 11, end=o + 20, kernels=[]),
               dict(name="diffews::flash", device_type="cpu", start=o + 12, end=o + 14,
                    kernels=[("flash_fwd_kernel<64>", 20.0), ("gn_stats_partial", 8.0),
                             ("gn_apply", 2.0)]),
               dict(name="bench.result", device_type="cpu", start=o + 41, end=o + 99, kernels=[]),
               dict(name="aten::copy_", device_type="cpu", start=o + 45, end=o + 98, kernels=[]),
               dict(name="cudnn_fprop", device_type="cuda", start=o + 10, end=o + 50),
               dict(name="flash_fwd_kernel<64>", device_type="cuda", start=o + 60, end=o + 90),
               dict(name="bench.vae", device_type="cuda", start=o + 10, end=o + 50)]
    return ev


def _run(items_per_batch=8, rate=16.0, traced=True):
    cell = tiny.cell("sd21.episode-1shot-b8")
    done = [core.Done(i, 0.0, 0.1 * (i + 1), 0.002 * (i + 1)) for i in range(10)]
    w = core.Window(5.0, items_per_batch, done, 11, rate)
    wk = Work(elt=2, flops=989e12 * 0.05, attention=[(8, 5, 4096, 8192, 64)],
              gn_silu=[8 * 64 * 64 * 320], int8_conv=[(8, 64, 64, 512, 512, 64, 64)])
    t = trace.reduce_events(_events(), 2) if traced else None
    return core.Run(cell, 12.5, w, wk, t)


def test_trace_reduction():
    t = _run().trace
    assert t.window == (10.0, 200.0)
    assert t.busy_s == pytest.approx(140e-6)
    assert t.range_s_per_step("bench.vae") == pytest.approx(40e-6)
    assert t.range_s_per_step("bench.unet") == pytest.approx(30e-6)
    by = t.class_s_per_step()
    assert by["flash_attention_fwd"] == pytest.approx(30e-6)
    assert by["gn_stats"] + by["gn_apply"] == pytest.approx(10e-6)
    assert t.top_ops() == [["cudnn_fprop", pytest.approx(80e-6)], ["flash_fwd_kernel<64>", pytest.approx(60e-6)]]
    # every idle gap falls while the host waits inside `result`'s copy
    assert t.top_gaps() == [["bench.result/aten::copy_", pytest.approx(50e-6)]]


def _read(name, run):
    return core.read_metric(run, name)


def test_host_clock_readers():
    run = _run()
    assert _read("episodes_per_s", run) == 16.0
    assert _read("setup_s", run) == 12.5
    lat = [0.1 * (i + 1) for i in range(10)]
    import numpy as np
    assert _read("episode_batch_p90_ms", run) == pytest.approx(np.percentile(lat, 90) * 1e3)
    assert _read("enqueue_ms.episode", run) == pytest.approx(11.0)
    # 0.05 s of bf16 work a batch at 2 batches a second: 10% of the peak
    assert _read("mfu.episode", run) == pytest.approx(10.0)


def test_trace_readers():
    run = _run()
    assert _read("vae_device_ms.episode", run) == pytest.approx(0.040)
    assert _read("unet_device_ms.episode", run) == pytest.approx(0.030)
    assert _read("device_idle.episode", run) == pytest.approx(100 * 50 / 190)
    site = (8, 5, 4096, 8192, 64)
    assert _read("attention_roofline.episode", run) == pytest.approx(
        100 * work.attention_bound_s(site, 2) / 30e-6)
    assert _read("groupnorm_roofline.episode", run) == pytest.approx(
        100 * work.gn_silu_bound_s(8 * 64 * 64 * 320, 2) / 10e-6)


def test_readers_return_nothing_without_their_source():
    """No trace, or no kernel of the class: the metric is left out, never 0."""
    untraced = _run(traced=False)
    for name in ("vae_device_ms.episode", "attention_roofline.episode", "device_idle.episode",
                 "groupnorm_roofline.episode"):
        assert _read(name, untraced) is None
    assert _read("conv_int8_roofline.episode", _run()) is None


def test_every_metric_has_a_reader():
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
