"""The program-span reduction (`spans.py`) on hand-made profiler events,
with the numbers worked out by hand; and the trace reduction's readings
unchanged when program spans are interleaved into its events."""

import pytest

from benchmark import core, spans as spans_lib, trace
from benchmark.tests import test_portbench_readers as readers

cpu = lambda name, s, e, kernels=(): dict(name=name, device_type="cpu", start=s, end=e,
                                           kernels=list(kernels))
cuda = lambda name, s, e: dict(name=name, device_type="cuda", start=s, end=e)


def _train_events():
    """Two steps of 100 µs.  In each, at offset o: `diffews.train.step`
    o+1..o+90 holds latents 2..10 (a conv launching a 4 µs kernel, one
    launch call), forward 10..30 (an aten op at 12 launching 6 µs and one
    launch call; `diffews.unet.down0` 14..24 with a launch call and an 8 µs
    kernel attached to the span event itself), backward 30..70 (on a second
    thread, 35..60, `diffews.unet.resnet` 40..50 re-entered by the
    recompute, whose op launches 10 µs with two launch calls; an op in
    backward's self part at 62 launches 2 µs), optimizer 70..88 (three
    launch calls, an op launching 1+1+1 µs)."""
    ev = []
    for k in range(2):
        o = 100.0 * k
        ev += [cpu("bench.step", o, o + 100), cpu("bench.enqueue", o + 0.5, o + 95),
               cpu("diffews.train.step", o + 1, o + 90),
               cpu("diffews.train.latents", o + 2, o + 10),
               cpu("aten::conv2d", o + 3, o + 5, [("sm90_xmma_fprop", 4.0)]),
               cpu("cudaLaunchKernel", o + 4, o + 4.5),
               cpu("diffews.train.forward", o + 10, o + 30),
               cpu("aten::mm", o + 12, o + 13, [("nvjet_gemm", 6.0)]),
               cpu("cudaLaunchKernel", o + 12.5, o + 12.8),
               cpu("diffews.unet.down0", o + 14, o + 24, [("flash_fwd_kernel", 8.0)]),
               cpu("cuLaunchKernel", o + 15, o + 15.2),
               cpu("diffews.train.backward", o + 30, o + 70),
               cpu("diffews.unet.resnet", o + 40, o + 50),
               cpu("ConvolutionBackward0", o + 41, o + 49, [("conv_dgrad", 7.0),
                                                             ("conv_wgrad", 3.0)]),
               cpu("cudaLaunchKernel", o + 42, o + 42.5),
               cpu("cudaLaunchKernelExC", o + 45, o + 45.5),
               cpu("aten::zeros_like", o + 62, o + 63, [("vectorized_elementwise", 2.0)]),
               cpu("diffews.train.optimizer", o + 70, o + 88),
               cpu("aten::_foreach_mul_", o + 71, o + 80, [("elementwise_a", 1.0),
                                                            ("elementwise_b", 1.0),
                                                            ("reduce_kernel", 1.0)]),
               cpu("cudaLaunchKernel", o + 72, o + 72.1), cpu("cudaLaunchKernel", o + 73, o + 73.1),
               cpu("cudaLaunchKernel", o + 74, o + 74.1),
               cuda("sm90_xmma_fprop", o + 5, o + 9), cuda("nvjet_gemm", o + 13, o + 19),
               cuda("flash_fwd_kernel", o + 19, o + 27), cuda("conv_dgrad", o + 43, o + 50),
               cuda("conv_wgrad", o + 50, o + 53)]
    return ev


def test_span_table_by_hand():
    t = spans_lib.Spans(_train_events()).table(steps=2)
    step, fwd = t["diffews.train.step"], t["diffews.train.forward"]
    bwd = t["diffews.train.backward"]
    assert list(t)[0] == "diffews.train.step"  # sorted by host ms
    assert step["calls"] == fwd["calls"] == bwd["calls"] == 1
    assert step["host_ms"] == pytest.approx(89e-3)
    # the step's self part: 89 µs less latents 8, forward 20, backward 40, optimizer 18
    assert step["self_ms"] == pytest.approx(3e-3)
    assert fwd["host_ms"] == pytest.approx(20e-3)
    assert fwd["self_ms"] == pytest.approx(10e-3)
    assert t["diffews.unet.down0"]["self_ms"] == pytest.approx(10e-3)
    assert bwd["self_ms"] == pytest.approx(30e-3)
    # device: inclusive, and what the self part launched
    assert fwd["device_ms"] == pytest.approx(14e-3)
    assert fwd["self_device_ms"] == pytest.approx(6e-3)
    assert t["diffews.unet.down0"]["self_device_ms"] == pytest.approx(8e-3)
    assert bwd["device_ms"] == pytest.approx(12e-3)
    assert bwd["self_device_ms"] == pytest.approx(2e-3)
    assert t["diffews.unet.resnet"]["self_device_ms"] == pytest.approx(10e-3)
    assert t["diffews.train.optimizer"]["device_ms"] == pytest.approx(3e-3)
    assert step["device_ms"] == pytest.approx(4e-3 + 14e-3 + 12e-3 + 3e-3)
    assert step["self_device_ms"] == 0.0
    # launch calls, inclusive, on any thread
    assert step["launches"] == 8
    assert fwd["launches"] == 2 and t["diffews.unet.down0"]["launches"] == 1
    assert bwd["launches"] == 2 and t["diffews.train.optimizer"]["launches"] == 3
    assert t["diffews.unet.resnet"]["self_device_ms_by_class"] == {
        "conv_cudnn": pytest.approx(10e-3)}
    assert t["diffews.train.optimizer"]["self_device_ms_by_class"] == {
        "elementwise_other": pytest.approx(2e-3), "reductions": pytest.approx(1e-3)}


def test_top_kernels_by_launching_span():
    top = spans_lib.Spans(_train_events()).top_kernels(steps=2, k=2)
    assert top == [["flash_fwd_kernel", pytest.approx(8e-3),
                    {"diffews.train.forward/diffews.unet.down0": pytest.approx(8e-3)}],
                   ["conv_dgrad", pytest.approx(7e-3),
                    {"diffews.train.backward/diffews.unet.resnet": pytest.approx(7e-3)}]]


def test_innermost_span():
    s = spans_lib.Spans(_train_events())
    assert s.innermost(0.7) is None
    assert s.innermost(16) == "diffews.unet.down0"
    assert s.innermost(45) == "diffews.unet.resnet"
    assert s.innermost(55) == "diffews.train.backward"
    assert s.innermost(89.5) == "diffews.train.step"
    assert s.innermost(112) == "diffews.train.forward"


def _with_spans(events):
    """`readers._events()` with program spans around its host ops: a
    predict span over each enqueue, encode over the VAE range, unet over
    the UNet range and `diffews.pending.result` over each result; the VAE
    op's kernels attached to a span around it (as when a kernel is
    launched under a span with no op of its own open); and the copy the
    profiler puts on the device's timeline of each span that launched a
    kernel, over its kernels."""
    ev = []
    for e in map(dict, events):
        if e["name"] == "aten::conv":  # in the op's place: the same order of kernels
            kernels, e["kernels"] = e["kernels"], []
            ev.append(cpu("diffews.vae.encoder.down0", e["start"] - 0.2, e["end"] + 0.2, kernels))
        ev.append(e)
    for k in range(2):
        o = 100.0 * k
        ev += [cpu("diffews.pipeline.predict", o + 1.5, o + 39),
               cpu("diffews.pipeline.encode", o + 2.5, o + 9.5),
               cpu("diffews.pipeline.unet", o + 10.5, o + 19.5),
               cpu("diffews.pending.result", o + 42, o + 99),
               cuda("diffews.pipeline.predict", o + 10, o + 90),
               cuda("diffews.pipeline.encode", o + 10, o + 50)]
    return ev


def test_readers_unchanged_with_program_spans(monkeypatch):
    """With the spans' device-timeline copies left out: their device
    intervals cover the idle gaps between the kernels they launched."""
    plain = readers._run()
    assert trace.reduce_events(_with_spans(readers._events()), 2).busy_s > plain.trace.busy_s
    monkeypatch.setattr(readers, "_events",
                        lambda e=readers._events: spans_lib.without_device_spans(_with_spans(e())))
    spanned = readers._run()
    for name in ("vae_device_ms.episode", "unet_device_ms.episode", "device_idle.episode",
                 "attention_roofline.episode", "groupnorm_roofline.episode",
                 "enqueue_ms.episode", "episodes_per_s", "mfu.episode"):
        assert core.read_metric(spanned, name) == core.read_metric(plain, name), name
    assert spanned.trace.window == plain.trace.window
    assert spanned.trace.busy_s == plain.trace.busy_s
    assert spanned.trace.launched == plain.trace.launched
    assert spanned.trace.top_ops() == plain.trace.top_ops()


def test_idle_gaps_name_the_innermost_span():
    """Every gap falls while the host waits in `result`'s copy: inside
    `diffews.pending.result` where that span is open, as the trace
    reduction labels it where none is."""
    ev = spans_lib.without_device_spans(_with_spans(readers._events()))
    tr = trace.reduce_events(ev, 2)
    gaps = spans_lib.idle_gaps(ev, tr, spans_lib.Spans(ev))
    assert gaps == [["bench.result/diffews.pending.result/aten::copy_", pytest.approx(50e-6)]]
    plain = readers._events()
    assert spans_lib.idle_gaps(plain, trace.reduce_events(plain, 2),
                               spans_lib.Spans(plain)) == tr.top_gaps()
