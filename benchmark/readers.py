"""Arithmetic the metric readers share: each reader in `metrics/` is one
call into here, so a reader names what it reads and nothing more."""

from __future__ import annotations

import numpy as np

from benchmark import work as work_lib


def items_per_s(run) -> float:
    """Items (episodes, queries) whose results reached the host inside the
    window, over the window."""
    return run.window.rate_items_per_s


def latency_percentile_ms(run, q: float):
    lat = run.window.latencies_s
    return None if not lat else float(np.percentile(lat, q)) * 1e3


def enqueue_ms(run):
    """Host ms of one queueing call (a batch's `predict*_async`, an
    optimizer step), mean over the window."""
    enq = [d.enqueue_s for d in run.window.done]
    return None if not enq else float(np.mean(enq)) * 1e3


def range_device_ms(run, range_name: str):
    """Device ms per batch of the ops launched inside `range_name`."""
    if run.trace is None:
        return None
    s = run.trace.range_s_per_step(range_name)
    return s * 1e3 if s > 0 else None


def roofline_pct(run, bound_s: float, classes):
    """Least time of the batch's sites over the device time of `classes`
    per batch, in %; nothing when the trace shows none of them."""
    if run.trace is None or bound_s <= 0:
        return None
    by = run.trace.class_s_per_step()
    t = sum(by.get(c, 0.0) for c in classes)
    return 100.0 * bound_s / t if t > 0 else None


def attention_roofline(run):
    w = run.work
    return roofline_pct(run, sum(work_lib.attention_bound_s(s, w.elt) for s in w.attention),
                        ("flash_attention_fwd",))


def attention_bwd_roofline(run):
    w = run.work
    return roofline_pct(run, sum(work_lib.attention_bwd_bound_s(s, w.elt) for s in w.attention_bwd),
                        ("flash_attention_bwd",))


def groupnorm_roofline(run):
    w = run.work
    return roofline_pct(run, sum(work_lib.gn_silu_bound_s(e, w.elt) for e in w.gn_silu),
                        ("gn_stats", "gn_apply", "statistics_partial_sums"))


def conv_int8_roofline(run):
    w = run.work
    return roofline_pct(run, sum(work_lib.int8_conv_bound_s(s, w.elt) for s in w.int8_conv),
                        ("conv2d_int8",))


def device_idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run):
    """The batch's products at the card's peaks, times the window's batch
    rate: the share of the peak the whole step reaches."""
    batches_per_s = run.window.rate_items_per_s / run.window.items_per_batch
    return 100.0 * work_lib.step_bound_s(run.work) * batches_per_s or None
