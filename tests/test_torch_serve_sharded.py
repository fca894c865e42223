"""Port parity of the multi-device daemon: `diffews_tpu_torch.cli.serve`
with `--num_data_shards 2` and with `--num_shot_shards 2`, each as 2 gloo
ranks on the CPU started as `torchrun` starts them
(`helpers/serve_ranks.py`), against the JAX daemon's `ModelServer` with the
same flags over the same mesh of the virtual CPU devices, on the same
JAX-saved tiny checkpoint.

Held, over HTTP, under `tests/test_torch_serve.py`'s episode contract
(segs within 1 uint8 count on < 1% of pixels, masks differing only where
the seg does):

  - data mesh (bsz 2, 2 shots, a 20 ms batch window): a one-off episode, a
    support cache with a 2-query request (the dispatch path) and two
    concurrent single queries (the micro-batcher's coalesced call), the
    drop and its 404; healthz's `mesh` equals JAX's ("data=2xmodel=1");
  - shot mesh (2 shots over 2 ranks): a one-off 2-shot episode; healthz
    "shots=2"; `/v1/supports` answers JAX's 400;
  - SIGTERM, sent to every rank as `torchrun` forwards it: rank 0 drains
    and stops the followers, and every rank exits 0;
  - a follower killed: rank 0's next request answers 503 and the daemon
    exits non-zero.
"""

import os
import signal
import threading

import numpy as np
import pytest

from diffews_tpu.cli import serve as JS
from helpers.jax_checkpoint import write_jax_checkpoint
from helpers.serve_ranks import serving_url, start_ranks
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serve import S, _b64_png, _call, _episode_contract, _mask, _png, _rgb

BASE = ["--bsz", "2", "--nshot", "2", "--img-size", str(S), "--max_caches", "2"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_jax_checkpoint(str(tmp_path_factory.mktemp("sharded_serve") / "ckpt"))


def _daemon(ckpt, tmp, flags):
    """The port daemon's 2 ranks (and rank 0's URL) and the JAX daemon's
    `ModelServer` with the same flags."""
    procs = start_ranks(["--checkpoint", ckpt, "--device", "cpu", "--port", "0", *BASE,
                         *flags], 2, str(tmp))
    try:
        url = serving_url(procs, str(tmp))
    except BaseException:
        _kill(procs)
        raise
    jms = JS.make_server(JS.build_parser().parse_args(["--checkpoint", ckpt, *BASE, *flags]))
    return procs, url, jms


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _stop_all(procs, tmp):
    """SIGTERM to every rank, as torchrun forwards it; each exits 0."""
    for p in procs:
        p.send_signal(signal.SIGTERM)
    try:
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        _kill(procs)
    logs = [open(os.path.join(tmp, f"rank{r}.log")).read() for r in range(len(procs))]
    assert codes == [0, 0], (codes, logs)
    assert "drained and stopped" in logs[0] and "rank 1 stopped" in logs[1], logs
    return logs


SUP = {"images": [_b64_png(_rgb(4))], "masks": [_b64_png(_mask(5))]}
ONE_OFF = {"query": [_b64_png(_rgb(1)), _b64_png(_rgb(2, h=30, w=30))],
           "supports": [_b64_png(_rgb(3)), _b64_png(_rgb(8))],
           "masks": [_b64_png(_mask(9)), _b64_png(_mask(10))], "return_seg": True}


def test_data_mesh_daemon_matches_jax(ckpt, tmp_path):
    procs, url, jms = _daemon(ckpt, tmp_path, ["--num_data_shards", "2",
                                               "--batch_window_ms", "20"])
    try:
        st, health = _call(url, "GET", "/healthz")
        assert st == 200 and health["mesh"] == jms.healthz()["mesh"] == "data=2xmodel=1"
        st, got = _call(url, "POST", "/v1/segment", ONE_OFF)
        assert st == 200, got
        _episode_contract(got, jms.segment(dict(ONE_OFF)))

        st, body = _call(url, "POST", "/v1/supports", SUP)
        assert st == 200 and body["n_shots"] == 1
        jid = jms.add_supports(dict(SUP))["cache_id"]
        two = {"query": [_b64_png(_rgb(6)), _b64_png(_rgb(7, h=30, w=30))],
               "return_seg": True}
        st, got = _call(url, "POST", "/v1/segment", {**two, "cache_id": body["cache_id"]})
        assert st == 200, got
        _episode_contract(got, jms.segment({**two, "cache_id": jid}))

        # two single queries at once: one coalesced device call
        singles = [{"query": _b64_png(_rgb(s)), "return_seg": True} for s in (11, 12)]
        out = [None, None]

        def ask(i):
            out[i] = _call(url, "POST", "/v1/segment",
                           {**singles[i], "cache_id": body["cache_id"]})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for i in range(2):
            assert out[i] and out[i][0] == 200, out[i]
            _episode_contract(out[i][1], jms.segment({**singles[i], "cache_id": jid}))

        assert _call(url, "DELETE", f"/v1/supports/{body['cache_id']}")[0] == 200
        st, err = _call(url, "POST", "/v1/segment", {**two, "cache_id": body["cache_id"]})
        assert st == 404 and "unknown cache_id" in err["error"]
        st, stats = _call(url, "GET", "/v1/stats")
        assert stats["device_calls"] >= 4 and stats["queries"] == 6
    except BaseException:
        _kill(procs)
        raise
    _stop_all(procs, tmp_path)


def test_shot_mesh_daemon_matches_jax_and_a_dead_follower_stops_it(ckpt, tmp_path):
    procs, url, jms = _daemon(ckpt, tmp_path, ["--num_shot_shards", "2"])
    try:
        st, health = _call(url, "GET", "/healthz")
        assert st == 200 and health["mesh"] == jms.healthz()["mesh"] == "shots=2"
        st, got = _call(url, "POST", "/v1/segment", ONE_OFF)
        assert st == 200, got
        _episode_contract(got, jms.segment(dict(ONE_OFF)))
        st, err = _call(url, "POST", "/v1/supports", SUP)
        with pytest.raises(JS.ServeError) as want:
            jms.add_supports(dict(SUP))
        assert st == want.value.status == 400 and err["error"] == str(want.value)

        # a follower dies: the next request fails loudly, and so does rank 0
        procs[1].kill()
        procs[1].wait()
        st, err = _call(url, "POST", "/v1/segment", ONE_OFF)
        assert st == 503 and "follower rank failed" in err["error"], (st, err)
        assert procs[0].wait(timeout=60) != 0
        log = open(tmp_path / "rank0.log").read()
        assert "a follower rank failed" in log, log
    finally:
        _kill(procs)


def test_sigterm_drains_every_rank(ckpt, tmp_path):
    """A one-off request, then SIGTERM to both ranks: all exit 0."""
    procs = start_ranks(["--checkpoint", ckpt, "--device", "cpu", "--port", "0", *BASE,
                         "--num_data_shards", "2", "--warm_start"], 2, str(tmp_path))
    try:
        url = serving_url(procs, str(tmp_path))
        st, got = _call(url, "POST", "/v1/segment", ONE_OFF)
        assert st == 200 and len(got["masks"]) == 2
        assert np.asarray(_png(got["masks"][1])).shape == (30, 30)
    except BaseException:
        _kill(procs)
        raise
    logs = _stop_all(procs, tmp_path)
    assert "warm-start done" in logs[0]
