"""Run a script as N torch ranks over gloo on the CPU, as `torchrun` would.

Each rank is a subprocess with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK, MASTER_ADDR, MASTER_PORT on a
free port), one torch thread and no JAX.  Each rank's `communicate` has
its own timeout, so a rendezvous that hangs fails the one test that
started it: the ranks are killed and the test fails with their output.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, n: int, *, nodes: int = 1, timeout: float = 60.0,
              env: dict | None = None) -> list:
    """Start `[sys.executable, *argv]` as `n` ranks on `nodes` nodes of n /
    nodes ranks each; return each rank's output.  Fails (AssertionError)
    when a rank exits non-zero or outlives `timeout` seconds."""
    port = free_port()
    per = n // nodes
    procs = []
    for r in range(n):
        e = dict(os.environ if env is None else env)
        for k in ("JAX_PLATFORMS", "XLA_FLAGS"):
            e.pop(k, None)
        e.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r % per),
                 LOCAL_WORLD_SIZE=str(per), GROUP_RANK=str(r // per),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
        procs.append(subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=e, text=True, cwd=ROOT))
    outs, hung = [], None
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            hung = r
            break
    if hung is not None:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-2000:] for p in procs]
        raise AssertionError(f"rank {hung} did not finish in {timeout} s:\n" + "\n".join(
            f"--- rank {r} ---\n{t}" for r, t in enumerate(tails)))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n{outs[r][-4000:]}"
                              for r in bad)
    return outs
