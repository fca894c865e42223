"""The serving daemon as N torch ranks over gloo on the CPU, as `torchrun
--nproc_per_node N -m diffews_tpu_torch.cli.serve ...` starts it, without
JAX.

    python tests/helpers/serve_ranks.py <serve argv>

is one rank (`diffews_tpu_torch.cli.serve.main` on one intra-op thread).
`start_ranks` starts N of them with torchrun's environment, each rank's
output to `<log_dir>/rank<r>.log`, and returns at once; `serving_url`
waits for rank 0's "serving on" line.
"""

import os
import subprocess
import sys
import time


def start_ranks(argv, n: int, log_dir: str) -> list:
    """Start the daemon's `n` ranks; returns their `Popen`s."""
    from helpers.torch_ranks import ROOT, free_port

    port, procs = free_port(), []
    for r in range(n):
        env = dict(os.environ)
        for k in ("JAX_PLATFORMS", "XLA_FLAGS"):
            env.pop(k, None)
        env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   GROUP_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
        with open(os.path.join(log_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests", "helpers", "serve_ranks.py"),
                 *argv], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    return procs


def serving_url(procs, log_dir: str, timeout: float = 60.0) -> str:
    """Rank 0's base URL once it serves; fails when a rank exits first or
    the wait outlasts `timeout`."""
    log = os.path.join(log_dir, "rank0.log")
    t0 = time.time()
    while time.time() - t0 < timeout:
        for line in open(log):
            if "serving on http://" in line:
                return line.split()[2]
        dead = [r for r, p in enumerate(procs) if p.poll() is not None]
        assert not dead, f"ranks {dead} exited:\n" + "".join(
            open(os.path.join(log_dir, f"rank{r}.log")).read()[-3000:] for r in dead)
        time.sleep(0.2)
    raise AssertionError(f"rank 0 does not serve after {timeout} s:\n{open(log).read()}")


if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)
    from diffews_tpu_torch.cli import serve

    serve.main(sys.argv[1:])
