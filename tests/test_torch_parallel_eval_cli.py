"""Port parity of the multi-device eval CLI: `diffews_tpu_torch.cli.evaluate`
as 2 gloo ranks on the CPU (`helpers/torch_ranks.py`, `helpers/cli_ranks.py`,
as `torchrun --nproc_per_node 2` launches it) against the JAX CLI run
in-process on 2 of the conftest's virtual CPU devices, with the same flags:
`--num_data_shards 2` (the batch of 2 split over "data") and
`--num_shot_shards 2` (2 shots split over "shots").  Held: every rank's
(mIoU, FB-IoU) within 1e-9 of the JAX CLI's, as
`test_torch_evaluate_cli.py` holds the one-device CLI.
"""

import json

import pytest

from diffews_tpu.cli import evaluate as JE
from helpers.torch_ranks import run_ranks
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_evaluate_cli import TOL, _argv, workdir  # noqa: F401


@pytest.mark.parametrize("extra", [["--bsz", "2", "--num_data_shards", "2"],
                                   ["--nshot", "2", "--num_shot_shards", "2"]],
                         ids=["data2", "shots2"])
def test_two_rank_cli_equals_jax(workdir, tmp_path, extra):
    argv = _argv(workdir, episodes=4, logs=f"logs_{extra[-1]}_{extra[0][2:]}") + extra
    want = JE.main(argv)
    run_ranks(["tests/helpers/cli_ranks.py", "eval", str(tmp_path), "--", *argv,
               "--device", "cpu"], 2, timeout=240)
    for r in range(2):
        got = json.load(open(tmp_path / f"rank{r}.json"))
        assert abs(got["miou"] - want[0]) <= TOL and abs(got["fb_iou"] - want[1]) <= TOL, \
            (r, got, want)
    assert want[0] > 0
