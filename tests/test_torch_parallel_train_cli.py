"""Port parity of the multi-device train CLI: `diffews_tpu_torch.cli.train`
with `--num_data_shards 2`, data-parallel and with `--fsdp`, as 2 gloo
ranks on the CPU (`helpers/torch_ranks.py`, `helpers/cli_ranks.py`, as
`torchrun --nproc_per_node 2` launches it) against the JAX CLI with the
same flags run in-process on 2 of the conftest's virtual CPU devices; both
with their default bf16 first moments, the port on the JAX run's noise.
The ranks sample their node's batch alike and each keeps its row, so the
two ranks run JAX's one-process 2-device stream.  Under `--fsdp` the rank
script lowers the sharding threshold to 16 elements, so that the tiny
UNet's leaves are split.

Held: rank 0's losses within rtol 1e-5 of the JAX CLI's and its final
`unet/` under `test_torch_train_cli.py`'s bf16-moment rule; rank 1 logs
and writes nothing; each step's checkpoint is written once.
"""

import json

import pytest
import torch

from diffews_tpu.cli import train as JT
from helpers.torch_ranks import run_ranks
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_cli import (GAS, LR, NSHOT, PX, STEPS, B, _common, _jax_noise,  # noqa: F401
                                  check_losses_and_final_unet, workdir)

N_IMG = 2 * B + 2 * B * NSHOT  # query, query mask, supports, support masks


@pytest.fixture(scope="module")
def jax_run(workdir, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_dp")
    JT.main(_common(workdir, root / "out", "--learning_rate", str(LR),
                    "--num_data_shards", "2", "--metrics_jsonl", str(root / "jax.jsonl")))
    lh = PX // 2  # the tiny VAE downsamples once
    noise = [_jax_noise(0, s, (GAS, N_IMG, lh, lh, 4)) for s in range(STEPS)]
    torch.save(noise, root / "noise.pt")
    return root, [json.loads(line) for line in open(root / "jax.jsonl")]


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_two_rank_cli_matches_jax(workdir, jax_run, tmp_path, mode):
    root, jlog = jax_run
    out = tmp_path / "out"
    argv = _common(workdir, out, "--learning_rate", str(LR), "--device", "cpu",
                   "--num_data_shards", "2", "--checkpointing_steps", "1",
                   *(["--fsdp"] if mode == "fsdp" else []))
    run_ranks(["tests/helpers/cli_ranks.py", "train", str(tmp_path), str(root / "noise.pt"),
               "--", *argv], 2, timeout=240)
    r0, r1 = (json.load(open(tmp_path / f"rank{r}.json")) for r in range(2))
    assert r0["global_step"] == r1["global_step"] == STEPS
    assert r1["log"] == [] and r1["saves"] == [] and r0["saves"] == [1, 2, 3, 4]
    assert [r["step"] for r in r0["log"]] == [r["step"] for r in jlog] == [1, 2, 3, 4]
    check_losses_and_final_unet(out, root / "out", jlog, {"log": r0["log"]},
                                exact=2 ** -8 * LR * STEPS)
