"""One rank of a port CLI under `helpers.torch_ranks.run_ranks` (gloo on
the CPU, no JAX), as `torchrun -m diffews_tpu_torch.cli.<cli>` runs it.

    python tests/helpers/cli_ranks.py eval <out_dir> -- <evaluate argv>
    python tests/helpers/cli_ranks.py train <out_dir> <noise.pt> -- <train argv>

`eval` writes the rank's (mIoU, FB-IoU) to `<out_dir>/rank<r>.json`;
`train` feeds the CLI each step's global-batch posterior noise from
`<noise.pt>` (a list indexed by the step, drawn by the test from JAX's
key) through `cli.train.step_noise`, lowers the FSDP sharding threshold
to 16 elements (so that `--fsdp` splits a tiny UNet's leaves), and writes
the rank's report's steps, losses and saves.
"""

import json
import os
import sys

import torch

torch.set_num_threads(1)


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    sep = sys.argv.index("--")
    argv = sys.argv[sep + 1:]
    rank = int(os.environ["RANK"])
    if mode == "eval":
        from diffews_tpu_torch.cli import evaluate

        miou, fb = evaluate.main(argv)
        res = {"miou": miou, "fb_iou": fb}
    else:
        from diffews_tpu_torch.cli import train
        from diffews_tpu_torch.parallel import mesh

        noises = torch.load(sys.argv[3], weights_only=True)

        def step_noise(seed, step, shape):
            assert tuple(noises[step].shape) == tuple(shape), (noises[step].shape, shape)
            return noises[step].clone()

        train.step_noise = step_noise
        fsdp_init = mesh.init_state_fsdp
        mesh.init_state_fsdp = lambda *a, **kw: fsdp_init(*a, **kw, fsdp_min_elems=16)
        report = train.main(argv)
        res = {"log": report["log"], "global_step": report["global_step"],
               "saves": [s["step"] for s in report["saves"]]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
