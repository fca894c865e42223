"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration with weights made from the seed, warms up,
drives the cell's traffic through `diffews_tpu_torch` for `--seconds`,
checks a sample of what the window produced against the plain float32
reference, and prints one JSON line last on standard output.  Exits
non-zero without a result when there is no CUDA device or too few, or when
JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch writes stays inside the checkout, at a
# fixed path, so a second run in the same checkout builds nothing
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    cell = core.load_cell(ROOT, args.workload)
    print(f"phase imports: {time.perf_counter() - T_START:.2f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this host has {n}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.cuda.init()
    print(f"phase cuda init: {time.perf_counter() - T_START:.2f} s", file=sys.stderr)
    line, numbers = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    print("readings: " + json.dumps(numbers), file=sys.stderr)
    found = core.forbidden_modules()
    if found:
        print("loaded in the benchmark's process: " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in line["checked"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
