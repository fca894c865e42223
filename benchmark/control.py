"""The readings that the check's limits are set from (not part of a run).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each of `--seeds`, a short run of the program at the cell's own size
and load, and every number of the check (the lower readings).  For each of
`--control-seeds`, the control in the program's place, compared alike (the
upper readings): the configuration's own lower-precision path where the
program has one (W8A8 for the bf16 configuration), else the reference
computed one precision below the configuration's (int4 sites for W8A8).
One JSON line per run on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import core, generator, kinds, weights  # noqa: E402
from benchmark.reference import episode as ref_lib  # noqa: E402


class _Done:
    def __init__(self, seg, mask):
        self.seg_colored, self.mask = seg, mask

    def result(self):
        return self


class ReferenceProgram:
    """The reference at a narrower quantization width, behind the
    pipeline's entry points (synchronous)."""

    def __init__(self, cfg, wts, device, bits):
        ref_lib.plain_float32()
        self.ref = ref_lib.Reference(cfg, weights.as_float32(wts), device, bits=bits)
        self.device = device

    def _t(self, a):
        return generator.as_tensor(a, self.device)

    def _out(self, seg, r_threshold):
        seg = seg.cpu().numpy()
        return _Done(seg, ref_lib.threshold_mask(seg, r_threshold))

    def predict_async(self, query, supports, masks, r_threshold, mask_on_device):
        return self._out(self.ref.episode(self._t(query), self._t(supports), self._t(masks)),
                         r_threshold)

    def precompute_supports(self, supports, masks):
        return self.ref.capture(self._t(supports), self._t(masks))

    def predict_cached_async(self, query, cache, r_threshold, mask_on_device):
        return self._out(self.ref.cached(self._t(query), cache), r_threshold)


def control_program(cell):
    """The cell's control, as a `program` for `core.run_cell`: the kind's
    own where it gives one."""
    kind = kinds.load(cell.traffic["mode"], cell.root)
    if hasattr(kind, "control_program"):
        return kind.control_program(cell)
    cfg = cell.config
    if cfg["vae_impl"] != "int8" and not cfg["unet_int8"]:
        return lambda c, wts, dev: core.build_program({**c, "vae_impl": "int8", "unet_int8": True},
                                                       wts, dev)
    return lambda c, wts, dev: ReferenceProgram(c, wts, dev, bits=4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="the kind's planted faults that need a run (training: half batch)")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    cell = core.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    runs = [("program", int(s), None) for s in args.seeds.split(",") if s]
    runs += [("control", int(s), control_program(cell))
             for s in args.control_seeds.split(",") if s]
    kind = kinds.load(cell.traffic["mode"], cell.root)
    for name, fault in getattr(kind, "FAULT_PROGRAMS", {}).items():
        runs += [(f"fault_{name}", int(s), fault) for s in args.fault_seeds.split(",") if s]
    for kind, seed, program in runs:
        t0 = time.perf_counter()
        # the reference in the program's place takes seconds a batch: give
        # its window room for the batches the check compares
        seconds = args.seconds if kind == "program" else max(args.seconds, 12.0)
        line, numbers = core.run_cell(cell, seed, seconds, False, "cuda", program=program)
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "metrics": line["metrics"], "correct": line["correct"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
