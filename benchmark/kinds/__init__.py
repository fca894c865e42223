"""Traffic kinds: how a cell's traffic reaches the program.

A traffic file's `mode` names its kind, the module
`benchmark/kinds/<mode>.py` of the checkout, so a new kind is a new file.
A kind gives:
  NUMBERS                       the names of the check's numbers;
  draw(d, traffic, latent)      its inputs, from the generator's draws `d`;
  count(s)                      the work of one batch (`work.Shapes` `s`);
  run(cell, seed, seconds, traced, dev, t_start, program)
                                one run: (result line, the check's numbers).
The closed-loop serving kinds (`episode`, `cached`) run through
`core.serve`, which also takes their `submitter` and `reference`.
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED: dict = {}


def load(mode: str, root=None):
    """The kind module `mode` of the checkout at `root` (this one if None)."""
    folder = HERE if root is None else Path(root).resolve() / "benchmark" / "kinds"
    path = folder / f"{mode}.py"
    if mode.startswith("_") or not path.is_file():
        raise ValueError(f"unknown traffic mode {mode!r}")
    if path not in _LOADED:
        if folder == HERE:
            _LOADED[path] = importlib.import_module(f"benchmark.kinds.{mode}")
        else:
            spec = importlib.util.spec_from_file_location(f"benchmark_kind_{mode}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _LOADED[path] = mod
    return _LOADED[path]
