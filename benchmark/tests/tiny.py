"""Tiny versions of the benchmark's configurations and traffic for CPU
tests: the port's `tiny()` presets (same topology family as SD-2.1),
32px images, float32 compute, batches of 2."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _plain(c) -> dict:
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(c).items()}


def config(name: str = "sd21-bf16", **over) -> dict:
    from diffews_tpu_torch.configs import CLIPTextConfig, UNetConfig, VAEConfig

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(unet=_plain(UNetConfig.tiny()), vae=_plain(VAEConfig.tiny()),
               text=_plain(CLIPTextConfig.tiny()), resolution=32, compute_dtype="float32")
    cfg.update(over)
    return cfg


def traffic(name: str = "episode-1shot-b8", **over) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update(batch=2, pool=t.get("compare_steps", 1) + 1)
    t.update(over)
    return t


def cell(workload: str = "sd21.episode-1shot-b8"):
    """The real cell, with its configuration and traffic made tiny."""
    from benchmark import core

    c = core.load_cell(ROOT, workload)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in spec["workloads"] if w["name"] == workload)
    file = next(x["file"] for x in spec["configs"] if x["name"] == entry["config"])
    c.config = config(Path(file).stem)
    c.traffic = traffic(entry["traffic"])
    return c


CPU = torch.device("cpu")
