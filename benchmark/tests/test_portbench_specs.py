"""`BENCHMARK.json` and the files it names: every workload and
configuration loads and names only known metrics, and a cell, a
configuration and a per-layer metric are added by new files and entries
alone."""

import json
import re
import shutil

import pytest

from benchmark import core, kinds
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


def test_spec_is_well_formed():
    spec = _spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert spec["command"] == ["python3", "benchmark/run.py"] and spec["paths"] == ["benchmark"]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [w["name"] for w in spec["workloads"]]
    assert len(set(names)) == len(names)
    for w in spec["workloads"]:
        cell = core.load_cell(tiny.ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            # the metric a per-layer metric moves is reported wherever it is
            assert m["moves"] in reported, (w["name"], m["name"])
        known = set(kinds.load(cell.traffic["mode"]).NUMBERS)
        assert cell.limits and set(cell.limits) <= known
    for c in spec["configs"]:
        cfg = json.loads((tiny.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in spec["workloads"])


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the checkout gains a configuration, a traffic mix, a cell
    and a per-layer metric, each a new file plus an entry in
    `BENCHMARK.json`; one tiny run on the CPU reports them."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, root / "benchmark")
    spec = _spec()
    (root / "benchmark" / "configs" / "sd21-tiny.json").write_text(json.dumps(tiny.config()))
    traffic = json.loads((tiny.BENCH / "traffic" / "episode-1shot-b8.json").read_text())
    traffic.update(shots=2, batch=2, pool=2)
    (root / "benchmark" / "traffic" / "episode-2shot-b2.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "workloads" / "tiny.episode-2shot-b2.json").write_text(
        json.dumps({"limits": {"seg_mae": 1.0, "mask_mismatch": 0.01}}))
    (root / "benchmark" / "metrics" / "batches_done.episode.py").write_text(
        "def read(run):\n    return len(run.window.done)\n")
    spec["configs"].append({"name": "sd21-tiny", "source": "https://arxiv.org/abs/2410.02369",
                            "file": "benchmark/configs/sd21-tiny.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "tiny.episode-2shot-b2", "config": "sd21-tiny",
                              "traffic": "episode-2shot-b2", "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] in ("episodes_per_s", "episode_batch_p90_ms"):
            m["workloads"].append("tiny.episode-2shot-b2")
    spec["per_layer"].append({"name": "batches_done.episode", "unit": "batches", "better": "higher",
                              "source": "host_clock", "layer": "pipeline entry",
                              "moves": "episodes_per_s", "workloads": ["tiny.episode-2shot-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.load_cell(root, "tiny.episode-2shot-b2")
    assert cell.traffic["shots"] == 2
    line, _ = core.run_cell(cell, 2 ** 35 + 1, 1.0, False, "cpu")
    assert line["correct"] and {"episodes_per_s", "episode_batch_p90_ms", "setup_s"} <= set(
        line["metrics"])
    line, _ = core.run_cell(cell, 2 ** 35 + 1, 1.0, True, "cpu")
    assert line["metrics"]["batches_done.episode"]["value"] > 0


def test_an_sdxl_shaped_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the checkout gains a tiny SDXL-shaped configuration (per-
    level depth, "text_time" added conditioning, a second text tower), a
    traffic mix and a cell as new files and entries.  The cell loads, its
    weights draw, its work counts and the reference runs its episode with
    no edit to the harness; the first call to fail is the one into the
    port, which refuses the configuration itself."""
    from benchmark import generator, weights, work
    from benchmark.reference import episode as ref_lib
    from benchmark.tests import sdxl

    root = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, root / "benchmark")
    spec = _spec()
    (root / "benchmark" / "configs" / "sdxl-tiny.json").write_text(json.dumps(sdxl.config()))
    traffic = json.loads((tiny.BENCH / "traffic" / "episode-1shot-b8.json").read_text())
    traffic.update(batch=2, pool=2)
    (root / "benchmark" / "traffic" / "episode-1shot-b2.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "workloads" / "sdxl-tiny.episode-1shot-b2.json").write_text(
        json.dumps({"limits": {"seg_mae": 1.0, "mask_threshold_mismatch": 0.0}}))
    spec["configs"].append({"name": "sdxl-tiny", "source": "https://arxiv.org/abs/2307.01952",
                            "file": "benchmark/configs/sdxl-tiny.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "sdxl-tiny.episode-1shot-b2", "config": "sdxl-tiny",
                              "traffic": "episode-1shot-b2", "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sd21.episode-1shot-b8" in m.get("workloads", []):
            m["workloads"].append("sdxl-tiny.episode-1shot-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    seed = 2 ** 35 + 9
    cell = core.load_cell(root, "sdxl-tiny.episode-1shot-b2")
    cfg = cell.config
    assert cfg["unet"]["addition_embed_type"] == "text_time" and "text_2" in cfg
    wts = weights.make(cfg, seed, "cpu")
    assert list(wts) == ["unet", "vae", "text", "text_2"]
    w = work.batch_work(cfg, cell.traffic, root)
    assert w.flops > 0 and len(w.attention) == 2 * 18 + 2     # 18 sites, 2 streams; VAE
    inputs = generator.make(cell.traffic, seed, cfg["resolution"], "cpu", root=root)
    ref = ref_lib.Reference(cfg, weights.as_float32(wts), "cpu")
    seg_of = kinds.load(cell.traffic["mode"], root).reference(
        ref, cell.traffic, inputs, lambda a: generator.as_tensor(a, tiny.CPU))
    assert seg_of(inputs["batches"][0]).shape == (2, 32, 32, 3)
    with pytest.raises(TypeError, match=r"UNetConfig.*addition_embed_type"):
        core.build_program(cfg, wts, tiny.CPU)
    with pytest.raises(TypeError, match=r"UNetConfig.*addition_embed_type"):
        core.run_cell(cell, seed, 1.0, False, "cpu")


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 62 + 9])
def test_inputs_follow_the_seed_and_keep_their_sizes(seed):
    """The same seed gives the same inputs; every seed the same sizes."""
    from benchmark import generator

    t = tiny.traffic()
    a, b = generator.make(t, seed, 32, "cpu"), generator.make(t, seed, 32, "cpu")
    other = generator.make(t, seed + 1, 32, "cpu")
    for x, y, z in zip(a["batches"], b["batches"], other["batches"]):
        for k in x:
            assert (x[k] == y[k]).all() and x[k].shape == z[k].shape
    m = a["batches"][0]["masks"]
    assert 0 < m.mean() < 1


SYNC_KIND = '''"""Episodes one at a time through the synchronous `predict`."""
from benchmark.kinds.episode import NUMBERS, count, draw, reference  # noqa: F401
from benchmark import core


class _Done:
    def __init__(self, out):
        self.out = out

    def result(self):
        return self.out


def submitter(pipe, traffic, inputs):
    pool, kw = inputs["batches"], core.serve_options(traffic)

    def submit(i):
        b = pool[i % len(pool)]
        return _Done(pipe.predict(b["query"], b["supports"], b["masks"],
                                  r_threshold=kw["r_threshold"]))
    return submit, None


def run(cell, seed, seconds, traced, dev, t_start, program=None):
    return core.serve(cell, seed, seconds, traced, dev, t_start, program, submitter, reference)
'''


def test_a_traffic_kind_is_added_by_a_file(tmp_path):
    """A copy of the checkout gains a traffic kind (`kinds/<mode>.py`), a
    traffic mix of that kind and a cell; one tiny run on the CPU drives it
    and checks it."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, root / "benchmark")
    (root / "benchmark" / "kinds" / "episode_sync.py").write_text(SYNC_KIND)
    traffic = json.loads((tiny.BENCH / "traffic" / "episode-1shot-b8.json").read_text())
    traffic.update(mode="episode_sync", dispatch_ahead=1)
    (root / "benchmark" / "traffic" / "episode-sync-b8.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "workloads" / "sd21.episode-sync-b8.json").write_text(
        json.dumps({"limits": {"seg_mae": 1.0, "mask_mismatch": 0.01}}))
    spec = _spec()
    spec["workloads"].append({"name": "sd21.episode-sync-b8", "config": "sd21-bf16",
                              "traffic": "episode-sync-b8", "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] in ("episodes_per_s", "episode_batch_p90_ms"):
            m["workloads"].append("sd21.episode-sync-b8")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.load_cell(root, "sd21.episode-sync-b8")
    cell.config = tiny.config()
    cell.traffic.update(batch=2, pool=2)
    kind = kinds.load("episode_sync", root)
    assert kind is not kinds.load("episode") and kind.NUMBERS == kinds.load("episode").NUMBERS
    line, _ = core.run_cell(cell, 2 ** 35 + 3, 1.0, False, "cpu")
    assert line["correct"] and {"episodes_per_s", "setup_s"} <= set(line["metrics"])
    with pytest.raises(ValueError, match="unknown traffic mode"):
        kinds.load("no_such_kind", root)
