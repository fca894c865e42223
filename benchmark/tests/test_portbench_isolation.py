"""Nothing the benchmark runs loads JAX or the JAX package, the reference
imports nothing of the program, and the harness reads none of the JAX
benchmark's files."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "diffews_tpu"}
PROGRAM = "diffews_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _harness_files():
    return [p for p in tiny.BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_forbidden_import_in_the_sources():
    for p in _harness_files():
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, p
        if "reference" in p.parts:
            assert PROGRAM not in tops, p


def test_no_jax_benchmark_file_is_read():
    for p in _harness_files():
        text = p.read_text()
        for name in ("bench.py", "BENCH_", "BASELINE", "MULTICHIP"):
            assert name not in text, (p, name)


def test_a_run_loads_no_forbidden_module():
    """A whole tiny run in a fresh process, then every loaded module's
    top-level name, compared whole (the port's name begins with
    `diffews_tpu`)."""
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1])\n"
        "import runpy; runpy.run_path(sys.argv[1] + '/benchmark/run.py', run_name='bench')\n"
        "from benchmark import core; from benchmark.tests import tiny\n"
        "line, _ = core.run_cell(tiny.cell('sd21.cached-5shot-b8'), 7, 0.5, True, 'cpu')\n"
        "assert line['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tiny.ROOT)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded and not loaded & FORBIDDEN


@pytest.mark.parametrize("where", ["checkout", "benchmark_only"])
def test_run_without_a_card_exits_without_a_result(where, tmp_path):
    root = tiny.ROOT
    if where == "benchmark_only":
        import shutil

        shutil.copytree(tiny.BENCH, tmp_path / "benchmark")
        shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        root = tmp_path
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sd21.episode-1shot-b8", "--seed", str(2 ** 33), "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout
