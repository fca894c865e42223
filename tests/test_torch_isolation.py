"""The port stands alone: `diffews_tpu_torch/` (`parallel/` and the CLIs
included), `chip_smoke.py`, the kernel A/B tools (`tools/cuda_*.py`), the
port's other tools (`tools/torch_*.py`), its example
(`examples/torch/serve_client.py`) and the scripts the tests start as torch
ranks (`tests/helpers/*_ranks.py`) import neither `jax`, `flax`, `optax`,
`safetensors`, `matplotlib` (the card's host has none) nor the JAX package;
the pipeline refuses to fall back to the CPU on a host without a CUDA
device, and so do a "cuda" mesh and the batch sizer."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's tests run beside the JAX package's)
import pytest
import torch
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "safetensors", "matplotlib", "diffews_tpu")


def _port_sources():
    files = (sorted((ROOT / "diffews_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("cuda_*.py"))
             + sorted((ROOT / "tools").glob("torch_*.py"))
             + [ROOT / "examples" / "torch" / "serve_client.py"]
             + sorted((ROOT / "tests" / "helpers").glob("*_ranks.py")))
    assert len(files) > 10
    for rel in ("parallel/mesh.py", "parallel/tensor_parallel.py", "cli/launcher.py", "cli/measure_baseline.py",
                "cli/verify_parity.py", "cli/prepare.py", "utils/image.py"):
        assert ROOT / "diffews_tpu_torch" / rel in files
    return files


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in FORBIDDEN)


def test_no_jax_or_reference_imports_in_port_sources():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import diffews_tpu_torch.pipeline, diffews_tpu_torch.checkpoint\n"
            "import diffews_tpu_torch.ops._build, diffews_tpu_torch.training.state\n"
            "import diffews_tpu_torch.ops.downsample\n"
            "import diffews_tpu_torch.cli.evaluate, diffews_tpu_torch.data.dataset\n"
            "import diffews_tpu_torch.evaluation, diffews_tpu_torch.native\n"
            "import diffews_tpu_torch.serving, diffews_tpu_torch.cli.serve\n"
            "import diffews_tpu_torch.cli.export\n"
            "import diffews_tpu_torch.training.lora, diffews_tpu_torch.training.checkpoints\n"
            "import diffews_tpu_torch.cli.train, diffews_tpu_torch.cli.surgery\n"
            "import diffews_tpu_torch.parallel.mesh, diffews_tpu_torch.parallel.tensor_parallel\n"
            "import diffews_tpu_torch.cli.launcher, diffews_tpu_torch.cli.measure_baseline\n"
            "import diffews_tpu_torch.cli.verify_parity, diffews_tpu_torch.cli.prepare\n"
            "import diffews_tpu_torch.data.tokenizer, diffews_tpu_torch.scheduler\n"
            "import diffews_tpu_torch.ops.resize, diffews_tpu_torch.utils.image\n"
            "import diffews_tpu_torch.utils.seeding, diffews_tpu_torch.utils.ensemble\n"
            "import diffews_tpu_torch.utils.batchsize, diffews_tpu_torch.utils.profiling\n"
            "import numpy as np\n"
            "from diffews_tpu_torch.utils.image import colorize_depth_maps\n"
            "colorize_depth_maps(np.zeros((2, 2), np.float32), 0, 1)\n"
            f"bad = [m for m in sys.modules if any(m == t or m.startswith(t + '.')\n"
            f"       for t in {FORBIDDEN!r})]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_pipeline_without_a_device_raises_on_a_cpu_host(monkeypatch):
    from diffews_tpu_torch import checkpoint as TC
    from diffews_tpu_torch import configs as TCF
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffewsPipeline(bundle)
    DiffewsPipeline(bundle, device="cpu")  # an explicit CPU request runs


def test_cuda_mesh_without_a_device_raises_on_a_cpu_host(monkeypatch):
    """A "cuda" mesh needs NCCL on a card: without one it raises, before it
    touches the process group, rather than building a gloo CPU mesh."""
    from diffews_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: M.make_mesh("cuda", 1), lambda: M.make_shot_mesh("cuda", 2),
                 lambda: M.maybe_initialize_distributed(True, "cuda")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
    assert not torch.distributed.is_initialized()


def test_batch_sizer_without_device_memory_raises(monkeypatch):
    """The batch sizer reads the card's memory and assumes none: with no
    CUDA device and no `hbm_gib` it raises."""
    from diffews_tpu_torch.utils.batchsize import find_batch_size

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="hbm_gib"):
        find_batch_size(8, 512)
    assert find_batch_size(8, 512, hbm_gib=80) == 8


def test_chip_smoke_fails_without_a_card():
    """`chip_smoke.py` exits non-zero and prints no result line on a host
    without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
