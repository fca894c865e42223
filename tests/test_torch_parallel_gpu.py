"""The shot merge on the card: `shot_parallel_fused_kv_attention` through
the flash kernel's `flash_attention_lse` route, as 2 ranks over gloo on
one card (`helpers/shot_merge_ranks.py`; NCCL refuses two ranks on one
device, and gloo's all_reduce takes CUDA tensors).

Held, in f32 (TF32 off) and bf16, with every shot valid and with shots
1-3 padded (rank 1 then holds no valid key): each rank's merged output is
finite and within 1e-4 (f32) or 2e-2 (bf16) of the largest value of the
unsharded `fused_kv_attention` on the card and of the f32 dense attention;
the empty shard's own `flash_attention_lse` gives O = 0 and LSE = -inf on
every row (the kernel's empty-row branch), so its weight in the merge is
exactly 0.  Marked `gpu`: skips without a CUDA device.  This file imports
no JAX; run it on the GPU host with

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import json

import pytest
import torch

from helpers.torch_ranks import run_ranks

pytestmark = pytest.mark.gpu
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}


def test_shot_merge_with_flash_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run_ranks(["tests/helpers/shot_merge_ranks.py", str(tmp_path)], 2, timeout=300)
    for r in range(2):
        res = json.load(open(tmp_path / f"rank{r}.json"))
        for dtype, tol in TOL.items():
            for case in ("all_valid", "shots_1_3_padded"):
                got = res[f"{dtype}_{case}"]
                assert got["finite"], (r, dtype, case)
                assert got["vs_flash"] <= tol and got["vs_dense"] <= tol, (r, dtype, case, got)
            if r == 1:
                empty = res[f"{dtype}_empty_shard"]
                assert empty["max_abs_o"] == 0.0 and empty["lse_all_neg_inf"], (dtype, empty)
