"""One rank of `tests/test_torch_parallel_gpu.py` (run by
`helpers.torch_ranks.run_ranks`; gloo, whose all_reduce takes CUDA
tensors, so that two ranks share one card; no JAX).

    python tests/helpers/shot_merge_ranks.py <out_dir>

On a ("shots",) mesh of 2, each rank takes its 2 of 4 shots and runs
`shot_parallel_fused_kv_attention(impl="flash")` on the card, f32 (TF32
off) and bf16, with every shot valid and with shots 1-3 padded (rank 1
then holds no valid key: its own tokens are biased out and its shots are
padded).  It also calls `flash_attention_lse` on rank 1's keys of the
padded case directly.  Writes `<out_dir>/rank<r>.json`: the merged
output's largest difference from the unsharded `fused_kv_attention` on the
card (flash) and from the f32 dense attention, relative to the latter's
largest value, and, for the empty shard, max |O| and whether every LSE is
-inf.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from diffews_tpu_torch.ops.attention import (NEG_INF, fused_kv_attention,  # noqa: E402
                                             shot_parallel_fused_kv_attention)
from diffews_tpu_torch.ops.flash_attention import flash_attention_lse  # noqa: E402
from diffews_tpu_torch.parallel import mesh as M  # noqa: E402

B, S, SR, H, D, N = 2, 256, 192, 2, 64, 4


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = sys.argv[1]
    M.maybe_initialize_distributed(device_type="cpu")
    mesh = M.make_shot_mesh("cpu", 2)
    group, k = M.axis_group(mesh, "shots"), M.axis_rank(mesh, "shots")
    sl = slice(k * N // 2, (k + 1) * N // 2)
    gen = torch.Generator().manual_seed(0)
    x = {n: torch.randn(shape, generator=gen) for n, shape in (
        ("q", (B, S, H, D)), ("ko", (B, S, H, D)), ("vo", (B, S, H, D)),
        ("ks", (B, N, SR, H, D)), ("vs", (B, N, SR, H, D)))}
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = {n: v.to("cuda", dtype) for n, v in x.items()}
        for case in ("all_valid", "shots_1_3_padded"):
            mask = torch.ones((B, N), dtype=torch.bool, device="cuda")
            if case != "all_valid":
                mask[:, 1:] = False
            got = shot_parallel_fused_kv_attention(
                t["q"], t["ko"], t["vo"], t["ks"][:, sl], t["vs"][:, sl], group=group,
                shot_mask=mask[:, sl], impl="flash").float()
            flash = fused_kv_attention(t["q"], t["ko"], t["vo"], t["ks"], t["vs"],
                                       shot_mask=mask, impl="flash").float()
            dense = fused_kv_attention(*(x[n].to("cuda") for n in ("q", "ko", "vo", "ks", "vs")),
                                       shot_mask=mask, impl="dense")
            scale = float(dense.abs().max())
            res[f"{dtype}_{case}"] = {
                "finite": bool(torch.isfinite(got).all()),
                "vs_flash": float((got - flash).abs().max()) / scale,
                "vs_dense": float((got - dense).abs().max()) / scale}
            if case != "all_valid" and k == 1:
                kk = torch.cat([t["ko"], t["ks"][:, sl].reshape(B, -1, H, D)], dim=1)
                vv = torch.cat([t["vo"], t["vs"][:, sl].reshape(B, -1, H, D)], dim=1)
                bias = torch.full((B, kk.shape[1]), NEG_INF, device="cuda")
                o, lse = flash_attention_lse(t["q"], kk, vv, kv_mask=bias >= -1e3)
                res[f"{dtype}_empty_shard"] = {
                    "max_abs_o": float(o.float().abs().max()),
                    "lse_all_neg_inf": bool(torch.isneginf(lse).all())}
    with open(os.path.join(out_dir, f"rank{M.rank()}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
