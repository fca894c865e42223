"""DiffewS in PyTorch for NVIDIA Hopper (H100).

A port of `diffews_tpu` (JAX/Pallas), which stays in the repository as the
reference.  Module layout and names mirror the JAX package, so the
counterpart of `diffews_tpu/models/unet.py` is `diffews_tpu_torch/models/
unet.py`.  The package imports `torch` and numpy only — never `jax` or
anything under `diffews_tpu`.

Public functions keep the JAX package's layouts (NHWC images and latents,
`(B, S, H, D)` attention operands); modules' `state_dict` keys are the
diffusers keys.  Entry points run on `cuda` unless the caller passes
`device="cpu"`.  Every Pallas kernel on the ported path is a CUDA C++
kernel under `ops/csrc/`, built with `nvcc` at first use
(`ops/_build.py`).
"""
