"""SDXL-shaped configurations for the tests, in the benchmark's
configuration format: Stable Diffusion XL base 1.0 at its published widths
(`stabilityai/stable-diffusion-xl-base-1.0`: unet/, vae/, text_encoder/,
text_encoder_2/ config.json; Podell et al., arXiv 2307.01952) with
DiffewS's `conv_in_ref`, and a tiny one of the same shape for CPU runs.

The port runs neither yet: they show what the reference walks, and the
first failure of a tiny SDXL-shaped cell is the port's own."""

from __future__ import annotations

import copy
import json

from benchmark.tests import tiny

SD21 = json.loads((tiny.BENCH / "configs" / "sd21-bf16.json").read_text())


def published() -> dict:
    """SDXL base 1.0 at 1024 px: the UNet's per-level depth, "text_time"
    added conditioning, CLIP ViT-L/14 (`quick_gelu`, no projection) and
    OpenCLIP bigG/14 (with `text_projection`), both at the penultimate
    layer, and the SD VAE at SDXL's scaling factor."""
    cfg = copy.deepcopy(SD21)
    cfg["resolution"] = 1024
    cfg["unet"].update(
        sample_size=128,
        down_block_types=["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
        up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
        block_out_channels=[320, 640, 1280], num_attention_heads=[5, 10, 20],
        transformer_layers_per_block=[1, 2, 10], cross_attention_dim=2048,
        addition_embed_type="text_time", addition_time_embed_dim=256,
        projection_class_embeddings_input_dim=2816)
    cfg["vae"].update(scaling_factor=0.13025, sample_size=1024)
    cfg["text"] = dict(SD21["text"], hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                       num_attention_heads=12, hidden_act="quick_gelu",
                       context_layer="penultimate")
    cfg["text_2"] = dict(SD21["text"], hidden_size=1280, intermediate_size=5120,
                         num_hidden_layers=32, num_attention_heads=20, projection_dim=1280,
                         context_layer="penultimate")
    return cfg


def config(**over) -> dict:
    """A tiny SDXL-shaped configuration at 32 px, float32 (16² latents):
    three levels with no attention at the first, per-level depth [1, 2, 3],
    a `quick_gelu` tower and a projected `gelu` tower of another width,
    both at the penultimate layer, and "text_time" added conditioning."""
    cfg = tiny.config()
    cfg["unet"].update(
        down_block_types=["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
        up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
        block_out_channels=[32, 32, 64], num_attention_heads=[2, 2, 4],
        transformer_layers_per_block=[1, 2, 3], cross_attention_dim=32 + 48,
        addition_embed_type="text_time", addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=24 + 6 * 8)
    cfg["text"].update(hidden_act="quick_gelu", context_layer="penultimate")
    cfg["text_2"] = dict(cfg["text"], hidden_size=48, intermediate_size=96, num_hidden_layers=3,
                         num_attention_heads=4, hidden_act="gelu", projection_dim=24)
    cfg.update(over)
    return cfg
