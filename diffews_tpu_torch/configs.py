"""Model/scheduler configuration dataclasses with diffusers-JSON interop.

The reference ships model hyperparameters as diffusers `config.json` files
inside checkpoint directories (e.g. `unet/config.json` of
`stable-diffusion-2-1-ref8inchannels-tag4inchannels`); the scheduler config
lives in `scheduler_1.0_1.0/scheduler_config.json` (reference
`scheduler_1.0_1.0/scheduler_config.json:1-20`). These dataclasses can
round-trip those JSON files so reference checkpoints drop in unchanged.

The PyTorch port keeps its own copy of `diffews_tpu/configs.py` so that it
never imports the JAX package; the two must stay field-for-field equal
(`tests/test_torch_checkpoint.py` holds them to it).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


def _tup(x) -> Tuple:
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-2.1 style UNet2DConditionModel hyperparameters.

    Mirrors the subset of diffusers `UNet2DConditionModel.__init__` arguments
    that the DiffewS checkpoints exercise (reference
    `diffews/models/unet_2d_condition.py:185-643`), plus the dual-input-conv
    extension `in_channels_ref` (reference `unet_2d_condition.py:304-306`).
    """

    sample_size: int = 64
    in_channels: int = 4
    # 8-channel support stream input conv ("conv_in_ref"): concat of support
    # RGB latent and support mask latent.
    ref_in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Per-down-block head count.  diffusers quirk: SD2.x configs store this in
    # `attention_head_dim` with `num_attention_heads` unset; with
    # block_out_channels (320,640,1280,1280) this yields head_dim 64
    # everywhere.
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    transformer_layers_per_block: int = 1
    cross_attention_dim: int = 1024
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3
    resnet_time_scale_shift: str = "default"

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def sd21(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """Small config for CPU tests; same topology family as SD-2.1."""
        return cls(
            sample_size=8,
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1,
            num_attention_heads=(2, 4),
            cross_attention_dim=32,
            norm_num_groups=8,
        )

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "UNetConfig":
        heads = d.get("num_attention_heads") or d["attention_head_dim"]
        if not isinstance(heads, (list, tuple)):
            heads = [heads] * len(d["block_out_channels"])
        return cls(
            sample_size=d.get("sample_size", 64),
            in_channels=d.get("in_channels", 4),
            ref_in_channels=d.get("ref_in_channels", d.get("in_channels", 4) * 2),
            out_channels=d.get("out_channels", 4),
            down_block_types=_tup(d["down_block_types"]),
            up_block_types=_tup(d["up_block_types"]),
            block_out_channels=_tup(d["block_out_channels"]),
            layers_per_block=d.get("layers_per_block", 2),
            num_attention_heads=_tup(heads),
            transformer_layers_per_block=d.get("transformer_layers_per_block", 1),
            cross_attention_dim=d.get("cross_attention_dim", 1024),
            use_linear_projection=d.get("use_linear_projection", False),
            norm_num_groups=d.get("norm_num_groups", 32),
            norm_eps=d.get("norm_eps", 1e-5),
            flip_sin_to_cos=d.get("flip_sin_to_cos", True),
            freq_shift=d.get("freq_shift", 0),
        )

    def to_diffusers_dict(self) -> dict:
        return {
            "_class_name": "UNet2DConditionModel",
            "sample_size": self.sample_size,
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "down_block_types": list(self.down_block_types),
            "up_block_types": list(self.up_block_types),
            "block_out_channels": list(self.block_out_channels),
            "layers_per_block": self.layers_per_block,
            "attention_head_dim": list(self.num_attention_heads),
            "cross_attention_dim": self.cross_attention_dim,
            "use_linear_projection": self.use_linear_projection,
            "norm_num_groups": self.norm_num_groups,
            "norm_eps": self.norm_eps,
            "flip_sin_to_cos": self.flip_sin_to_cos,
            "freq_shift": self.freq_shift,
        }


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL hyperparameters (SD VAE)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    # Deterministic latent scale used by the inference pipeline (reference
    # `diffews/marigold_pipeline_rgb_latent_noise.py:120-124`).
    scaling_factor: float = 0.18215
    sample_size: int = 512

    @classmethod
    def sd(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8, sample_size=32)

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "VAEConfig":
        return cls(
            in_channels=d.get("in_channels", 3),
            out_channels=d.get("out_channels", 3),
            latent_channels=d.get("latent_channels", 4),
            block_out_channels=_tup(d["block_out_channels"]),
            layers_per_block=d.get("layers_per_block", 2),
            norm_num_groups=d.get("norm_num_groups", 32),
            scaling_factor=d.get("scaling_factor", 0.18215),
            sample_size=d.get("sample_size", 512),
        )

    def to_diffusers_dict(self) -> dict:
        return {
            "_class_name": "AutoencoderKL",
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "latent_channels": self.latent_channels,
            "block_out_channels": list(self.block_out_channels),
            "down_block_types": ["DownEncoderBlock2D"] * len(self.block_out_channels),
            "up_block_types": ["UpDecoderBlock2D"] * len(self.block_out_channels),
            "layers_per_block": self.layers_per_block,
            "norm_num_groups": self.norm_num_groups,
            "scaling_factor": self.scaling_factor,
            "sample_size": self.sample_size,
        }


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP ViT-H text tower as shipped with SD-2.1 checkpoints."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    bos_token_id: int = 49406
    eos_token_id: int = 49407

    @classmethod
    def sd21(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4)

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "CLIPTextConfig":
        return cls(
            vocab_size=d.get("vocab_size", 49408),
            hidden_size=d.get("hidden_size", 1024),
            intermediate_size=d.get("intermediate_size", 4096),
            num_hidden_layers=d.get("num_hidden_layers", 23),
            num_attention_heads=d.get("num_attention_heads", 16),
            max_position_embeddings=d.get("max_position_embeddings", 77),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            hidden_act=d.get("hidden_act", "gelu"),
            bos_token_id=d.get("bos_token_id", 49406),
            eos_token_id=d.get("eos_token_id", 49407),
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM scheduler configuration.

    The shipped DiffewS config (`scheduler_1.0_1.0/scheduler_config.json`) sets
    beta_start = beta_end = 1.0 with v-prediction, collapsing DDIM to
    `x0 = -model_output`, `prev_sample = sample` (see
    `diffews_tpu_torch.scheduler`).  The general form is retained for config parity
    with `marigold/util/scheduler_customized.py:107-181`.
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[Tuple[float, ...]] = None
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    timestep_spacing: str = "leading"
    rescale_betas_zero_snr: bool = False
    power_beta_curve: float = 1.0

    @classmethod
    def diffews(cls) -> "SchedulerConfig":
        """The degenerate one-step config shipped as `scheduler_1.0_1.0`."""
        return cls(
            beta_start=1.0,
            beta_end=1.0,
            beta_schedule="scaled_linear",
            clip_sample=False,
            prediction_type="v_prediction",
            set_alpha_to_one=False,
            steps_offset=1,
            timestep_spacing="leading",
        )

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "SchedulerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if kwargs.get("trained_betas") is not None:
            kwargs["trained_betas"] = tuple(kwargs["trained_betas"])
        return cls(**kwargs)

    def to_diffusers_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["trained_betas"] = list(self.trained_betas) if self.trained_betas else None
        d["_class_name"] = "DDIMScheduler"
        return d


def load_json_config(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)
