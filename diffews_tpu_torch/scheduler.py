"""DDIM and DDPM schedulers with extended beta ranges (betas >= 1 allowed).

Port of `diffews_tpu/scheduler.py`: `make_betas`, `inference_timesteps`,
`DDIMScheduler` (`set_timesteps`, `step`, and the training helpers
`add_noise` / `get_velocity`), `DDPMScheduler` and `from_pretrained`.  Beta
tables are host-side NumPy constants and timesteps are Python ints; `step`
applies the general epsilon / sample / v-prediction formulas to tensors.
For the shipped DiffewS config (beta_start = beta_end = 1.0, v-prediction)
they reduce to `pred_original_sample = -model_output`, `prev_sample =
sample`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from diffews_tpu_torch.configs import SchedulerConfig, load_json_config


class SchedulerStepOutput(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    """Beta schedule table, incl. the custom `scaled_linear_power` family."""
    T = cfg.num_train_timesteps
    if cfg.trained_betas is not None:
        betas = np.asarray(cfg.trained_betas, dtype=np.float32)
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float32)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T,
                            dtype=np.float32) ** 2
    elif cfg.beta_schedule == "scaled_linear_power":
        p = cfg.power_beta_curve
        betas = np.linspace(cfg.beta_start ** (1 / p), cfg.beta_end ** (1 / p), T,
                            dtype=np.float32) ** p
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = np.array(
            [min(1 - alpha_bar((i + 1) / T) / alpha_bar(i / T), 0.999) for i in range(T)],
            dtype=np.float32)
    else:
        raise NotImplementedError(f"beta_schedule={cfg.beta_schedule!r}")
    if cfg.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    return betas


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    alphas = 1.0 - betas
    abar_sqrt = np.sqrt(np.cumprod(alphas))
    abar_sqrt_0, abar_sqrt_T = abar_sqrt[0].copy(), abar_sqrt[-1].copy()
    abar_sqrt = abar_sqrt - abar_sqrt_T
    abar_sqrt = abar_sqrt * abar_sqrt_0 / (abar_sqrt_0 - abar_sqrt_T)
    abar = abar_sqrt ** 2
    alphas = np.concatenate([abar[0:1], abar[1:] / abar[:-1]])
    return (1 - alphas).astype(np.float32)


def inference_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending timestep table (diffusers `DDIMScheduler.set_timesteps`);
    `[1]` for the DiffewS config at one step."""
    T, n = cfg.num_train_timesteps, num_inference_steps
    if n > T:
        raise ValueError(f"num_inference_steps {n} > num_train_timesteps {T}")
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, n).round()[::-1].astype(np.int64)
    elif cfg.timestep_spacing == "leading":
        ts = (np.arange(0, n) * (T // n)).round()[::-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / n)).astype(np.int64) - 1
    else:
        raise ValueError(f"timestep_spacing={cfg.timestep_spacing!r}")
    return ts


@dataclasses.dataclass
class DDIMScheduler:
    """DDIM scheduler; every schedule table is a host-side constant."""

    config: SchedulerConfig

    def __post_init__(self):
        self.betas = make_betas(self.config)
        self.alphas = 1.0 - self.betas
        self.alphas_cumprod = np.cumprod(self.alphas).astype(np.float64)
        self.final_alpha_cumprod = (
            1.0 if self.config.set_alpha_to_one else float(self.alphas_cumprod[0]))
        self.init_noise_sigma = 1.0
        self.num_inference_steps: Optional[int] = None
        self.timesteps = np.arange(0, self.config.num_train_timesteps)[::-1].astype(np.int64)

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        self.num_inference_steps = num_inference_steps
        self.timesteps = inference_timesteps(self.config, num_inference_steps)
        return self.timesteps

    def _alpha_bar(self, t: int) -> float:
        return float(self.alphas_cumprod[t]) if t >= 0 else self.final_alpha_cumprod

    def _variance(self, t: int, prev_t: int) -> float:
        """Variance over the (prev_t, t] window of alphas, finite even when
        alphas_cumprod == 0 (`scheduler_customized.py:169-181`)."""
        beta_prod_t = 1 - self._alpha_bar(t)
        beta_prod_t_prev = 1 - self._alpha_bar(prev_t)
        window = self.alphas[prev_t + 1: t + 1]
        alpha_window = float(np.prod(window)) if window.size else 1.0
        return (beta_prod_t_prev / beta_prod_t) * (1 - alpha_window)

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             eta: float = 0.0, noise: Optional[torch.Tensor] = None) -> SchedulerStepOutput:
        """One DDIM update x_t -> x_{t-Δ}; `timestep` is a Python int."""
        cfg = self.config
        if self.num_inference_steps is None:
            raise RuntimeError("call set_timesteps() before step()")
        t = int(timestep)
        prev_t = t - cfg.num_train_timesteps // self.num_inference_steps
        alpha_prod_t = self._alpha_bar(t)
        alpha_prod_t_prev = self._alpha_bar(prev_t)
        sqrt_a = alpha_prod_t ** 0.5
        sqrt_b = (1 - alpha_prod_t) ** 0.5
        if cfg.prediction_type == "epsilon":
            pred_original = (sample - sqrt_b * model_output) / max(sqrt_a, 1e-20)
            pred_epsilon = model_output
        elif cfg.prediction_type == "sample":
            pred_original = model_output
            pred_epsilon = (sample - sqrt_a * pred_original) / max(sqrt_b, 1e-20)
        elif cfg.prediction_type == "v_prediction":
            pred_original = sqrt_a * sample - sqrt_b * model_output
            pred_epsilon = sqrt_a * model_output + sqrt_b * sample
        else:
            raise ValueError(f"prediction_type={cfg.prediction_type!r}")

        if cfg.thresholding:
            pred_original = self._threshold_sample(pred_original)
        elif cfg.clip_sample:
            pred_original = pred_original.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)

        std_dev_t = eta * self._variance(t, prev_t) ** 0.5
        direction = max(1 - alpha_prod_t_prev - std_dev_t ** 2, 0.0) ** 0.5 * pred_epsilon
        prev_sample = alpha_prod_t_prev ** 0.5 * pred_original + direction
        if eta > 0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            prev_sample = prev_sample + std_dev_t * noise
        return SchedulerStepOutput(prev_sample, pred_original)

    def _threshold_sample(self, sample: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b = sample.shape[0]
        flat = sample.reshape(b, -1).abs().float()
        s = torch.quantile(flat, cfg.dynamic_thresholding_ratio, dim=1)
        s = s.clamp(1.0, cfg.sample_max_value).reshape((b,) + (1,) * (sample.ndim - 1))
        return sample.clamp(-s, s) / s

    # -- training ----------------------------------------------------------

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timestep: int) -> torch.Tensor:
        a = self._alpha_bar(int(timestep))
        return (a ** 0.5) * original + ((1 - a) ** 0.5) * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timestep: int) -> torch.Tensor:
        a = self._alpha_bar(int(timestep))
        return (a ** 0.5) * noise - ((1 - a) ** 0.5) * sample


@dataclasses.dataclass
class DDPMScheduler(DDIMScheduler):
    """DDPM ancestral sampler on the same beta families (JAX
    `scheduler.py:233-290`); not on the DiffewS eval path."""

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        self.num_inference_steps = num_inference_steps
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        self.timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(
            np.int64)
        return self.timesteps

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             eta: float = 0.0, noise: Optional[torch.Tensor] = None) -> SchedulerStepOutput:
        """One ancestral step; `noise` adds the posterior variance (for
        t > 0).  `eta` is accepted and not read, as in the JAX package."""
        cfg = self.config
        t = int(timestep)
        prev_t = t - cfg.num_train_timesteps // (self.num_inference_steps
                                                 or cfg.num_train_timesteps)
        alpha_prod_t = self._alpha_bar(t)
        alpha_prod_t_prev = self._alpha_bar(prev_t)
        beta_prod_t = 1 - alpha_prod_t
        beta_prod_t_prev = 1 - alpha_prod_t_prev
        current_alpha_t = alpha_prod_t / max(alpha_prod_t_prev, 1e-20)
        current_beta_t = 1 - current_alpha_t
        if cfg.prediction_type == "epsilon":
            pred_original = (sample - beta_prod_t ** 0.5 * model_output) / max(
                alpha_prod_t ** 0.5, 1e-20)
        elif cfg.prediction_type == "sample":
            pred_original = model_output
        elif cfg.prediction_type == "v_prediction":
            pred_original = (alpha_prod_t ** 0.5) * sample - (beta_prod_t ** 0.5) * model_output
        else:
            raise ValueError(cfg.prediction_type)
        if cfg.clip_sample:
            pred_original = pred_original.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
        pred_original_coeff = (alpha_prod_t_prev ** 0.5 * current_beta_t) / max(beta_prod_t,
                                                                               1e-20)
        current_sample_coeff = current_alpha_t ** 0.5 * beta_prod_t_prev / max(beta_prod_t,
                                                                              1e-20)
        prev_sample = pred_original_coeff * pred_original + current_sample_coeff * sample
        if t > 0 and noise is not None:
            variance = beta_prod_t_prev / max(beta_prod_t, 1e-20) * current_beta_t
            prev_sample = prev_sample + max(variance, 0.0) ** 0.5 * noise
        return SchedulerStepOutput(prev_sample, pred_original)


def from_pretrained(path: str) -> DDIMScheduler:
    """A DDIM scheduler from a diffusers scheduler directory (its
    `scheduler_config.json`) or from that JSON file."""
    if os.path.isdir(path):
        path = os.path.join(path, "scheduler_config.json")
    return DDIMScheduler(SchedulerConfig.from_diffusers_dict(load_json_config(path)))
