"""Train state and the training step (port of `training/state.py`).

The reference training loop's inner step
(`train_tools/train_icl_multitask_nocrop_nearest_nshot_v3.py:1320-1396`),
as the JAX package runs it:

  - the four VAE encodes (query RGB / query mask / support RGB / support
    mask) fold into one batched posterior *sample* under `no_grad` (the
    VAE is frozen, in the compute dtype);
  - fixed timestep t = 1 * train_timestep, no noise added;
  - the frozen empty-prompt text embedding padded to 77 tokens;
  - the regression target is the negative query-mask latent, plain MSE in
    float32;
  - the support pass happens inside the joint UNet forward, so gradients
    reach it through the fused K/V;
  - gradient accumulation averages `gas` micro-batches (no accumulator at
    gas = 1);
  - grad-clip 1.0 + AdamW(1e-5, wd 1e-2, bf16 first moment) + polynomial
    decay, inside apply_if_finite (`training/optim.py`).

The master UNet parameters stay float32.  Each micro-step casts them to
the compute dtype (the JAX package's `params_c = tree_map(astype(dt))`)
and binds the casts to the UNet's modules for the forward *and* the
backward pass: under `remat` the backward recomputes each layer, and the
recomputation must read the same compute-dtype weights, which
`torch.func.functional_call` (whose binding ends when the forward returns)
would not give.  No `torch.autocast`: it picks other ops to run in bf16
than the JAX package does.

Data parallelism (`data_group`): each rank runs its rows of the global
batch, and its micro-steps' averaged gradients and loss are mean-reduced
over the group before the optimizer (one bucketed SUM `all_reduce`), as
JAX's global mean over a batch sharded on "data".  A sharded state
(`layout`, born sharded by `parallel.mesh.init_state_sharded`): the state
holds this rank's parts.  Under FSDP, before each micro-step the "data"
axis of the model is all-gathered in the compute dtype (the whole model at
once; a gather per layer is later work); the gradients are mean-reduced
over "data" and each rank keeps its shards.  Under tensor parallelism the
UNet runs its attention and feed-forward matmuls on this rank's parts of
the weights with the collectives of `parallel/tensor_parallel.py`
(`model_group`), and each rank's gradients are those of its parts.  The
replicated leaves are computed alike on every rank of the "model" axis
and stay equal only where the device's kernels are deterministic: on the
card that takes cuDNN's deterministic algorithms
(`torch.backends.cudnn.deterministic`, which the train CLI sets), else
the ranks' replicated gradients differ by float noise and the replicas
drift apart.

The step changes the state in place (parameters, optimizer moments, EMA)
and returns it with its metrics as device tensors, so a window of steps
runs without a host read.  Entry points run on `cuda` unless passed
`device="cpu"`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from diffews_tpu_torch.configs import CLIPTextConfig
from diffews_tpu_torch.models import clip_text
from diffews_tpu_torch.parallel import mesh as mesh_lib
from diffews_tpu_torch.pipeline import _true_div, resolve_device
from diffews_tpu_torch.training import ema as ema_lib
from diffews_tpu_torch.training import lr as lr_lib
from diffews_tpu_torch.training.optim import OptState, Optimizer
from diffews_tpu_torch.training.optim import make_optimizer as _make_optimizer
from diffews_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    learning_rate: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    lr_scheduler: str = "polynomial"
    lr_warmup_steps: int = 0
    lr_power: float = 1.0
    max_train_steps: int = 20000
    # micro-batches per optimizer step (the batch's leading axis decides
    # inside the step; the CLI sizes the batch from this)
    gradient_accumulation_steps: int = 4
    train_timestep: int = 1
    max_nshot: int = 1
    use_ema: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    # Adam first-moment storage dtype (bf16 halves the momentum footprint;
    # torch.float32 for bit-level optimizer parity with the reference)
    adam_mu_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"   # "auto"/"flash" (the CUDA kernels) or "dense"
    remat: bool = True
    # apply_if_finite: skip non-finite steps; accept after this many in a row
    max_nonfinite_steps: int = 10
    # LoRA (`training/lora.py`): 0 = full fine-tuning; rank > 0 trains
    # low-rank adapters on the sites of `lora_targets` ("attn" | "attn+ff")
    # with scale lora_alpha / rank (alpha None -> rank)
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    lora_targets: str = "attn"
    # the attn-mask conditioning variant (support masks as attention key
    # biases; `conv_in_ref` unused, its gradient zero, and it still decays)
    attn_mask_variant: bool = False
    # the reference's schedule quirk (`--reference_lr_quirk`): the loop it
    # forked steps the LR scheduler once per micro-batch, so the schedule
    # runs at schedule(step * k); 1 = the correct schedule
    lr_steps_per_opt_step: int = 1


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # float32 masters, requires_grad
    opt_state: OptState
    ema: Optional[ema_lib.EMAState]
    step: torch.Tensor               # int32 scalar on the device


def make_optimizer(cfg: TrainerConfig, layout=None) -> Optimizer:
    base = lr_lib.get_schedule(cfg.lr_scheduler, cfg.learning_rate, cfg.max_train_steps,
                               cfg.lr_warmup_steps, power=cfg.lr_power)
    k = cfg.lr_steps_per_opt_step
    schedule = base if k == 1 else (lambda step: base(torch.as_tensor(step) * k))
    return _make_optimizer(schedule, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                           eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay,
                           max_grad_norm=cfg.max_grad_norm, mu_dtype=cfg.adam_mu_dtype,
                           max_nonfinite_steps=cfg.max_nonfinite_steps, layout=layout)


def init_state(cfg: TrainerConfig, unet_params: Dict[str, torch.Tensor], *,
               device=None) -> TrainState:
    """The train state over `unet_params` (name -> tensor, e.g.
    `dict(unet.named_parameters())`).  The float32 masters are those
    tensors, moved to `device` (None = cuda; raises without a GPU) only
    where they are elsewhere: the state takes them over and the step
    updates them in place.  On the card, 4-D (conv) weights are kept
    channels-last, as the activations are."""
    dev = resolve_device(device)
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
    params = {}
    for name, p in unet_params.items():
        p = p.detach().to(device=dev, dtype=torch.float32)
        if p.ndim == 4:
            p = p.contiguous(memory_format=fmt)
        params[name] = p.requires_grad_(True)
    opt_state = make_optimizer(cfg).init(params)
    ema = ema_lib.init(params) if cfg.use_ema else None
    return TrainState(params, opt_state, ema, torch.zeros((), dtype=torch.int32, device=dev))


@contextlib.contextmanager
def bind_params(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """Run `module` with `tensors` (name -> tensor, the keys of
    `named_parameters()`) in place of its parameters until the block ends,
    so a backward pass inside the block (and any recomputation under
    `remat`) reads them too."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, attr = name.rpartition(".")
            sub = module.get_submodule(owner)
            saved.append((sub, attr, sub._parameters[attr]))
            sub._parameters[attr] = t
        yield module
    finally:
        for sub, attr, p in reversed(saved):
            sub._parameters[attr] = p


def training_text_embed(text: nn.Module, text_cfg: CLIPTextConfig) -> torch.Tensor:
    """The empty-prompt embedding of training: the ids padded to 77 tokens
    (`cli/train.py:294-295`), (1, 77, hidden), on the text encoder's
    device."""
    device = next(text.parameters()).device
    with torch.no_grad():
        return text(clip_text.empty_prompt_ids(text_cfg, pad_to=77, device=device))


class EpisodeLoss:
    """The reference's in-context regression objective on one micro-batch:
    `loss(vae, text_embed, micro, noise)`, run with the weights bound to
    `unet` (its own, or compute-dtype casts under `bind_params`; this
    rank's tensor-parallel parts over `model_group`).  `vae` is the frozen
    VAE in the compute dtype; `noise` is a `torch.Generator` for the
    posterior sample or its standard-normal draws; `micro`'s fields are
    those of `make_train_step` without the gas axis.

    Its two stages, which the training step runs under spans of their own:
    `latents(vae, micro, noise)` (the streams normalised and their no-grad
    posterior sample; no UNet weight is read) and `forward(lat, text_embed,
    micro)` (the UNet forward and the loss)."""

    def __init__(self, cfg: TrainerConfig, unet: nn.Module, model_group=None):
        self.cfg, self.unet, self.model_group = cfg, unet, model_group

    def _norm_img(self, x):
        if x.dtype == torch.uint8:
            x = _true_div(_true_div(x.float(), 255.0) - 0.5, 0.5)
        return x.to(self.cfg.compute_dtype)

    def _norm_mask(self, m, img_ndim):
        if m.ndim == img_ndim - 1:  # binary (..., H, W) {0,1}
            mf = m.float() * 2.0 - 1.0
            return mf[..., None].expand(mf.shape + (3,)).to(self.cfg.compute_dtype)
        return self._norm_img(m)

    def latents(self, vae, micro, noise) -> tuple:
        """(query latent, query-mask latent, support stream, attn-mask
        variant's support masks or None)."""
        cfg = self.cfg
        with annotate("diffews.train.latents"):
            q = self._norm_img(micro["query"])
            qm3 = self._norm_mask(micro["q_mask3"], micro["query"].ndim)
            sup = self._norm_img(micro["supports"])
            sm3 = self._norm_mask(micro["s_mask3"], micro["supports"].ndim)
            b, n = sup.shape[0], sup.shape[1]
            flat = lambda x: x.reshape((b * n,) + tuple(x.shape[2:]))
            streams = [q, qm3, flat(sup)]
            if not cfg.attn_mask_variant:
                streams.append(flat(sm3))
            with torch.no_grad():  # frozen VAE: stochastic posterior sample
                gen = noise if isinstance(noise, torch.Generator) else None
                lat = vae.sample_latent(torch.cat(streams, dim=0), None if gen else noise,
                                        generator=gen, attn_impl=cfg.attn_impl)
            lh, lw = lat.shape[1:3]
            q_lat, qm_lat = lat[:b], lat[b:2 * b]
            s_lat = lat[2 * b:2 * b + b * n].reshape(b, n, lh, lw, -1)
            if cfg.attn_mask_variant:
                ref = s_lat
                ref_mask = (sm3.float().mean(dim=-1) > 0.0).float()  # (B, N, H, W)
            else:
                sm_lat = lat[2 * b + b * n:].reshape(b, n, lh, lw, -1)
                ref = torch.cat([s_lat, sm_lat], dim=-1)
                ref_mask = None
            return q_lat, qm_lat, ref, ref_mask

    def forward(self, lat: tuple, text_embed, micro) -> torch.Tensor:
        cfg = self.cfg
        q_lat, qm_lat, ref, ref_mask = lat
        ctx = text_embed.expand((q_lat.shape[0],) + tuple(text_embed.shape[1:])).to(
            cfg.compute_dtype)
        pred = self.unet(q_lat, cfg.train_timestep, ctx, ref_sample=ref,
                         shot_mask=micro["shot_mask"], ref_mask=ref_mask,
                         attn_impl=cfg.attn_impl, remat=cfg.remat,
                         model_group=self.model_group)
        return (pred.float() - (-qm_lat).float()).square().mean()

    def __call__(self, vae, text_embed, micro, noise) -> torch.Tensor:
        return self.forward(self.latents(vae, micro, noise), text_embed, micro)


def make_episode_loss(cfg: TrainerConfig, unet: nn.Module, model_group=None) -> EpisodeLoss:
    return EpisodeLoss(cfg, unet, model_group)


def episode_grads(episode: EpisodeLoss, prepare, vae, text_embed, micro, noise):
    """(loss, float32 gradients) of `episode` on one micro-batch.
    `prepare()` returns (the weights to bind to the UNet, name -> tensor;
    the tensors to differentiate with respect to, name -> tensor); one the
    loss does not reach gets a zero gradient, as in JAX.  The parts run
    under the step's spans: latents, forward (`prepare`, the binding, the
    UNet forward and the loss) and backward (remat's recomputation too)."""
    lat = episode.latents(vae, micro, noise)
    with contextlib.ExitStack() as bound:
        with annotate("diffews.train.forward"):
            weights, wrt = prepare()
            bound.enter_context(bind_params(episode.unet, weights))
            loss = episode.forward(lat, text_embed, micro)
        with annotate("diffews.train.backward"):
            grads = torch.autograd.grad(loss, list(wrt.values()), allow_unused=True)
            return loss.detach(), {n: torch.zeros_like(t, dtype=torch.float32) if g is None
                                   else g.float() for (n, t), g in zip(wrt.items(), grads)}


GradFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_grad_fn(cfg: TrainerConfig, unet: nn.Module) -> GradFn:
    """Returns `grad_fn(params, vae, text_embed, micro, noise) -> (loss,
    grads)`: the episode loss with `params` (float32 masters) cast to the
    compute dtype, and its float32 gradients with respect to them.  A
    parameter the loss does not reach gets a zero gradient, as in JAX."""
    episode = make_episode_loss(cfg, unet)
    dt = cfg.compute_dtype

    def grad_fn(params, vae, text_embed, micro, noise):
        prepare = lambda: ({n: p.to(dt) for n, p in params.items()}, params)
        return episode_grads(episode, prepare, vae, text_embed, micro, noise)

    return grad_fn


def make_sharded_grad_fn(cfg: TrainerConfig, unet: nn.Module, layout) -> GradFn:
    """`make_grad_fn` over a sharded state: `grad_fn(parts, ...)` gathers
    the "data" axis of the model (FSDP) in the compute dtype (channels-last
    conv weights on the card), binds this rank's tensor-parallel parts and
    the whole other leaves to `unet`, and returns the loss and the float32
    gradients of what it bound (the gradient of a cast is the cast's
    gradient, as in JAX)."""
    episode = make_episode_loss(cfg, unet, model_group=layout.model_group)
    dt = cfg.compute_dtype

    def grad_fn(shards, vae, text_embed, micro, noise):
        def prepare():
            full = {}
            with torch.no_grad():
                for n, s in shards.items():
                    t = layout.gather_data(n, s.detach().to(dt))
                    if t.ndim == 4 and t.is_cuda:
                        t = t.contiguous(memory_format=torch.channels_last)
                    full[n] = t.requires_grad_(True)
            return full, full

        return episode_grads(episode, prepare, vae, text_embed, micro, noise)

    return grad_fn


def accumulate_grads(grad_fn: GradFn, train_params, extra, batch, noises, gas: int):
    """(loss, grads) of `grad_fn(train_params, *extra, micro, noise)`
    averaged over the `gas` leading micro-batch axis of `batch`."""
    micro = lambda i: {k: v[i] for k, v in batch.items()}
    if gas == 1:  # no accumulator: saves a float32 grad-sized buffer
        return grad_fn(train_params, *extra, micro(0), noises[0])
    loss_sum, acc = grad_fn(train_params, *extra, micro(0), noises[0])
    for i in range(1, gas):
        loss_i, grads = grad_fn(train_params, *extra, micro(i), noises[i])
        loss_sum = loss_sum + loss_i
        for n, g in grads.items():
            acc[n].add_(g)
    for g in acc.values():
        g.div_(torch.full((), float(gas), dtype=g.dtype, device=g.device))
    return _true_div(loss_sum, float(gas)), acc


def make_train_step(cfg: TrainerConfig, unet: nn.Module, *, data_group=None, layout=None):
    """Returns `step_fn(state, batch, rng, vae, text_embed) -> (state,
    metrics)`.  `unet` gives the model's structure: its own parameter
    values are not read (the state's masters are bound in their place).

    `batch` fields, each with leading (gas, B) axes, on the state's device:
      query:    (G, B, H, W, 3) in [-1, 1], or raw uint8 0..255
      q_mask3:  (G, B, H, W, 3) in [-1, 1], or binary (G, B, H, W) {0,1}
      supports: (G, B, N, H, W, 3) like query
      s_mask3:  (G, B, N, H, W, 3) or binary (G, B, N, H, W) like q_mask3
      shot_mask:(G, B, N) bool
    `rng`: a `torch.Generator` for the posterior samples, or their
    standard-normal draws, (G, images, h, w, latent_channels).  `vae`: the
    frozen VAE in the compute dtype, channels-last on the card (its
    GroupNorm kernels take contiguous NHWC activations and raise on
    others); `text_embed`: (1, 77, D).

    Metrics (device tensors): loss, the pre-clip grad_norm, and
    apply_if_finite's notfinite_count and total_notfinite.

    `data_group`: the process group of the "data" axis (the batch holds
    this rank's rows; `rng` draws this rank's images); `layout`: the layout
    of a state from `parallel.mesh.init_state_sharded` (its data group is
    the "data" axis's)."""
    if layout is not None:
        return step_from_grad_fn(cfg, make_sharded_grad_fn(cfg, unet, layout),
                                 data_group=layout.data_group, layout=layout)
    return step_from_grad_fn(cfg, make_grad_fn(cfg, unet), data_group=data_group)


def step_from_grad_fn(cfg: TrainerConfig, grad_fn: GradFn, *, data_group=None, layout=None):
    """`step_fn(state, batch, rng, *extra) -> (state, metrics)` around
    `grad_fn(state.params, *extra, micro, noise)`: the gradients averaged
    over the micro-batches (and over `data_group`; then cut to this rank's
    "data" shards under `layout`), the optimizer update, EMA and step
    count."""
    tx = make_optimizer(cfg, layout=layout)

    def step_fn(state: TrainState, batch, rng, *extra) -> Tuple[TrainState, dict]:
        with annotate("diffews.train.step"):
            gas = batch["query"].shape[0]
            noises = [rng] * gas if isinstance(rng, torch.Generator) else rng
            loss, grads = accumulate_grads(grad_fn, state.params, extra, batch, noises, gas)
            if data_group is not None:
                with annotate("diffews.train.reduce"):
                    loss = loss.clone()
                    mesh_lib.all_reduce_mean([loss] + list(grads.values()), data_group)
            if layout is not None:
                grads = {n: layout.shard_data(n, g) for n, g in grads.items()}
            with annotate("diffews.train.optimizer"):
                gnorm = tx.update(grads, state.opt_state, state.params)
            del grads
            if state.ema is not None:
                with annotate("diffews.train.ema"):
                    ema_lib.update(state.ema, state.params)
            state.step = state.step + 1
            metrics: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm}
            if cfg.max_nonfinite_steps > 0:
                metrics["notfinite_count"] = state.opt_state.notfinite_count
                metrics["total_notfinite"] = state.opt_state.total_notfinite
            return state, metrics

    return step_fn
