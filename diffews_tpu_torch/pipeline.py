"""One-step few-shot segmentation inference pipeline (PyTorch port).

Port of `diffews_tpu/pipeline.py`'s main path (`pipeline.py:399-499,
583-648,781-793,920-950`) and its cached-support serving (`:501-565,
658-779`).  Per episode:

  1. ingest uint8 (or [-1, 1] float) query and support images and {0,1}
     (or 3-channel [-1, 1]) support masks, normalised on the device with
     the host transform's exact f32 arithmetic;
  2. one batched VAE mean-latent encode of the query, support and mask
     streams (B + 2·B·N images);
  3. the joint UNet forward: support rows through `conv_in_ref`, query rows
     through `conv_in`, query self-attention over `[own ‖ n·support]` keys;
  4. the degenerate one-step DDIM (x0 = -v for the DiffewS scheduler);
  5. VAE decode, clip, [0, 255] and truncation to uint8;
  6. the relative (or absolute) threshold, on the host or on the device.

The depth head (`predict_depth`, JAX `pipeline.py:567-579,795-837`) runs
steps 1-4, decodes, and takes the decoded image's channel mean, clipped to
[-1, 1] and mapped to [0, 1]; it is bilinear-resized on the device, then
min-max normalised per row and colourised on the host.

Repeated-support serving: `precompute_supports` runs steps 1-3 for a
support set once, with a zero dummy query, and keeps every self-attention
site's support K/V in a `SupportCache`; `predict_cached` then runs the
query's encode, a query-only UNet forward over `[own ‖ cached support]`
and steps 4-6 for any number of queries.

Multi-device serving (JAX `pipeline.py:195-310,676-762`), one process per
device under `torchrun`, every rank calling the same entry points with the
same arguments:

  - `mesh` (a ("data",) or ("data", "model") `DeviceMesh`,
    `parallel.mesh.make_mesh`): each rank runs its contiguous rows of the
    episode batch (the same rows on every rank of a "model" axis, which the
    pipeline replicates its weights over, as JAX's does), and `predict`
    returns the whole batch on every rank, gathered over "data", as the JAX
    call returns the global array.  `precompute_supports` builds a batch-1 cache
    on every rank (it serves any query batch) and a batch-B cache row for
    row with the query batch;
  - `shot_mesh` (("shots",) or ("data", "shots"), `make_shot_mesh`): each
    rank encodes and runs its local shots only, the query stream is
    replicated over "shots", and every fused self-attention merges the
    partial softmaxes over "shots"; a "data" axis shards the batch as
    above.  It does not compose with `mesh` or with the support cache.

The row gathers are `all_reduce`s of zero-filled wholes
(`parallel.mesh.all_gather_rows`), which gloo also runs on CUDA tensors,
so a gloo mesh serves every mesh with two ranks on one card.

PyTorch runs eagerly and CUDA launches are asynchronous, so `predict_async`
and `predict_cached_async` return as soon as the work is queued;
`PendingSeg.result()` is the synchronisation point (uploads go through
pinned memory, so they do not wait for the device).  The pipeline runs on
`cuda` unless `device="cpu"` is passed; it never moves to the CPU by
itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from diffews_tpu_torch import checkpoint as ckpt_lib
from diffews_tpu_torch.configs import UNetConfig, VAEConfig
from diffews_tpu_torch.models import clip_text
from diffews_tpu_torch.parallel import mesh as mesh_lib
from diffews_tpu_torch.ops import quant
from diffews_tpu_torch.ops.resize import bilinear_resize, nearest_resize
from diffews_tpu_torch.scheduler import DDIMScheduler
from diffews_tpu_torch.utils import to_device
from diffews_tpu_torch.utils.image import colorize_depth_maps
from diffews_tpu_torch.utils.profiling import annotate

VAE_IMPLS = ("xla", "fused", "mixed", "auto", "int8")
# the JAX CLIs' --attn_impl choices -> the pipeline's attn_impl
ATTN_IMPLS = {"auto": "auto", "xla": "dense", "pallas": "flash"}


@dataclasses.dataclass
class SegOutput:
    """Counterpart of `MarigoldSegOutput` (pipeline `:66-80`)."""

    seg_colored: np.ndarray  # (B, H, W, 3) uint8
    mask: Optional[np.ndarray] = None  # (B, H, W) bool, if thresholding requested
    uncertainty: Optional[np.ndarray] = None


@dataclasses.dataclass
class DepthOutput:
    """Counterpart of `MarigoldDepthOutput` (pipeline `:44-63`)."""

    depth_np: np.ndarray  # (B, H, W) float32 in [0, 1]
    depth_colored: Optional[np.ndarray] = None  # (B, H, W, 3) uint8
    uncertainty: Optional[np.ndarray] = None


@dataclasses.dataclass
class SupportCache:
    """A support set encoded once for repeated-support serving (pipeline
    `:51-71`): per self-attention site the shot-folded support K/V (and the
    attn-mask key bias), and the shot validity mask, on the device.  Built
    by `DiffewsPipeline.precompute_supports`, consumed by `predict_cached`
    / `predict_cached_async`.  A cache of batch 1 serves any query batch."""

    entries: tuple  # per site (k_sup, v_sup, bias or None)
    shot_mask: Optional[torch.Tensor]  # (B, N) bool or None
    n_shots: int
    batch: int


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when None.  Raises when None is given on
    a host without a CUDA device: the port does not fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run its plain-PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division.  A Python-scalar divisor makes CUDA
    multiply by the reciprocal instead, which differs in the last bit.  The
    divisor is filled on the device (a host tensor copied there would
    synchronise the stream)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


class DiffewsPipeline:
    """Few-shot segmentation predictor.

    Args:
      bundle: `checkpoint.PipelineBundle`.  The pipeline moves and casts the
        bundle's modules in place (no second copy of the weights).
      device: torch device; None = "cuda" (raises if there is none).
      compute_dtype: torch.float32 (parity) or torch.bfloat16 (speed).
      attn_impl: "auto"/"flash" (the CUDA flash kernel on the card, its
        plain version on the CPU) or "dense".
      test_timestep: timestep multiplier (`main_oss.py --test_timestep`).
      encode_chunks: split the batched VAE encode into this many chunks
        (0 = one batch up to 48 images, else chunks of <= 24); numerics are
        unchanged, images are independent through the VAE.
      attn_mask_variant: the experimental ATTN-MASK conditioning (support
        masks as per-level attention key biases; `unet.forward` ref_mask).
      vae_impl: the VAE's resnets ("xla" | "fused" | "mixed" | "auto";
        `models/vae.py`).  "xla" (default) keeps the outputs independent
        of the batch size; "fused"/"mixed" force the fused resnet chain
        for encode and decode (it rounds its GroupNorm differently, by
        design); "auto" encodes through the fused chain when the encode
        batch has <= 4 images on a CUDA device, else "xla", and decodes
        through "xla"; "int8" runs the "xla" graph with every 3x3 conv of
        >= 32 input channels W8A8 (`ops.quant`: static activation scales
        calibrated at init on a synthetic batch, the int8 conv kernels on
        the card; JAX `pipeline.py:179-194`).
      mesh: optional ("data",) or ("data", "model") `DeviceMesh`: the
        episode batch splits over "data" (replicated over "model") and every
        rank gets the whole prediction.
      shot_mesh: optional ("shots",) or ("data", "shots") `DeviceMesh`: the
        support shots (and the batch, over "data") split over its ranks.
      unet_int8: W8A8 UNet self-attention, feed-forward and proj_in/out
        linears (`ops.quant.unet_attention_linear`) with static scales
        calibrated at init (JAX `pipeline.py:226-248`); cross-attention
        and convs stay in the compute dtype.
    """

    def __init__(self, bundle: ckpt_lib.PipelineBundle, *, device=None,
                 compute_dtype=torch.float32, attn_impl: str = "auto",
                 test_timestep: int = 1, mesh=None, shot_mesh=None,
                 encode_chunks: int = 0, vae_impl: str = "xla",
                 unet_int8: bool = False, attn_mask_variant: bool = False):
        if vae_impl not in VAE_IMPLS:
            raise ValueError(f"unknown vae_impl {vae_impl!r} (expected one of {VAE_IMPLS})")
        if shot_mesh is not None and "model" in (shot_mesh.mesh_dim_names or ()):
            raise ValueError('shot_mesh has a "shots" axis and an optional "data" axis, '
                             'no "model" axis (parallel.mesh.make_shot_mesh)')
        if mesh is not None and shot_mesh is not None:
            raise ValueError(
                "pass either mesh (episode data-parallel) or shot_mesh; to "
                'compose them, give shot_mesh a 2-D ("data", "shots") mesh '
                "(parallel.mesh.make_shot_mesh(device_type, n_shards, n_data=...))")
        if mesh is not None and "data" not in (mesh.mesh_dim_names or ()):
            raise ValueError('mesh must have a "data" axis')
        if shot_mesh is not None and "shots" not in (shot_mesh.mesh_dim_names or ()):
            raise ValueError('shot_mesh must have a "shots" axis')
        self.mesh, self.shot_mesh = mesh, shot_mesh
        m = mesh if mesh is not None else shot_mesh
        has_data = m is not None and "data" in m.mesh_dim_names
        self._data_group = mesh_lib.axis_group(m, "data") if has_data else None
        self._n_data = mesh_lib.axis_size(m, "data") if has_data else 1
        self._data_rank = mesh_lib.axis_rank(m, "data") if has_data else 0
        self._shot_group = (mesh_lib.axis_group(shot_mesh, "shots")
                            if shot_mesh is not None else None)
        self._n_shots = mesh_lib.axis_size(shot_mesh, "shots") if shot_mesh is not None else 1
        self._shot_rank = mesh_lib.axis_rank(shot_mesh, "shots") if shot_mesh is not None else 0
        if attn_impl not in ("auto", "flash", "dense"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.device = resolve_device(device)
        self.unet_cfg: UNetConfig = bundle.unet_cfg
        self.vae_cfg: VAEConfig = bundle.vae_cfg
        self.scheduler = DDIMScheduler(bundle.scheduler_cfg)
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.test_timestep = test_timestep
        self.encode_chunks = int(encode_chunks)
        self.attn_mask_variant = bool(attn_mask_variant)
        self.vae_impl = vae_impl

        fmt = (torch.channels_last if self.device.type == "cuda"
               else torch.contiguous_format)
        self.unet = bundle.unet.to(device=self.device, dtype=compute_dtype,
                                   memory_format=fmt).eval().requires_grad_(False)
        self.vae = bundle.vae.to(device=self.device, dtype=compute_dtype,
                                 memory_format=fmt).eval().requires_grad_(False)
        if vae_impl == "int8":
            # static per-site scales from a synthetic batch through the
            # "xla" graph, on this device; the int8-ness then lives in the
            # swapped modules and the episode runs the "xla" graph
            scales = quant.calibrate_vae_scales(self.vae, attn_impl=attn_impl,
                                                dtype=compute_dtype)
            quant.quantize_conv_modules(self.vae, a_scales=scales)

        # Empty-prompt embedding, computed once in the text encoder's own
        # dtype (pipeline `:585-614`); the eval protocol uses the unpadded
        # [bos, eos] ids.
        with torch.inference_mode():
            if bundle.text is not None:
                text = bundle.text.to(self.device).eval()
                ids = clip_text.empty_prompt_ids(bundle.text_cfg, device=self.device)
                self.empty_text_embed = text(ids).to(compute_dtype)
            else:
                self.empty_text_embed = torch.zeros(
                    (1, 2, self.unet_cfg.cross_attention_dim),
                    dtype=compute_dtype, device=self.device)
        if unet_int8:
            # every rank of a mesh calibrates alike on the same draws
            scales = quant.calibrate_unet_scales(self.unet, self.empty_text_embed,
                                                 attn_impl=attn_impl)
            quant.quantize_linear_modules(self.unet, a_scales=scales)

    @classmethod
    def from_pretrained(cls, checkpoint: str, unet_dir: Optional[str] = None,
                        scheduler_dir: Optional[str] = None, **kw) -> "DiffewsPipeline":
        bundle = ckpt_lib.load_pipeline_bundle(checkpoint, unet_dir, scheduler_dir)
        return cls(bundle, **kw)

    # -- the episode -------------------------------------------------------

    def _norm_img(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 ingestion with the host transform's exact f32 `/255, -0.5,
        /0.5` arithmetic (bit-identical to host-normalised floats)."""
        if x.dtype == torch.uint8:
            x = _true_div(_true_div(x.float(), 255.0) - 0.5, 0.5)
        return x.to(self.compute_dtype)

    def _norm_mask(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W) {0,1} -> (B, N, H, W, 3) in [-1, 1] (`main_oss.py:
        100-104`); 5-D inputs pass through the image normalisation."""
        if masks.ndim == 4:
            m = masks.float() * 2.0 - 1.0
            return m[..., None].expand(m.shape + (3,)).to(self.compute_dtype)
        return self._norm_img(masks)

    def _encode_images(self, all_imgs: torch.Tensor) -> torch.Tensor:
        """Batched VAE mean-latent encode, optionally in chunks.  "auto"
        decides on the whole batch, before chunking (JAX
        `pipeline.py:354-367`)."""
        nimg = all_imgs.shape[0]
        resnet_impl = self.vae_impl
        if resnet_impl == "auto":
            resnet_impl = "fused" if nimg <= 4 and self.device.type == "cuda" else "xla"
        elif resnet_impl == "int8":  # the convs are quantized modules
            resnet_impl = "xla"
        chunks = self.encode_chunks or (1 if nimg <= 48 else -(-nimg // 24))
        enc = lambda x: self.vae.encode_mean_latent(x, attn_impl=self.attn_impl,
                                                    resnet_impl=resnet_impl)
        if chunks <= 1:
            return enc(all_imgs)
        per = -(-nimg // chunks)
        return torch.cat([enc(c) for c in all_imgs.split(per)], dim=0)

    def _x0_latent(self, query, supports, masks, text_embed, shot_mask,
                   denoising_steps: int, shot_group=None) -> torch.Tensor:
        """Predicted x0 latent of the episode (of this rank's shots under
        `shot_group`)."""
        b, n = supports.shape[0], supports.shape[1]
        flat = lambda x: x.reshape((b * n,) + tuple(x.shape[2:]))
        with annotate("diffews.pipeline.encode"):
            query, supports = self._norm_img(query), self._norm_img(supports)
            masks = self._norm_mask(masks)
            if self.attn_mask_variant:
                # support masks become per-level attention key biases; only
                # query and support RGB go through the VAE
                ref_mask = (masks.float().mean(dim=-1) > 0.0).float()  # (B, N, H, W)
                lat = self._encode_images(torch.cat([query, flat(supports)], dim=0))
                lh, lw = lat.shape[1:3]
                q_lat = lat[:b]
                ref = lat[b:].reshape(b, n, lh, lw, -1)
            else:
                ref_mask = None
                lat = self._encode_images(torch.cat([query, flat(supports), flat(masks)], dim=0))
                lh, lw = lat.shape[1:3]
                q_lat = lat[:b]
                s_lat = lat[b:b + b * n].reshape(b, n, lh, lw, -1)
                m_lat = lat[b + b * n:].reshape(b, n, lh, lw, -1)
                ref = torch.cat([s_lat, m_lat], dim=-1)  # (B, N, h, w, 8)

        with annotate("diffews.pipeline.unet"):
            ctx = text_embed.expand((b,) + tuple(text_embed.shape[1:])).to(self.compute_dtype)
            self.scheduler.set_timesteps(denoising_steps)
            latent = x0 = q_lat
            for t in self.scheduler.timesteps:
                v = self.unet(latent, int(t) * self.test_timestep, ctx, ref_sample=ref,
                              shot_mask=shot_mask, ref_mask=ref_mask,
                              attn_impl=self.attn_impl, shot_group=shot_group)
                latent, x0 = self.scheduler.step(v, int(t), latent)
        return x0

    def _capture(self, supports, masks, text_embed) -> tuple:
        """The support stream once, with a zero dummy query (the support
        rows never read the query rows, so the captured K/V are a joint
        episode's): the per-site `(k_sup, v_sup, bias)` entries."""
        b, n = supports.shape[0], supports.shape[1]
        flat = lambda x: x.reshape((b * n,) + tuple(x.shape[2:]))
        with annotate("diffews.pipeline.encode"):
            supports, masks = self._norm_img(supports), self._norm_mask(masks)
            if self.attn_mask_variant:
                ref_mask = (masks.float().mean(dim=-1) > 0.0).float()
                lat = self._encode_images(flat(supports))
                ref = lat.reshape((b, n) + tuple(lat.shape[1:]))
            else:
                ref_mask = None
                lat = self._encode_images(torch.cat([flat(supports), flat(masks)], dim=0))
                s_lat, m_lat = (x.reshape((b, n) + tuple(lat.shape[1:])) for x in lat.chunk(2))
                ref = torch.cat([s_lat, m_lat], dim=-1)
        with annotate("diffews.pipeline.unet"):
            ctx = text_embed.expand((b,) + tuple(text_embed.shape[1:])).to(self.compute_dtype)
            self.scheduler.set_timesteps(1)
            t = int(self.scheduler.timesteps[0]) * self.test_timestep
            dummy_q = torch.zeros((b,) + tuple(lat.shape[1:3]) + (self.unet_cfg.in_channels,),
                                  dtype=self.compute_dtype, device=self.device)
            cap: list = []
            self.unet(dummy_q, t, ctx, ref_sample=ref, ref_mask=ref_mask,
                      attn_impl=self.attn_impl, kv_capture=cap)
        return tuple(cap)

    def _x0_latent_cached(self, query, entries, shot_mask, text_embed) -> torch.Tensor:
        """Predicted x0 latent of the queries against cached support K/V."""
        with annotate("diffews.pipeline.encode"):
            q_lat = self._encode_images(self._norm_img(query))
        with annotate("diffews.pipeline.unet"):
            ctx = text_embed.expand((q_lat.shape[0],) + tuple(text_embed.shape[1:])).to(
                self.compute_dtype)
            self.scheduler.set_timesteps(1)
            t = int(self.scheduler.timesteps[0])
            v = self.unet(q_lat, t * self.test_timestep, ctx, shot_mask=shot_mask,
                          attn_impl=self.attn_impl, kv_cache=entries)
            return self.scheduler.step(v, t, q_lat)[1]

    def _decode_resnet_impl(self) -> str:
        """The decoder's resnets: forced "fused"/"mixed" apply to the whole
        VAE; "auto"'s choice is encode-only (JAX `pipeline.py:474-481`)."""
        return self.vae_impl if self.vae_impl in ("fused", "mixed") else "xla"

    def _decode_seg(self, x0: torch.Tensor) -> torch.Tensor:
        """VAE decode + clip(-1, 1) -> [0, 255] -> uint8 (truncating), the
        reference's PIL round-trip (`main_oss.py:128-137`)."""
        with annotate("diffews.pipeline.decode"):
            img = self.vae.decode(x0, attn_impl=self.attn_impl,
                                  resnet_impl=self._decode_resnet_impl()).float().clamp(-1.0, 1.0)
            img = (img * 0.5 + 0.5) * 255.0
            return img.clamp(0.0, 255.0).to(torch.uint8)

    def _decode_depth(self, x0: torch.Tensor) -> torch.Tensor:
        """VAE decode -> channel mean -> clip(-1, 1) -> [0, 1], in JAX's
        order (`pipeline.py:574-579`): (B, H, W) float32."""
        with annotate("diffews.pipeline.decode"):
            img = self.vae.decode(x0, attn_impl=self.attn_impl,
                                  resnet_impl=self._decode_resnet_impl())
            return img.float().mean(dim=-1).clamp(-1.0, 1.0) * 0.5 + 0.5

    def _put(self, x) -> torch.Tensor:
        with annotate("diffews.pipeline.upload"):
            return to_device(torch.as_tensor(x), self.device)

    # -- public API ---------------------------------------------------------

    @torch.inference_mode()
    def predict_async(self, query, supports, support_masks, *, shot_mask=None,
                      denoising_steps: int = 1,
                      out_size: Optional[Tuple[int, int]] = None,
                      r_threshold: float = 0.0, threshold: float = 0.0,
                      mask_on_device: bool = False) -> "PendingSeg":
        """Queue an episode on the device and return a `PendingSeg`.

        query: (B, H, W, 3), supports: (B, N, H, W, 3), uint8 or [-1, 1]
        floats (NCHW is transposed); support_masks: (B, N, H, W) {0,1} or
        (B, N, H, W, 3) in [-1, 1]; shot_mask: optional (B, N) bool.
        mask_on_device: run the threshold on the device
        (`device_mask_from_seg`)."""
        with annotate("diffews.pipeline.predict"):
            x0 = self._episode_x0(query, supports, support_masks, shot_mask, denoising_steps)
            return self._pending(x0, out_size, r_threshold, threshold, mask_on_device)

    def _episode_x0(self, query, supports, support_masks, shot_mask,
                    denoising_steps) -> torch.Tensor:
        """The episode's x0 latent of this rank's rows (over "data") and
        shots (over "shots"), queued on the device."""
        query = _to_nhwc(np.asarray(query), 4)
        supports = _to_nhwc(np.asarray(supports), 5)
        masks = _masks_nhwc(support_masks)
        b, n = supports.shape[:2]
        if self.shot_mesh is not None:
            if n % self._n_shots:
                raise ValueError(f"the shots axis ({self._n_shots}) must divide n-shot "
                                 f"{n}; pad with shot_mask")
            if shot_mask is None:
                shot_mask = np.ones((b, n), bool)
        rs = mesh_lib.rows(b, self._n_data, self._data_rank, "episode batch")
        ss = mesh_lib.rows(n, self._n_shots, self._shot_rank, "n-shot")
        if shot_mask is not None:
            shot_mask = np.asarray(shot_mask, bool)[rs, ss]
        return self._x0_latent(
            self._put(query[rs]), self._put(supports[rs, ss]), self._put(masks[rs, ss]),
            self.empty_text_embed, self._put_shot_mask(shot_mask), denoising_steps,
            shot_group=self._shot_group)

    def _put_shot_mask(self, shot_mask) -> Optional[torch.Tensor]:
        return None if shot_mask is None else self._put(np.asarray(shot_mask, bool))

    def _pending(self, x0, out_size, r_threshold, threshold, mask_on_device) -> "PendingSeg":
        """Decode, gather the rows over "data", resize and (optionally)
        threshold on the device; nothing here waits for it (but a gather
        waits for the other ranks)."""
        img = self._decode_seg(x0)
        if self._data_group is not None:
            with annotate("diffews.pipeline.gather"):
                img = mesh_lib.all_gather_rows(img, self._data_group)
        with annotate("diffews.pipeline.threshold"):
            if out_size is not None and tuple(img.shape[1:3]) != tuple(out_size):
                img = nearest_resize(img, tuple(out_size))
            mask_dev = None
            if mask_on_device and (r_threshold > 0 or threshold > 0):
                rel = r_threshold > 0
                mask_dev = device_mask_from_seg(img, r_threshold if rel else threshold, rel)
        return PendingSeg(img, r_threshold, threshold, mask_device=mask_dev)

    @torch.inference_mode()
    def precompute_supports(self, supports, support_masks, *, shot_mask=None) -> SupportCache:
        """Encode a support set once for repeated-support serving: the
        dominant serving pattern (one annotated support set, a whole dataset
        or video of queries), which otherwise pays the support VAE encodes
        and the UNet's support stream for every query.

        Takes `predict`'s supports, support_masks and shot_mask (raw uint8
        images and 4-D {0,1} masks included).  Build with batch 1 to serve
        any query batch (the cache broadcasts), or with batch B to pair row
        for row with B-row query batches.  Queues the work and returns
        without waiting for the device.  Under a data `mesh` a batch-1 cache
        is built whole on every rank, a batch-B one row for row with the
        query batch; under `shot_mesh` it raises."""
        if self.shot_mesh is not None:
            raise NotImplementedError(
                "support-KV caching does not compose with shot-parallel "
                "serving (the cache would skip the cross-device softmax merge)")
        with annotate("diffews.pipeline.capture"):
            supports = _to_nhwc(np.asarray(supports), 5)
            masks = _masks_nhwc(support_masks)
            b = supports.shape[0]
            rs = (slice(None) if b == 1
                  else mesh_lib.rows(b, self._n_data, self._data_rank, "cache batch"))
            if shot_mask is not None:
                shot_mask = np.asarray(shot_mask, bool)[rs]
            entries = self._capture(self._put(supports[rs]), self._put(masks[rs]),
                                    self.empty_text_embed)
            return SupportCache(entries=entries, shot_mask=self._put_shot_mask(shot_mask),
                                n_shots=supports.shape[1], batch=b)

    @torch.inference_mode()
    def predict_cached_async(self, query, cache: SupportCache, *, denoising_steps: int = 1,
                             out_size: Optional[Tuple[int, int]] = None,
                             r_threshold: float = 0.0, threshold: float = 0.0,
                             mask_on_device: bool = False) -> "PendingSeg":
        """Queue queries against a `SupportCache` and return a `PendingSeg`.

        The same computation as `predict` with the cache's support set; the
        VAE and UNet run at another batch shape than the joint episode's, so
        the uint8 image may differ by one count at a few pixels in f32 (and
        by what bf16 rounding makes of that).  Only `denoising_steps=1`:
        the cache is captured at the one-step protocol's timestep.  Other
        arguments as in `predict_async`."""
        if denoising_steps != 1:
            raise NotImplementedError(
                "the support-KV cache is captured at the one-step protocol's "
                "fixed timestep; multi-step denoising would need a cache per "
                "timestep")
        if self.shot_mesh is not None:
            raise NotImplementedError("support-KV caching does not compose with "
                                      "shot-parallel serving")
        with annotate("diffews.pipeline.predict_cached"):
            query = _to_nhwc(np.asarray(query), 4)
            if cache.batch not in (1, query.shape[0]):
                raise ValueError(f"cache batch {cache.batch} must be 1 (broadcast) or match "
                                 f"the query batch {query.shape[0]}")
            rs = mesh_lib.rows(query.shape[0], self._n_data, self._data_rank, "query batch")
            x0 = self._x0_latent_cached(self._put(query[rs]), cache.entries, cache.shot_mask,
                                        self.empty_text_embed)
            return self._pending(x0, out_size, r_threshold, threshold, mask_on_device)

    def predict_cached(self, *args, **kw) -> SegOutput:
        """Blocking form of `predict_cached_async`."""
        return self.predict_cached_async(*args, **kw).result()

    def predict(self, *args, **kw) -> SegOutput:
        """Blocking form of `predict_async`.

          out_size: target (H, W) of the prediction (nearest resize, pipeline
            `:473-474`).
          r_threshold: relative threshold, mask = mean_RGB > r * max
            (`main_oss.py:131-137`).
          threshold: absolute threshold on mean_RGB in [0, 1]."""
        return self.predict_async(*args, **kw).result()

    @torch.inference_mode()
    def predict_depth_raw(self, query, supports, support_masks, *, shot_mask=None,
                          denoising_steps: int = 1,
                          out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The depth head's map before normalisation, queued on the device:
        (B, H, W) float32 in [0, 1], the whole batch on every rank of a
        data mesh, bilinear-resized to `out_size`.  Arguments as in
        `predict_async`."""
        with annotate("diffews.pipeline.predict"):
            x0 = self._episode_x0(query, supports, support_masks, shot_mask, denoising_steps)
            depth = self._decode_depth(x0)
            if self._data_group is not None:
                with annotate("diffews.pipeline.gather"):
                    depth = mesh_lib.all_gather_rows(depth, self._data_group)
            if out_size is not None and tuple(depth.shape[1:3]) != tuple(out_size):
                with annotate("diffews.pipeline.threshold"):
                    depth = bilinear_resize(depth[..., None], tuple(out_size))[..., 0]
            return depth

    def predict_depth(self, query, supports, support_masks, *, shot_mask=None,
                      denoising_steps: int = 1, out_size: Optional[Tuple[int, int]] = None,
                      colorize: bool = True, ensemble: Optional[np.ndarray] = None
                      ) -> DepthOutput:
        """Depth-mode prediction (the reference pipeline's mode="depth"):
        `predict_depth_raw`'s map, min-max normalised per row on the host
        (`pipeline:531-537`) and, with `colorize`, mapped through the
        Spectral colormap to uint8 (`:553-561`).  `ensemble` is accepted
        and not read, as in the JAX package."""
        d = self.predict_depth_raw(query, supports, support_masks, shot_mask=shot_mask,
                                   denoising_steps=denoising_steps, out_size=out_size)
        return depth_output(d.cpu().numpy(), colorize)  # the synchronisation point

    def __call__(self, input_images, denoising_steps: int = 1, ensemble_size: int = 1,
                 processing_res: int = 512, match_input_res: bool = True,
                 batch_size: int = 0, show_progress_bar: bool = False,
                 mode: str = "seg", rgb_paths=(), seed=None):
        """Reference-pipeline-compatible entry.  `input_images` = [support
        images (B*N, 3, H, W), query (B, 3, H, W), support masks (B*N, 3, H,
        W)] in [-1, 1] (`main_oss.py:106-123`).  mode "seg"/"semseg" returns
        a `SegOutput`, "depth" a `DepthOutput`; the single pass equals the
        reference's deterministic ensemble mean."""
        if mode not in ("seg", "semseg", "depth"):
            raise NotImplementedError(
                f"mode={mode!r}: supported modes are seg/semseg/depth (sr/normal/feature "
                "belong to the vestigial Marigold pipeline)")
        sup, qry, msk = (np.asarray(x) for x in input_images)
        b = qry.shape[0]
        n = sup.shape[0] // b
        sup = sup.reshape((b, n) + sup.shape[1:])
        msk = msk.reshape((b, n) + msk.shape[1:])
        out_size = tuple(qry.shape[-2:]) if match_input_res else None
        if mode == "depth":
            return self.predict_depth(qry, sup, msk, denoising_steps=denoising_steps,
                                      out_size=out_size)
        return self.predict(qry, sup, msk, denoising_steps=denoising_steps,
                            out_size=out_size)


def device_mask_from_seg(img_u8: torch.Tensor, thr: float, relative: bool) -> torch.Tensor:
    """The host threshold of `PendingSeg.result()` on the device, bit for
    bit: p = uint8/255 (true division), pm = ((p0+p1)+p2)/3 (numpy's sum
    order and true division, not `mean`), then pm > max(p)·thr (relative)
    or pm > thr.  Returns bool (B, H, W)."""
    p = _true_div(img_u8.float(), 255.0)
    pm = _true_div((p[..., 0] + p[..., 1]) + p[..., 2], 3.0)
    if relative:
        t = p.reshape(p.shape[0], -1).amax(dim=1) * thr
    else:
        t = torch.full((p.shape[0],), thr, dtype=torch.float32, device=p.device)
    return pm > t[:, None, None]


def depth_output(depth: np.ndarray, colorize: bool = True) -> DepthOutput:
    """The depth head's host part (JAX `pipeline.py:826-836`): each row of
    the (B, H, W) map min-max normalised in float32 (range floored at
    1e-8), and with `colorize` the Spectral colormap as uint8."""
    d = np.asarray(depth, dtype=np.float32)
    dmin = d.reshape(d.shape[0], -1).min(axis=1)[:, None, None]
    dmax = d.reshape(d.shape[0], -1).max(axis=1)[:, None, None]
    d = np.clip((d - dmin) / np.maximum(dmax - dmin, 1e-8), 0, 1)
    colored = None
    if colorize:
        colored = np.stack([
            (colorize_depth_maps(di, 0, 1)[0].transpose(1, 2, 0) * 255).astype(np.uint8)
            for di in d])
    return DepthOutput(depth_np=d, depth_colored=colored)


class PendingSeg:
    """In-flight segmentation prediction (device tensor + threshold params)."""

    def __init__(self, img_device: torch.Tensor, r_threshold: float,
                 threshold: float, mask_device: Optional[torch.Tensor] = None):
        self._img = img_device
        self._r_threshold = r_threshold
        self._threshold = threshold
        self._mask_dev = mask_device

    def result(self, need_seg: bool = True) -> SegOutput:
        with annotate("diffews.pending.result"):
            if self._mask_dev is not None:
                mask = self._mask_dev.cpu().numpy()
                seg = self._img.cpu().numpy() if need_seg else None
                return SegOutput(seg_colored=seg, mask=mask)
            seg = self._img.cpu().numpy()  # the synchronisation point
            mask = None
            if self._r_threshold > 0 or self._threshold > 0:
                # PIL round-trip: to_tensor divides the uint8 image by 255
                p = seg.astype(np.float32) / 255.0
                if self._r_threshold > 0:
                    thr = p.reshape(p.shape[0], -1).max(axis=1) * self._r_threshold
                    mask = p.mean(axis=-1) > thr[:, None, None]
                else:
                    mask = p.mean(axis=-1) > self._threshold
            return SegOutput(seg_colored=seg, mask=mask)


def _masks_nhwc(support_masks) -> np.ndarray:
    """Support masks as given: 4-D {0,1}, or 5-D 3-channel in NHWC."""
    support_masks = np.asarray(support_masks)
    if support_masks.ndim == 5:
        return _to_nhwc(support_masks, 5)
    if support_masks.ndim != 4:
        raise ValueError(
            f"support_masks must be 4-D {{0,1}} or 5-D 3-channel [-1,1]; "
            f"got shape {support_masks.shape}")
    return support_masks


def _to_nhwc(x: np.ndarray, ndim: int) -> np.ndarray:
    """Accept NCHW (reference convention) or NHWC; return NHWC."""
    if x.ndim != ndim:
        raise ValueError(f"expected {ndim}-D array, got {x.shape}")
    if x.shape[-3] == 3 and x.shape[-1] != 3:
        return np.moveaxis(x, -3, -1)
    return x
