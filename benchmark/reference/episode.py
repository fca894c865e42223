"""The reference's DiffewS episode, support capture and cached query, and
what the program's set-up derives, worked out again: the empty-prompt
text embedding and the W8A8 calibration.

Everything here is float32 on whatever device the tensors live on, with
TF32 off (`plain_float32`).  Inputs are the benchmark's uint8 images and
{0, 1} masks, NHWC as users hand them over; outputs are the uint8
segmentation images and masks the program returns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as M


def plain_float32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Reference:
    """The three models' weights (float32 copies of the served values) and
    the configuration's sizes and options.  `bits` is the width of the
    W8A8 sites where the configuration quantizes (8), or the narrower
    width of a control."""

    def __init__(self, cfg: dict, weights: dict, device, bits: int = 8):
        self.cfg, self.device = cfg, torch.device(device)
        self.unet_cfg, self.vae_cfg, self.text_cfg = cfg["unet"], cfg["vae"], cfg["text"]
        self.unet = M.Net(weights["unet"])
        self.vae = M.Net(weights["vae"])
        with torch.no_grad():
            text = M.Net(weights["text"])
            ids = torch.tensor([[self.text_cfg["bos_token_id"], self.text_cfg["eos_token_id"]]],
                               device=self.device)
            self.context = M.clip_text(text, self.text_cfg, ids)       # (1, 2, D)
            if cfg["vae_impl"] == "int8":
                self.vae.quant = M.Quant("conv", bits)
                imgs = vae_calibration_images().to(self.device)
                M.vae_decode(self.vae, self.vae_cfg, M.vae_encode_mean(self.vae, self.vae_cfg, imgs))
                self.vae.quant = M.Quant("conv", bits, self.vae.quant.calibrated())
            if cfg["unet_int8"]:
                self.unet.quant = M.Quant("linear", bits)
                lat, ref = unet_calibration_latents(self.device)
                M.unet(self.unet, self.unet_cfg, lat, 1, self.context, ref=ref)
                self.unet.quant = M.Quant("linear", bits, self.unet.quant.calibrated())

    # -- the parts --------------------------------------------------------

    def encode(self, imgs: torch.Tensor, chunk: int = 4) -> torch.Tensor:
        return torch.cat([M.vae_encode_mean(self.vae, self.vae_cfg, c)
                          for c in imgs.split(chunk)])

    def decode_seg(self, x0: torch.Tensor, chunk: int = 4) -> torch.Tensor:
        """VAE decode, clip to [-1, 1], [0, 255], truncation to uint8: NHWC."""
        out = []
        for c in x0.split(chunk):
            img = M.vae_decode(self.vae, self.vae_cfg, c).clamp(-1.0, 1.0)
            img = ((img * 0.5 + 0.5) * 255.0).clamp(0.0, 255.0)
            out.append(torch.floor(img).to(torch.uint8).permute(0, 2, 3, 1))
        return torch.cat(out)

    def x0(self, v: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        """One DDIM step to x0 under v-prediction: √ᾱ·x − √(1−ᾱ)·v, with
        ᾱ_t = Π(1 − β) over steps 0..t; β = 1 gives x0 = −v."""
        s = self.cfg["scheduler"]
        abar = (1.0 - s["beta"]) ** (s["timestep"] + 1)
        return abar ** 0.5 * sample - (1.0 - abar) ** 0.5 * v

    def _unet(self, sample, **kw):
        return M.unet(self.unet, self.unet_cfg, sample, self.cfg["scheduler"]["timestep"],
                      self.context, **kw)

    # -- entry points ------------------------------------------------------

    @torch.no_grad()
    def episode(self, query, supports, masks) -> torch.Tensor:
        """query (B, H, W, 3), supports (B, N, H, W, 3) uint8, masks (B, N,
        H, W) {0, 1}: the (B, H, W, 3) uint8 segmentation images."""
        b, n = supports.shape[:2]
        q_lat = self.encode(image_in(query))
        s_lat = self.encode(image_in(supports.flatten(0, 1)))
        m_lat = self.encode(mask_in(masks.flatten(0, 1)))
        ref = torch.cat([s_lat, m_lat], dim=1)
        ref = ref.reshape((b, n) + tuple(ref.shape[1:]))
        return self.decode_seg(self.x0(self._unet(q_lat, ref=ref), q_lat))

    @torch.no_grad()
    def capture(self, supports, masks) -> list:
        """One support set (1, N, ...) through the support stream, beside a
        zero query row it never reads: each site's support K/V."""
        s_lat = self.encode(image_in(supports.flatten(0, 1)))
        m_lat = self.encode(mask_in(masks.flatten(0, 1)))
        ref = torch.cat([s_lat, m_lat], dim=1)[None]
        dummy = torch.zeros((1, self.unet_cfg["in_channels"]) + tuple(s_lat.shape[2:]),
                            device=s_lat.device)
        entries: list = []
        self._unet(dummy, ref=ref, capture=entries)
        return entries

    @torch.no_grad()
    def cached(self, query, entries) -> torch.Tensor:
        """Queries against a captured support set: uint8 images."""
        q_lat = self.encode(image_in(query))
        return self.decode_seg(self.x0(self._unet(q_lat, cache=entries), q_lat))


def image_in(u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., 3, H, W) float32 in [-1, 1]."""
    x = (u8.float() / 255.0 - 0.5) / 0.5
    return x.movedim(-1, -3).contiguous()


def mask_in(m: torch.Tensor) -> torch.Tensor:
    """(B, H, W) {0, 1} -> (B, 3, H, W) in [-1, 1]: the mask as an image."""
    x = m.float() * 2.0 - 1.0
    return x[:, None].expand(-1, 3, -1, -1).contiguous()


def threshold_mask(seg: np.ndarray, r_threshold: float) -> np.ndarray:
    """The protocol's relative threshold (DiffewS `main_oss.py`): p =
    seg / 255 in float32, the pixel's mean over RGB above r times the
    image's largest p.  seg (B, H, W, 3) uint8 -> (B, H, W) bool."""
    p = np.asarray(seg).astype(np.float32) / np.float32(255.0)
    thr = p.reshape(p.shape[0], -1).max(axis=1) * np.float32(r_threshold)
    return p.mean(axis=-1) > thr[:, None, None]


def vae_calibration_images(resolution: int = 256) -> torch.Tensor:
    """The configuration's W8A8 calibration batch: 2 x 16 x 16 x 3 uniform
    draws of numpy's default_rng(0), bilinearly upsampled (half-pixel
    centres), plus N(0, 0.08) noise of the next draws, clipped to [-1, 1].
    NCHW float32 on the CPU."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.uniform(-1.0, 1.0, (2, 16, 16, 3)).astype(np.float32))
    imgs = F.interpolate(base.permute(0, 3, 1, 2), size=(resolution, resolution),
                         mode="bilinear", align_corners=False)
    noise = torch.from_numpy(rng.normal(0, 0.08, (2, resolution, resolution, 3))
                             .astype(np.float32)).permute(0, 3, 1, 2)
    return torch.clamp(imgs + noise, -1.0, 1.0)


def unet_calibration_latents(device):
    """The UNet's calibration input: a standard-normal query latent (1, 32,
    32, 4) then support latent (1, 1, 32, 32, 8) from numpy's
    default_rng(0), at timestep 1: NCHW float32."""
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.normal(size=(1, 32, 32, 4))).float()
    ref = torch.from_numpy(rng.normal(size=(1, 1, 32, 32, 8))).float()
    return (lat.permute(0, 3, 1, 2).contiguous().to(device),
            ref.permute(0, 1, 4, 2, 3).contiguous().to(device))
