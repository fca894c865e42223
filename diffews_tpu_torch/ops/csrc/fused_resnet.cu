// Fused GroupNorm-apply + SiLU + 3x3 conv (+ residual) for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU megakernel `diffews_tpu/ops/fused_resnet.py::
// _kernel` (driven by `_fwd_pallas`, exposed as `gn_silu_conv3x3`):
//
//   act = silu(x[b, h, w, c] · a[b, c] + sh[b, c])       (f32; 0 outside the image)
//   y   = conv3x3(act, w) + bias   (rounded to x's dtype)   (+ residual, in x's dtype)
//   s1[b, n] = Σ_hw y[b, hw, n],  s2[b, n] = Σ_hw y[b, hw, n]²   (f32, of the rounded y)
//
// on contiguous NHWC x (B, H, W, Cin), f32 or bf16; w comes repacked by the
// wrapper ([tap][Cout][Cin] for bf16, [tap][Cin][Cout] for f32), a/sh/bias
// are f32.  The conv's zero padding applies to the activation, not to x
// (silu(sh) != 0), and a tile's halo rows at an image boundary are padding,
// never the neighbouring image's rows.  The statistics are the ones the
// next GroupNorm of a resnet chain needs; they come from y after rounding
// and the residual, so a chained block sees exactly the sums a fresh
// `gn_stats` of y would give (up to f32 summation order).
//
// Design: an implicit GEMM with M = output pixels, N = Cout, K = 9·Cin.
// One block owns an 8 x 16 pixel tile of one image and BN output channels.
// Per chunk of input channels it loads the tile's (8+2) x (16+2) halo patch
// once, applies the affine + SiLU + padding mask while loading (so the
// activation costs one pass per element, not one per tap), rounds it to x's
// dtype and keeps it in shared memory with the chunk's weights for all nine
// taps; the nine taps then read shifted windows of the same patch.  At
// 512px (B12, 128 -> 128, bf16) the bound is the tensor cores: 0.93 TFLOP
// against 2.4 GB of activations.  This first version loads its tiles
// synchronously (no cp.async / TMA pipeline, no wgmma); the TPU kernel's
// row tiling, sublane offset and roll trick are Mosaic layout work and have
// no counterpart here.
//
//  - conv_mma_kernel (bf16): mma.sync m16n8k16 with f32 accumulation; a
//    warp's 16-row A fragment is one tile row of 16 pixels, read straight
//    from the shifted patch with ldmatrix; patch and weight rows are padded
//    to 80 bytes so ldmatrix reads no bank twice.  Two shapes: 8 warps as
//    4 (M) x 2 (N), BN = 128, for Cout >= 32; 8 warps along M, BN = 16, for
//    the VAE heads (Cout = 3 and 8).
//  - conv_f32_kernel (f32): FMAs; a thread owns 8 pixels x 4 channels.
//
// The statistics: each block reduces its valid pixels per channel (warp
// shuffles, then shared memory in a fixed order) into its own partial;
// `stats::sum_partials_kernel` adds a row's tiles in order.  No atomics:
// the output and its statistics are the same bit for bit on every run.

#include "flash_common.cuh"
#include "stats_common.cuh"

namespace {

using flash::ldmatrix_x4;
using flash::mma_bf16;

constexpr int TH = 8, TW = 16;            // output tile: 8 rows x 16 columns
constexpr int PH = TH + 2, PW = TW + 2;   // its halo patch
constexpr int NPOS = PH * PW;
constexpr int BK = 32;                    // input channels per chunk (bf16)
constexpr int PSTR = BK + 8;              // padded patch / weight row, elements
constexpr int NTHREADS = 256;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// the affine + SiLU prologue of one input element, f32
__device__ __forceinline__ float act(float v, float a, float sh) {
  return silu(__fadd_rn(__fmul_rn(v, a), sh));
}

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ sh, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part, int H, int W,
                int Cin, int Cout, int tiles_w, int tiles_per_img) {
  static_assert(WM * WN * 32 == NTHREADS && WM * MT == TH && NT % 2 == 0, "tile shape");
  constexpr int BN = WN * NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [NPOS][PSTR]
  __nv_bfloat16* wt = patch + NPOS * PSTR;                             // [9][BN][PSTR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / tiles_per_img, tile = blockIdx.x % tiles_per_img;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const float* ab = a + (size_t)b * Cin;
  const float* sb = sh + (size_t)b * Cin;
  for (int k0 = 0; k0 < Cin; k0 += BK) {
    __syncthreads();  // the previous chunk's products are done with smem
    // halo patch: activation, padding mask, bf16 rounding
    for (int i = tid; i < NPOS * (BK / 8); i += NTHREADS) {
      const int pos = i / (BK / 8), kv = i % (BK / 8);
      const int hh = h0 + pos / PW - 1, ww = w0 + pos % PW - 1, c = k0 + kv * 8;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < Cin) {
        float v[8];
        stats::load_vec<__nv_bfloat16, 8>(x + (((size_t)b * H + hh) * W + ww) * Cin + c, v);
        const float4 a0 = *reinterpret_cast<const float4*>(ab + c);
        const float4 a1 = *reinterpret_cast<const float4*>(ab + c + 4);
        const float4 s0 = *reinterpret_cast<const float4*>(sb + c);
        const float4 s1 = *reinterpret_cast<const float4*>(sb + c + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pk[j] = flash::pack_bf16(act(v[2 * j], av[2 * j], sv[2 * j]),
                                   act(v[2 * j + 1], av[2 * j + 1], sv[2 * j + 1]));
      }
      *reinterpret_cast<uint4*>(patch + pos * PSTR + kv * 8) = packed;
    }
    // the chunk's weights for all nine taps
    for (int i = tid; i < 9 * BN * (BK / 8); i += NTHREADS) {
      const int tap = i / (BN * (BK / 8)), rem = i % (BN * (BK / 8));
      const int n = rem / (BK / 8), kv = rem % (BK / 8), c = k0 + kv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + n < Cout && c < Cin)
        v = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cout + n0 + n) * Cin + c);
      *reinterpret_cast<uint4*>(wt + (tap * BN + n) * PSTR + kv * 8) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * MT + i;                                // tile row
          const int col = (lane & 7) + ((lane >> 3) & 1) * 8;       // tile column
          const int pos = (r + dh) * PW + col + dw;
          ldmatrix_x4(af[i], patch + pos * PSTR + ks * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          const int n = wn * NT * 8 + jp * 16 + (lane & 7) + (lane >> 4) * 8;
          uint32_t bfr[4];
          ldmatrix_x4(bfr, wt + (tap * BN + n) * PSTR + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][2 * jp], af[i], bfr[0], bfr[1]);
            mma_bf16(acc[i][2 * jp + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
  }

  // epilogue: + bias (f32), round, + residual (bf16), store, statistics
  __syncthreads();  // smem becomes the statistics scratch
  float* red = reinterpret_cast<float*>(smem_raw);  // [2][WM][BN]
  const bool pair = (Cout % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nl = wn * NT * 8 + j * 8 + 2 * t, n = n0 + nl;
    float c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int hh = h0 + wm * MT + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ww = w0 + g + half * 8;
        if (hh >= H || ww >= W) continue;
        const size_t p = (((size_t)b * H + hh) * W + ww) * Cout;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) v[e] = acc[i][j][half * 2 + e];
        if (pair && n + 1 < Cout) {
          __nv_bfloat162 o = __floats2bfloat162_rn(v[0] + bias[n], v[1] + bias[n + 1]);
          if (res) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + p + n);
            o = __floats2bfloat162_rn(__low2float(o) + __low2float(r),
                                      __high2float(o) + __high2float(r));
          }
          *reinterpret_cast<__nv_bfloat162*>(y + p + n) = o;
          const float f0 = __low2float(o), f1 = __high2float(o);
          c1[0] += f0; c2[0] += f0 * f0;
          c1[1] += f1; c2[1] += f1 * f1;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= Cout) continue;
            __nv_bfloat16 o = __float2bfloat16_rn(v[e] + bias[n + e]);
            if (res) o = __float2bfloat16_rn(__bfloat162float(o) + __bfloat162float(res[p + n + e]));
            y[p + n + e] = o;
            const float f = __bfloat162float(o);
            c1[e] += f; c2[e] += f * f;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        c1[e] += __shfl_xor_sync(0xffffffffu, c1[e], off);
        c2[e] += __shfl_xor_sync(0xffffffffu, c2[e], off);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[wm * BN + nl + e] = c1[e];
        red[(WM + wm) * BN + nl + e] = c2[e];
      }
    }
  }
  __syncthreads();
  for (int nl = tid; nl < BN; nl += NTHREADS) {
    if (n0 + nl >= Cout) continue;
    float t1 = 0.f, t2 = 0.f;
    for (int m = 0; m < WM; ++m) {
      t1 += red[m * BN + nl];
      t2 += red[(WM + m) * BN + nl];
    }
    float* out = part + ((size_t)b * tiles_per_img + tile) * 2 * Cout + n0 + nl;
    out[0] = t1;
    out[Cout] = t2;
  }
}

// f32: 256 threads; thread (tm, tn) owns pixels tm*8 .. tm*8+7 of the tile
// (half a tile row) and channels tn*4 .. tn*4+3 of the block's 64.
constexpr int FBN = 64, FBK = 16, FPSTR = FBK + 1;

__global__ void __launch_bounds__(NTHREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ sh, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ y, float* __restrict__ part, int H, int W, int Cin,
                int Cout, int tiles_w, int tiles_per_img) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wt = reinterpret_cast<float*>(smem_raw);   // [9][FBK][FBN]
  float* patch = wt + 9 * FBK * FBN;                // [NPOS][FPSTR]

  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const int th = tm / 2, tw0 = (tm % 2) * 8;
  const int b = blockIdx.x / tiles_per_img, tile = blockIdx.x % tiles_per_img;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * FBN;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  const float* ab = a + (size_t)b * Cin;
  const float* sb = sh + (size_t)b * Cin;
  for (int k0 = 0; k0 < Cin; k0 += FBK) {
    __syncthreads();
    for (int i = tid; i < NPOS * FBK; i += NTHREADS) {
      const int pos = i / FBK, k = i % FBK;
      const int hh = h0 + pos / PW - 1, ww = w0 + pos % PW - 1, c = k0 + k;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < Cin)
        v = act(x[(((size_t)b * H + hh) * W + ww) * Cin + c], ab[c], sb[c]);
      patch[pos * FPSTR + k] = v;
    }
    for (int i = tid; i < 9 * FBK * FBN; i += NTHREADS) {
      const int tap = i / (FBK * FBN), rem = i % (FBK * FBN);
      const int k = rem / FBN, n = rem % FBN, c = k0 + k;
      wt[i] = (c < Cin && n0 + n < Cout) ? w[((size_t)tap * Cin + c) * Cout + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
      const float* prow = patch + ((th + dh) * PW + tw0 + dw) * FPSTR;
#pragma unroll 4
      for (int k = 0; k < FBK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wt + (tap * FBK + k) * FBN + tn * 4);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float av = prow[p * FPSTR + k];
          acc[p][0] += av * wv.x;
          acc[p][1] += av * wv.y;
          acc[p][2] += av * wv.z;
          acc[p][3] += av * wv.w;
        }
      }
    }
  }

  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);   // [2][16][FBN]
  float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
  const int hh = h0 + th;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ww = w0 + tw0 + p;
    if (hh >= H || ww >= W) continue;
    const size_t pix = (((size_t)b * H + hh) * W + ww) * Cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tn * 4 + q;
      if (n >= Cout) continue;
      float o = acc[p][q] + bias[n];
      if (res) o = o + res[pix + n];
      y[pix + n] = o;
      c1[q] += o;
      c2[q] += o * o;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    red[tm * FBN + tn * 4 + q] = c1[q];
    red[(16 + tm) * FBN + tn * 4 + q] = c2[q];
  }
  __syncthreads();
  if (tid < FBN && n0 + tid < Cout) {
    float t1 = 0.f, t2 = 0.f;
    for (int m = 0; m < 16; ++m) {
      t1 += red[m * FBN + tid];
      t2 += red[(16 + m) * FBN + tid];
    }
    float* out = part + ((size_t)b * tiles_per_img + tile) * 2 * Cout + n0 + tid;
    out[0] = t1;
    out[Cout] = t2;
  }
}

template <int WM, int WN, int MT, int NT>
cudaError_t launch_mma(const void* x, const float* a, const float* sh, const void* w,
                       const float* bias, const void* res, void* y, float* part, int B, int H,
                       int W, int Cin, int Cout, int tiles_w, int tiles_per_img,
                       cudaStream_t stream) {
  constexpr int BN = WN * NT * 8;
  const size_t smem = (size_t)(NPOS + 9 * BN) * PSTR * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(conv_mma_kernel<WM, WN, MT, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * tiles_per_img, (Cout + BN - 1) / BN);
  conv_mma_kernel<WM, WN, MT, NT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), a, sh, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(y), part, H, W, Cin,
      Cout, tiles_w, tiles_per_img);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const float* a, const float* sh, const void* w,
                       const float* bias, const void* res, void* y, float* part, int B, int H,
                       int W, int Cin, int Cout, int tiles_w, int tiles_per_img,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(9 * FBK * FBN + NPOS * FPSTR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * tiles_per_img, (Cout + FBN - 1) / FBN);
  conv_f32_kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(x), a, sh, static_cast<const float*>(w), bias,
      static_cast<const float*>(res), static_cast<float*>(y), part, H, W, Cin, Cout, tiles_w,
      tiles_per_img);
  return cudaGetLastError();
}

}  // namespace

// The tile of the kernels: `n_part` (the partials' second extent) must be
// ceil(H / 8) * ceil(W / 16).
extern "C" int fused_resnet_tile(int which) { return which == 0 ? TH : TW; }

// dtype: 0 = float32, 1 = bfloat16.  x: (B, H, W, Cin) NHWC; a, sh: (B,
// Cin) f32; w: (9, Cout, Cin) for bf16, (9, Cin, Cout) for f32, in x's
// dtype; bias: (Cout,) f32; res: null or (B, H, W, Cout) in x's dtype; y:
// (B, H, W, Cout); part: (B, n_part, 2, Cout) f32 scratch; s1, s2: (B,
// Cout) f32.  Cin must be a multiple of 8 (bf16) and every pointer 16-byte
// aligned.  Returns the CUDA error of the launches (0 = cudaSuccess).
extern "C" int fused_gn_silu_conv3x3(const void* x, const void* a, const void* sh,
                                     const void* w, const void* bias, const void* res, void* y,
                                     void* part, void* s1, void* s2, int B, int H, int W,
                                     int Cin, int Cout, int n_part, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_img = ((H + TH - 1) / TH) * tiles_w;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || n_part != tiles_per_img ||
      (long long)B * tiles_per_img > 2147483647LL || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float *ap = static_cast<const float*>(a), *sp = static_cast<const float*>(sh),
              *bp = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 0) {
    if ((Cout + FBN - 1) / FBN > 65535) return (int)cudaErrorInvalidValue;
    err = launch_f32(x, ap, sp, w, bp, res, y, pp, B, H, W, Cin, Cout, tiles_w, tiles_per_img, s);
  } else if (dtype == 1) {
    if (Cin % 8) return (int)cudaErrorInvalidValue;
    if (Cout <= 16)
      err = launch_mma<8, 1, 1, 2>(x, ap, sp, w, bp, res, y, pp, B, H, W, Cin, Cout, tiles_w,
                                   tiles_per_img, s);
    else
      err = launch_mma<4, 2, 2, 8>(x, ap, sp, w, bp, res, y, pp, B, H, W, Cin, Cout, tiles_w,
                                   tiles_per_img, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)stats::launch_sum_partials(pp, static_cast<float*>(s1), static_cast<float*>(s2),
                                         B, n_part, Cout, s);
}
