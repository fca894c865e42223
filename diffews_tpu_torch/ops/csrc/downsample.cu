// 3x3 stride-2 convolution with (0,1),(0,1) zero padding + bias for Hopper
// (sm_90a), CUDA C++: the VAE encoder's Downsample2D.
//
// Replaces the Pallas TPU kernel `diffews_tpu/ops/downsample.py::_kernel`
// (driven by `_fwd_pallas`, exposed as `downsample_conv2x`):
//
//   y[b, r, c, n] = bias[n] + Σ_{dh, dw, k} x[b, 2r + dh, 2c + dw, k] · w[dh, dw, k, n]
//
// on contiguous NHWC x (B, H, W, Cin) with H and W even, f32 or bf16; x
// outside the image is zero, which only the bottom row (2r + 2 = H) and the
// right column (2c + 2 = W) ever are.  The sum is taken in f32, the bias is
// added in f32 and y (B, H/2, W/2, Cout) is rounded once to x's dtype.  w
// comes repacked by the wrapper ([tap][Cout][Cin] for bf16, [tap][Cin][Cout]
// for f32), bias is f32.
//
// Design: an implicit GEMM with M = output pixels, N = Cout, K = 9·Cin.  One
// block owns an 8 x 16 tile of output pixels of one image and BN output
// channels.  Per chunk of input channels it gathers the tile's 17 x 33 input
// patch into shared memory, bounds-checked against the image while loading
// (so the padding costs no padded copy of x, and an image's bottom row never
// reads the next image), together with the chunk's weights for all nine
// taps; the nine taps then read windows of that patch at stride 2.  An input
// pixel feeds 2.25 taps on average (9 in a stride-1 conv), so per FLOP this
// kernel moves four times the activations: at 512² (B12, 128 -> 128, bf16)
// the bound is the memory (1.0 GB against 0.23 TFLOP), at 256² C256 and
// 128² C512 the tensor cores.  The TPU kernel's pair-column reinterpret, its
// precomputed shifted operand and its padded row width are Mosaic layout
// work and have no counterpart here: a strided gather into shared memory is
// cheap on this card.  This first version loads its tiles synchronously (no
// cp.async / TMA pipeline, no wgmma).
//
//  - down_mma_kernel (bf16): mma.sync m16n8k16 with f32 accumulation; a
//    warp's 16-row A fragment is one tile row of 16 output pixels.  Their
//    input columns 2c + dw lie two patch columns apart, which ldmatrix would
//    read with bank conflicts, so a patch row keeps its even columns first
//    and its odd columns after them: every tap then reads 16 neighbouring
//    slots.  Patch and weight rows are padded to 48 bytes so ldmatrix reads
//    no bank twice.  8 warps as 4 (M) x 2 (N), BN = 128.
//  - down_f32_kernel (f32): FMAs; a thread owns 8 pixels x 4 channels.
//
// No atomics and no reduction across blocks: the output is the same bit for
// bit on every run.

#include "flash_common.cuh"

namespace {

using flash::ldmatrix_x4;
using flash::mma_bf16;

constexpr int TH = 8, TW = 16;                    // output tile: 8 rows x 16 columns
constexpr int PH = 2 * TH + 1, PW = 2 * TW + 1;   // its input patch
constexpr int NPOS = PH * PW;
constexpr int NEVEN = TW + 1;                     // even patch columns 0, 2, .., 32
constexpr int BK = 16;                            // input channels per chunk (bf16)
constexpr int PSTR = BK + 8;                      // padded patch / weight row, elements
constexpr int NTHREADS = 256;

// The slot of patch column pc in its row: even columns first, then odd.
__device__ __forceinline__ int col_slot(int pc) { return (pc & 1) * NEVEN + (pc >> 1); }

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
down_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H, int W,
                int Cin, int Cout, int tiles_w, int tiles_per_img) {
  static_assert(WM * WN * 32 == NTHREADS && WM * MT == TH && NT % 2 == 0, "tile shape");
  constexpr int BN = WN * NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [NPOS][PSTR]
  __nv_bfloat16* wt = patch + NPOS * PSTR;                             // [9][BN][PSTR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / tiles_per_img, tile = blockIdx.x % tiles_per_img;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;   // output pixels
  const int n0 = blockIdx.y * BN;
  const int H2 = H / 2, W2 = W / 2;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    __syncthreads();  // the previous chunk's products are done with smem
    // input patch: rows 2·h0 .. 2·h0 + 16, columns 2·w0 .. 2·w0 + 32; zero
    // below the image's last row and right of its last column
    for (int i = tid; i < NPOS * (BK / 8); i += NTHREADS) {
      const int pos = i / (BK / 8), kv = i % (BK / 8);
      const int pr = pos / PW, pc = pos % PW;
      const int hh = 2 * h0 + pr, ww = 2 * w0 + pc, c = k0 + kv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (hh < H && ww < W && c < Cin)
        v = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + hh) * W + ww) * Cin + c);
      *reinterpret_cast<uint4*>(patch + (pr * PW + col_slot(pc)) * PSTR + kv * 8) = v;
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
      const int slot0 = col_slot(dw);  // output column c reads slot0 + c
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * MT + i;                                // tile row
          const int col = (lane & 7) + ((lane >> 3) & 1) * 8;       // tile column
          const int pos = (2 * r + dh) * PW + slot0 + col;
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

  // epilogue: + bias (f32), one rounding, store
  const bool pair = (Cout % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * NT * 8 + j * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int ho = h0 + wm * MT + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wo = w0 + g + half * 8;
        if (ho >= H2 || wo >= W2) continue;
        const size_t p = (((size_t)b * H2 + ho) * W2 + wo) * Cout;
        const float v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        if (pair && n + 1 < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(y + p + n) =
              __floats2bfloat162_rn(v0 + bias[n], v1 + bias[n + 1]);
        } else {
          if (n < Cout) y[p + n] = __float2bfloat16_rn(v0 + bias[n]);
          if (n + 1 < Cout) y[p + n + 1] = __float2bfloat16_rn(v1 + bias[n + 1]);
        }
      }
    }
  }
}

// f32: 256 threads; thread (tm, tn) owns output pixels tm*8 .. tm*8+7 of the
// tile (half a tile row) and channels tn*4 .. tn*4+3 of the block's 64.
constexpr int FBN = 64, FBK = 16, FPSTR = FBK + 1;

__global__ void __launch_bounds__(NTHREADS)
down_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int H, int W, int Cin,
                int Cout, int tiles_w, int tiles_per_img) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wt = reinterpret_cast<float*>(smem_raw);   // [9][FBK][FBN]
  float* patch = wt + 9 * FBK * FBN;                // [NPOS][FPSTR]

  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const int th = tm / 2, tw0 = (tm % 2) * 8;
  const int b = blockIdx.x / tiles_per_img, tile = blockIdx.x % tiles_per_img;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * FBN;
  const int H2 = H / 2, W2 = W / 2;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += FBK) {
    __syncthreads();
    for (int i = tid; i < NPOS * FBK; i += NTHREADS) {
      const int pos = i / FBK, k = i % FBK;
      const int hh = 2 * h0 + pos / PW, ww = 2 * w0 + pos % PW, c = k0 + k;
      float v = 0.f;
      if (hh < H && ww < W && c < Cin) v = x[(((size_t)b * H + hh) * W + ww) * Cin + c];
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
      const float* prow = patch + ((2 * th + dh) * PW + 2 * tw0 + dw) * FPSTR;
#pragma unroll 4
      for (int k = 0; k < FBK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wt + (tap * FBK + k) * FBN + tn * 4);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float av = prow[p * 2 * FPSTR + k];
          acc[p][0] += av * wv.x;
          acc[p][1] += av * wv.y;
          acc[p][2] += av * wv.z;
          acc[p][3] += av * wv.w;
        }
      }
    }
  }

  const int ho = h0 + th;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int wo = w0 + tw0 + p;
    if (ho >= H2 || wo >= W2) continue;
    const size_t pix = (((size_t)b * H2 + ho) * W2 + wo) * Cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tn * 4 + q;
      if (n < Cout) y[pix + n] = acc[p][q] + bias[n];
    }
  }
}

template <int WM, int WN, int MT, int NT>
cudaError_t launch_mma(const void* x, const void* w, const float* bias, void* y, int B, int H,
                       int W, int Cin, int Cout, int tiles_w, int tiles_per_img,
                       cudaStream_t stream) {
  constexpr int BN = WN * NT * 8;
  const size_t smem = (size_t)(NPOS + 9 * BN) * PSTR * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(down_mma_kernel<WM, WN, MT, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * tiles_per_img, (Cout + BN - 1) / BN);
  down_mma_kernel<WM, WN, MT, NT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, tiles_w, tiles_per_img);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w, const float* bias, void* y, int B, int H,
                       int W, int Cin, int Cout, int tiles_w, int tiles_per_img,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(9 * FBK * FBN + NPOS * FPSTR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(down_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * tiles_per_img, (Cout + FBN - 1) / FBN);
  down_f32_kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias, static_cast<float*>(y),
      H, W, Cin, Cout, tiles_w, tiles_per_img);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x: (B, H, W, Cin) NHWC, H and W even;
// w: (9, Cout, Cin) for bf16, (9, Cin, Cout) for f32, in x's dtype; bias:
// (Cout,) f32; y: (B, H/2, W/2, Cout) in x's dtype.  Cin must be a multiple
// of 8 (bf16) and x and w 16-byte aligned.  Returns the CUDA error of the
// launch (0 = cudaSuccess).
extern "C" int downsample_conv2x(const void* x, const void* w, const void* bias, void* y, int B,
                                 int H, int W, int Cin, int Cout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || (H % 2) || (W % 2) || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W / 2 + TW - 1) / TW;
  const int tiles_per_img = ((H / 2 + TH - 1) / TH) * tiles_w;
  if ((long long)B * tiles_per_img > 2147483647LL) return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  if (dtype == 0) {
    if ((Cout + FBN - 1) / FBN > 65535) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(x, w, bp, y, B, H, W, Cin, Cout, tiles_w, tiles_per_img, s);
  }
  if (dtype == 1) {
    if (Cin % 8) return (int)cudaErrorInvalidValue;
    return (int)launch_mma<4, 2, 2, 8>(x, w, bp, y, B, H, W, Cin, Cout, tiles_w, tiles_per_img,
                                       s);
  }
  return (int)cudaErrorInvalidValue;
}
