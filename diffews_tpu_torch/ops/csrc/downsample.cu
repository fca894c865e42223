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
// What bounds it: an input pixel feeds 2.25 taps on average (9 in a
// stride-1 conv), so per FLOP this conv moves four times the activations:
// at 512² (B12, 128 -> 128, bf16) the memory bounds it (1.0 GB against 0.23
// TFLOP), at 256² C256 and 128² C512 the tensor cores.  The TPU kernel's
// pair-column reinterpret, its precomputed shifted operand and its padded
// row width are Mosaic layout work and have no counterpart here.
//
//  - down_wgmma_kernel (bf16): the implicit-GEMM core of `conv_common.cuh`
//    (TMA-fed weights, a cp.async-filled patch, two wgmma consumer
//    warpgroups) over a 16 x 16 tile of output pixels, whose 33 x 33 input
//    patch is copied with BK = 16 input channels a chunk, in a ring of
//    three stages; the copies arrive on the stage's barrier as they land.
//    The grid is persistent (one CTA per SM walks tiles and N blocks).
//    Copies are bounds-checked by coordinate (zero fill), so the padding
//    costs no padded copy of x and an image's bottom row never reads the
//    next image.  A patch row keeps its even columns first and its odd
//    columns after them: output columns c .. c + 7 then read 8 neighbouring
//    slots at every tap, so each tap's window is one wgmma descriptor.
//    BN = 128; a tile's N blocks are neighbouring work items, so they run
//    side by side and find the tile's patch in L2.
//  - down_f32_kernel (f32): FMAs on an 8 x 16 tile; a thread owns 8 pixels
//    x 4 channels.
//
// No atomics and no reduction across blocks: the output is the same bit for
// bit on every run.

#include "conv_common.cuh"

namespace {

constexpr int TH = 8, TW = 16;                    // f32 output tile: 8 rows x 16 columns
constexpr int PH = 2 * TH + 1, PW = 2 * TW + 1;   // its input patch
constexpr int NPOS = PH * PW;
constexpr int NTHREADS = 256;

// bf16: the 16 x 16 output tile's 33 x 33 input patch; slot s of a patch
// row holds column 2s (s < 17) or 2(s - 17) + 1
constexpr int QW = 2 * conv::kTile + 1, QEVEN = conv::kTile + 1;
using WCfg = conv::Cfg<16, 128, QW * QW, 3, 0>;

struct PatchFill {
  const __nv_bfloat16* x;
  int H, W, Cin, b, h0, w0;  // h0, w0: the tile's first output pixel

  __device__ __forceinline__ const void* src(int pos, int c) const {
    const int row = pos / QW, slot = pos % QW;
    const int col = slot < QEVEN ? 2 * slot : 2 * (slot - QEVEN) + 1;
    const int hh = 2 * h0 + row, ww = 2 * w0 + col;
    if (hh >= H || ww >= W || c >= Cin) return nullptr;
    return x + (((size_t)b * H + hh) * W + ww) * Cin + c;
  }
};

// Persistent: CTA i walks work items i, i + gridDim.x, ... (image, 16 x 16
// output tile, N block; N blocks fastest).
__global__ void __launch_bounds__(conv::kThreads, 1)
down_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H, int W,
                  int Cin, int Cout, int tiles_w, int tiles_per_img, int n_blocks, int n_items) {
  using namespace hopper;
  using C = WCfg;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = conv::smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x, lane = tid % 32;
  const int nchunks = (Cin + C::BK - 1) / C::BK;
  if (tid == 0) {
    conv::init_ring<C>(full, empty);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warpgroup
    setmaxnreg_dec<96>();
    conv::produce<C>(
        &tw, base, full, empty, nchunks, tid - 256, n_items, n_blocks, tiles_w, tiles_per_img,
        [&](const conv::Item& it) { return PatchFill{x, H, W, Cin, it.b, it.h0, it.w0}; },
        [](const conv::Item&, uint32_t) {});
    return;
  }

  // consumer warpgroup c: output rows 8c .. 8c + 7 (patch rows 16c + 2i +
  // dh), blocks of columns 0-7, 8-15; tap dw reads slots from dw's
  // column: 0 -> even slot c, 1 -> odd slot c, 2 -> even slot c + 1
  setmaxnreg_inc<200>();
  const int c = tid / 128, wq = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  const int H2 = H / 2, W2 = W / 2;
  const bool pair = (Cout % 2) == 0;
  uint32_t q = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const conv::Item it = conv::item_of(i, n_blocks, tiles_w, tiles_per_img, BN);
    float acc[2][BN / 2];
    conv::consume_item<C>(acc, base, full, empty, nchunks, 2 * QW * 16, lane, tid,
                          [c](int tap, int mb) {
                            const int dw = tap % 3;
                            const int slot0 = dw == 0 ? 0 : dw == 1 ? QEVEN : 1;
                            return (uint32_t)(((16 * c + tap / 3) * QW + slot0 + 8 * mb) * 16);
                          }, conv::NoPrep{}, q);

    // epilogue: + bias (f32), one rounding, store.  Accumulator row 16wq + g
    // (+8) of block mb is output pixel (8c + 2wq (+1), 8mb + g) of the tile.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = it.n0 + 8 * j + 2 * t;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int ho = it.h0 + 8 * c + 2 * wq + h2, wo = it.w0 + 8 * mb + g;
          if (ho >= H2 || wo >= W2) continue;
          const size_t p = (((size_t)it.b * H2 + ho) * W2 + wo) * Cout;
          const float v0 = acc[mb][4 * j + 2 * h2], v1 = acc[mb][4 * j + 2 * h2 + 1];
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

cudaError_t launch_wgmma(const void* x, const void* w, const float* bias, void* y, int B,
                         int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using C = WCfg;
  const int tiles_w = (W / 2 + conv::kTile - 1) / conv::kTile;
  const int tiles_per_img = ((H / 2 + conv::kTile - 1) / conv::kTile) * tiles_w;
  const int n_blocks = (Cout + C::BN - 1) / C::BN;
  const long long n_items = (long long)B * tiles_per_img * n_blocks;
  if (n_items > 2147483647LL) return cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!conv::encode_weight_map(&tw, w, Cin, Cout, C::BK, C::BN, conv::swizzle_of<C::SPAN>()))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(down_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  down_wgmma_kernel<<<conv::persistent_grid(n_items, 1), conv::kThreads, C::SMEM, stream>>>(
      tw, static_cast<const __nv_bfloat16*>(x), bias, static_cast<__nv_bfloat16*>(y), H, W, Cin,
      Cout, tiles_w, tiles_per_img, n_blocks, (int)n_items);
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
    return (int)launch_wgmma(x, w, bp, y, B, H, W, Cin, Cout, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's registers a thread at launch, dynamic shared memory and
// threads per CTA (which: 0, the only variant).
extern "C" int downsample_info(int which, int* regs, int* smem, int* threads) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, down_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = WCfg::SMEM;
  *threads = conv::kThreads;
  return 0;
}
