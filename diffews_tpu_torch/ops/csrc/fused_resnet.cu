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
// What bounds it: at 512px (B12, 128 -> 128, bf16) the tensor cores, 0.93
// TFLOP against 2.4 GB of activations (bound 0.94 ms).  The TPU kernel's
// row tiling, sublane offset and roll trick are Mosaic layout work and have
// no counterpart here.
//
//  - conv_wgmma_kernel (bf16): the persistent implicit-GEMM core of
//    `conv_common.cuh` (TMA-fed weights, a cp.async-copied halo patch, two
//    wgmma consumer warpgroups, a 16 x 16 pixel tile), with BK = 16 input
//    channels a chunk in a ring of three stages.  The consumers transform
//    each chunk's 18 x 18 patch in place while the tensor cores run the
//    chunk before: affine + SiLU in f32 (SiLU through the hardware's tanh),
//    zero outside the image by coordinate (the copy's zero fill is x = 0,
//    and silu(sh) != 0), rounded to bf16, so the activation costs one pass
//    per element, not one per tap.  After an item's chunks the producer
//    copies the item's residual into shared memory; the epilogue rounds y
//    there (bias staged in shared memory too) and writes it out in 16-byte
//    stores.  BN = 128 for Cout > 8; BN = 8 (m64n8 products, two CTAs an
//    SM) for the VAE's Cout = 3 and 8 heads.
//  - conv_f32_kernel (f32): FMAs on an 8 x 16 tile; a thread owns 8 pixels
//    x 4 channels.
//
// The statistics: per 8 x 16 pixel tile (in the bf16 kernel, one consumer
// warpgroup's half of the 16 x 16 tile) each kernel reduces its valid
// pixels per channel (warp shuffles, then shared memory in a fixed order)
// into its own partial; `stats::sum_partials_kernel` adds a row's partials
// in order.  No atomics: the output and its statistics are the same bit for
// bit on every run, and do not depend on B.

#include "conv_common.cuh"
#include "flash_common.cuh"
#include "stats_common.cuh"

namespace {

constexpr int TH = 8, TW = 16;            // f32 tile and statistics partial: 8 x 16
constexpr int PH = TH + 2, PW = TW + 2;   // the f32 tile's halo patch
constexpr int NPOS = PH * PW;
constexpr int NTHREADS = 256;

constexpr int QW = conv::kTile + 2;       // bf16: the 16 x 16 tile's 18 x 18 halo patch

// bf16 kernel: BK = 16 input channels a chunk; the scratch after the ring
// holds the item's output tile, [256 pixels][BN channels] bf16 in rows of
// BN * 2 + 16 bytes (so a warp's epilogue writes hit 32 banks), into
// which the producer copies the residual, and the statistics exchange.
template <int BN>
struct FusedCfg {
  static constexpr int ROW = BN * 2 + 16;
  static constexpr int OUT_BYTES = conv::kTile * conv::kTile * ROW;
  static constexpr int RED_BYTES = 2 * 2 * 4 * BN * 4;  // [warpgroup][s1, s2][warp][BN] f32
  static constexpr int BIAS_BYTES = 2 * BN * 4;         // [warpgroup][BN] f32
  using C = conv::Cfg<16, BN, QW * QW, BN == 8 ? 4 : 3, OUT_BYTES + RED_BYTES + BIAS_BYTES>;
  // the heads' products are few: two CTAs an SM double the patch transforms
  static constexpr int CTAS = BN == 8 ? 2 : 1;
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// the affine + SiLU prologue of one input element, f32
__device__ __forceinline__ float act(float v, float a, float sh) {
  return silu(__fadd_rn(__fmul_rn(v, a), sh));
}

// The same in the bf16 kernel, whose activation is rounded to bf16:
// silu(u) = h + h tanh(h), h = u / 2, with the hardware's approximate tanh
// (relative error about 2^-11, under bf16's 2^-8).
__device__ __forceinline__ float act_fast(float v, float a, float sh) {
  const float h = 0.5f * __fadd_rn(__fmul_rn(v, a), sh);
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

// The producer's view of the halo patch: position pos = (row, col) of the
// 18 x 18 patch is pixel (h0 + row - 1, w0 + col - 1).
struct XFill {
  const __nv_bfloat16* x;
  int H, W, Cin, b, h0, w0;

  __device__ __forceinline__ const void* src(int pos, int c) const {
    const int hh = h0 + pos / QW - 1, ww = w0 + pos % QW - 1;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W || c >= Cin) return nullptr;
    return x + (((size_t)b * H + hh) * W + ww) * Cin + c;
  }
};

// The consumers' transform of a chunk's landed patch into the bf16
// activation, in place (thread ct of 256; 16 input channels a chunk, two
// 8-channel groups).  Outside the image and past Cin a slot keeps the
// copy's zero fill: the conv's padding (silu(sh) != 0, so x = 0 would not
// do).
struct ActPrep {
  static constexpr bool kActive = true;
  static constexpr int G = 2, ITEMS = G * QW * QW;
  const float *a, *sh;
  int H, W, Cin, b, h0, w0;

  // this thread's 8 channels of the affine for chunk k (zero past Cin)
  struct Coef {
    float a[8], s[8];
  };
  __device__ __forceinline__ Coef load(int k, int ct) const {
    Coef cf;
    const int c = k * 8 * G + (ct % G) * 8;
    if (c >= Cin) return cf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 av4 = *reinterpret_cast<const float4*>(a + (size_t)b * Cin + c + 4 * h);
      const float4 sv4 = *reinterpret_cast<const float4*>(sh + (size_t)b * Cin + c + 4 * h);
      cf.a[4 * h] = av4.x; cf.a[4 * h + 1] = av4.y; cf.a[4 * h + 2] = av4.z;
      cf.a[4 * h + 3] = av4.w;
      cf.s[4 * h] = sv4.x; cf.s[4 * h + 1] = sv4.y; cf.s[4 * h + 2] = sv4.z;
      cf.s[4 * h + 3] = sv4.w;
    }
    return cf;
  }

  __device__ __forceinline__ void operator()(uint8_t* patch, int k, int ct,
                                             const Coef& cf) const {
    const int grp = ct % G, c = k * 8 * G + grp * 8;
    if (c >= Cin) return;
    uint8_t* plane = patch + grp * (QW * QW * 16);
#pragma unroll
    for (int it = 0; it < (ITEMS + 255) / 256; ++it) {
      const int idx = ct + it * 256;
      if (idx >= ITEMS) break;
      const int pos = idx / G;
      const int hh = h0 + pos / QW - 1, ww = w0 + pos % QW - 1;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      uint4* slot = reinterpret_cast<uint4*>(plane + pos * 16);
      uint4 raw = *slot;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint4 packed;
      uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pk[j] = flash::pack_bf16(act_fast(__bfloat162float(e[2 * j]), cf.a[2 * j], cf.s[2 * j]),
                                 act_fast(__bfloat162float(e[2 * j + 1]), cf.a[2 * j + 1],
                                          cf.s[2 * j + 1]));
      *slot = packed;
    }
  }
};

// Persistent: CTA i walks work items i, i + gridDim.x, ... (image, 16 x 16
// tile, N block; N blocks fastest).
template <int BN>
__global__ void __launch_bounds__(conv::kThreads, FusedCfg<BN>::CTAS)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ a, const float* __restrict__ sh,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ part, int H, int W, int Cin,
                  int Cout, int tiles_w, int tiles_per_img, int n_blocks, int n_items,
                  int n_part) {
  using namespace hopper;
  using F = FusedCfg<BN>;
  using C = typename F::C;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = conv::smem_base(smem_raw);
  uint8_t* obuf = base + C::EXTRA_OFF;                                  // [256][ROW]
  float* red_all = reinterpret_cast<float*>(obuf + F::OUT_BYTES);      // [2][2][4][BN]
  float* bias_all = red_all + 2 * 2 * 4 * BN;                           // [2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* res_full = empty + C::STAGES;   // the item's residual is in obuf
  uint64_t* res_empty = res_full + 1;       // the consumers are done with obuf
  const int tid = threadIdx.x, lane = tid % 32;
  const int nchunks = (Cin + C::BK - 1) / C::BK;
  const bool vec = Cout % 8 == 0;  // rows of y and residual are 16-byte aligned
  if (tid == 0) {
    conv::init_ring<C>(full, empty);
    mbar_init(res_full, 128);
    mbar_init(res_empty, 8);
    fence_barrier_init();
  }
  __syncthreads();

  // registers move from the producer, which only copies, to the consumers'
  // accumulators (256 * 224 + 128 * 56 <= 65536; the heads' BN = 8 need none)
  if (tid >= 256) {  // producer warpgroup: the patch copies of every chunk, then the residual
    if constexpr (BN > 8) setmaxnreg_dec<56>();
    const int p = tid - 256;
    conv::produce<C>(
        &tw, base, full, empty, nchunks, p, n_items, n_blocks, tiles_w, tiles_per_img,
        [&](const conv::Item& it) { return XFill{x, H, W, Cin, it.b, it.h0, it.w0}; },
        [&](const conv::Item& it, uint32_t r) {
          if (res == nullptr) return;
          mbar_wait(res_empty, (r & 1) ^ 1);
          for (int e = p; e < conv::kTile * conv::kTile * (BN / 8); e += 128) {
            const int pix = e / (BN / 8), n = it.n0 + (e % (BN / 8)) * 8;
            const int hh = it.h0 + pix / conv::kTile, ww = it.w0 + pix % conv::kTile;
            if (hh >= H || ww >= W || n >= Cout) continue;
            const __nv_bfloat16* src = res + (((size_t)it.b * H + hh) * W + ww) * Cout + n;
            uint8_t* dst = obuf + pix * F::ROW + (n - it.n0) * 2;
            if (vec) {
              cp_async_16(dst, src, 16);
            } else {
              for (int k = 0; k < 8 && n + k < Cout; ++k)
                reinterpret_cast<__nv_bfloat16*>(dst)[k] = src[k];
            }
          }
          if (vec) cp_async_arrive_noinc(res_full);
          else mbar_arrive(res_full);
        });
    return;
  }

  // consumer warpgroup c: tile rows 8c .. 8c + 7, blocks of columns 0-7, 8-15
  if constexpr (BN > 8) setmaxnreg_inc<224>();
  const int c = tid / 128, wq = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  float* red = red_all + c * 2 * 4 * BN;
  float* bsm = bias_all + c * BN;  // this warpgroup's copy of the item's bias
  uint32_t q = 0, r = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++r) {
    const conv::Item it = conv::item_of(i, n_blocks, tiles_w, tiles_per_img, BN);
    float acc[2][BN / 2];
    // the item's bias, read in the epilogue (after its first barrier); the
    // last item's epilogue has passed its second barrier, so is done with it
    for (int nl = tid % 128; nl < BN; nl += 128)
      bsm[nl] = it.n0 + nl < Cout ? bias[it.n0 + nl] : 0.f;
    const ActPrep prep{a, sh, H, W, Cin, it.b, it.h0, it.w0};
    conv::consume_item<C>(acc, base, full, empty, nchunks, QW * 16, lane, tid,
                          [c](int tap, int mb) {
                            return (uint32_t)(((8 * c + tap / 3) * QW + 8 * mb + tap % 3) * 16);
                          }, prep, q);

    // epilogue: + bias (f32), round, + residual (bf16), round, into obuf;
    // the statistics of this warpgroup's 8 x 16 pixels; then obuf to y in
    // 16-byte stores.  Accumulator row 16wq + g (+8) of block mb is pixel
    // (8c + 2wq (+1), 8mb + g) of the tile.
    if (res) mbar_wait(res_full, r & 1);
    named_bar_sync(1 + c, 128);  // the last item's reads of obuf and red are done
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int nl = 8 * j + 2 * t, n = it.n0 + nl;
      const float b0 = bsm[nl], b1 = bsm[nl + 1];
      float c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = 8 * c + 2 * wq + h2, col = 8 * mb + g;
          __nv_bfloat162* slot =
              reinterpret_cast<__nv_bfloat162*>(obuf + (row * conv::kTile + col) * F::ROW + nl * 2);
          __nv_bfloat162 o = __floats2bfloat162_rn(acc[mb][4 * j + 2 * h2] + b0,
                                                   acc[mb][4 * j + 2 * h2 + 1] + b1);
          if (res) {
            const __nv_bfloat162 rv = *slot;
            o = __floats2bfloat162_rn(__low2float(o) + __low2float(rv),
                                      __high2float(o) + __high2float(rv));
          }
          *slot = o;
          if (it.h0 + row < H && it.w0 + col < W) {
            const float f0 = __low2float(o), f1 = __high2float(o);
            c1[0] += f0; c2[0] += f0 * f0;
            c1[1] += f1; c2[1] += f1 * f1;
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
          red[wq * BN + nl + e] = c1[e];
          red[(4 + wq) * BN + nl + e] = c2[e];
        }
      }
    }
    named_bar_sync(1 + c, 128);
    // this warpgroup's 128 pixels of obuf to y
    for (int e = tid % 128; e < 128 * (BN / 8); e += 128) {
      const int pix = 128 * c + e / (BN / 8), nl = (e % (BN / 8)) * 8, n = it.n0 + nl;
      const int hh = it.h0 + pix / conv::kTile, ww = it.w0 + pix % conv::kTile;
      if (hh >= H || ww >= W || n >= Cout) continue;
      const uint8_t* src = obuf + pix * F::ROW + nl * 2;
      __nv_bfloat16* dst = y + (((size_t)it.b * H + hh) * W + ww) * Cout + n;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && n + k < Cout; ++k)
          dst[k] = reinterpret_cast<const __nv_bfloat16*>(src)[k];
      }
    }
    if (res) {
      __syncwarp();
      if (lane == 0) mbar_arrive(res_empty);
    }
    // this half's row of 8 x 16 statistics tiles
    const int r8 = it.h0 / TH + c;
    if (r8 * TH < H) {
      float* out = part + ((size_t)it.b * n_part + r8 * tiles_w + it.w0 / TW) * 2 * Cout;
      for (int nl = tid % 128; nl < BN; nl += 128) {
        if (it.n0 + nl >= Cout) continue;
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          t1 += red[m * BN + nl];
          t2 += red[(4 + m) * BN + nl];
        }
        out[it.n0 + nl] = t1;
        out[Cout + it.n0 + nl] = t2;
      }
    }
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

template <int BN>
cudaError_t launch_wgmma(const void* x, const float* a, const float* sh, const void* w,
                         const float* bias, const void* res, void* y, float* part, int B, int H,
                         int W, int Cin, int Cout, int n_part, cudaStream_t stream) {
  using C = typename FusedCfg<BN>::C;
  const int tiles_w = (W + conv::kTile - 1) / conv::kTile;
  const int tiles_per_img = ((H + conv::kTile - 1) / conv::kTile) * tiles_w;
  const int n_blocks = (Cout + BN - 1) / BN;
  const long long n_items = (long long)B * tiles_per_img * n_blocks;
  if (n_items > 2147483647LL) return cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!conv::encode_weight_map(&tw, w, Cin, Cout, C::BK, BN, conv::swizzle_of<C::SPAN>()))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = conv::persistent_grid(n_items, FusedCfg<BN>::CTAS);
  conv_wgmma_kernel<BN><<<grid, conv::kThreads, C::SMEM, stream>>>(
      tw, static_cast<const __nv_bfloat16*>(x), a, sh, bias,
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(y), part, H, W, Cin,
      Cout, tiles_w, tiles_per_img, n_blocks, (int)n_items, n_part);
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

// The tile of the statistics partials (both kernels): `n_part` (the
// partials' second extent) must be ceil(H / 8) * ceil(W / 16).
extern "C" int fused_resnet_tile(int which) { return which == 0 ? TH : TW; }

// The bf16 kernel's registers a thread at launch, dynamic shared memory and
// threads per CTA; which: 0 = BN 128, 1 = the heads' BN 8.
extern "C" int fused_resnet_info(int which, int* regs, int* smem, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (which) {
    case 0: err = cudaFuncGetAttributes(&attr, conv_wgmma_kernel<128>); *smem = FusedCfg<128>::C::SMEM; break;
    case 1: err = cudaFuncGetAttributes(&attr, conv_wgmma_kernel<8>); *smem = FusedCfg<8>::C::SMEM; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *threads = conv::kThreads;
  return 0;
}

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
    if (Cout <= 8)
      err = launch_wgmma<8>(x, ap, sp, w, bp, res, y, pp, B, H, W, Cin, Cout, n_part, s);
    else
      err = launch_wgmma<128>(x, ap, sp, w, bp, res, y, pp, B, H, W, Cin, Cout, n_part, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)stats::launch_sum_partials(pp, static_cast<float*>(s1), static_cast<float*>(s2),
                                         B, n_part, Cout, s);
}
