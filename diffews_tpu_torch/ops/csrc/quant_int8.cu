// W8A8 int8 quantize and 3x3 convolution for Hopper (sm_90a), CUDA C++:
// the int8 VAE (`vae_impl="int8"`) and the int8 UNet linears' quantize.
//
// Stands for the XLA ops of `diffews_tpu/ops/quant.py`: no Pallas kernel is
// behind them (XLA lowers them on the TPU), but `F.conv2d` refuses int8
// CUDA tensors, so the port carries the int8 conv in a kernel of its own.
//
//  - quantize_s8 (`quant.py:322-328`, `:305-311`):
//        y = int8(clip(round_half_even(f32(x) / s_a), -127, 127))
//    over a contiguous f32 or bf16 tensor; s_a is one f32 value on the
//    device (a static calibrated scale, or the dynamic amax / 127 the
//    wrapper reduces on the device), so no host sync.  True division
//    (__fdiv_rn) and rintf: the plain version's torch ops, bit for bit.
//    Bound: bytes, 2 (bf16) or 4 (f32) in + 1 out per element.  One pass,
//    8 elements a thread with 16-byte loads, a grid-stride loop.
//
//  - conv2d_int8 (`quant.py:conv2d_int8`, `:331-340`): the implicit-GEMM
//    3x3 convolution
//        acc[b, r, c, n] = Σ_{dh, dw, k} xq[b, s·r - pt + dh, s·c - pl + dw, k] · w[n, dh, dw, k]
//    of int8 NHWC xq (B, H, W, Cin), Cin a multiple of 16, with int8 weights
//    (Cout, 3, 3, Cin), summed in int32 (exact: |acc| <= 127² · 9 · Cin <
//    2³¹), stride 1 or 2, top/left padding 0 or 1 (bottom/right follow
//    from Ho, Wo: a tap outside the image reads zero), any Cout.  The
//    epilogue is JAX's `y.astype(f32) * (w_scale * s_a) + bias`: two
//    __fmul_rn and one __fadd_rn in that order (nvcc would contract a*b+c
//    into an FMA), rounded once to the output dtype (f32 or bf16).
//
//    What bounds it on the H100: at the VAE's wide convs the tensor cores
//    (B12 512² 128 -> 128: 0.93 TOP, 0.47 ms at 1979 TOP/s int8, against
//    1.2 GB, 0.36 ms at 3.35 TB/s); at the heads (Cout 8 and 3) the bytes
//    (B4 512² 128 -> 3: 134 MB of codes in, 0.04 ms, against 0.002 ms of
//    products).
//
//    Design: conv2d_int8_wgmma_kernel, the persistent implicit-GEMM core of
//    `conv_common.cuh` (the bf16 fused conv's and downsample's) in int8:
//    a 16 x 16 output tile a work item; the chunk's weights for all nine
//    taps by one TMA box read in place from the (Cout, 3, 3, Cin) codes (no
//    repack); the patch by 16-byte cp.async copies in the no-swizzle
//    core-matrix layout (16 channels a row), zero-filled by coordinate
//    outside the image and past Cin, so each tap's window is one wgmma
//    descriptor; two consumer warpgroups issue a chunk's 9 x 2
//    m64nNk32.s32.s8.s8 products as one wgmma group, int32 accumulators
//    in registers; the ring runs on across items, so the producer fills the
//    next item's chunks during an epilogue.  A chunk is 32 channels (32
//    bytes, the bf16 core's byte geometry): the ring then holds 4 stages
//    at stride 1 (64-byte chunks would leave 2) and 3 at stride 2, whose
//    patch is 33 x 33.  Stride 2 keeps a patch row's even columns first and
//    its odd columns after them, as the downsample does.  For the wide
//    convs BN = 128 (one CTA an SM), the weights' L2 traffic per pixel
//    halved against a 128-pixel tile.  The heads (Cout <= 8) take BN = 8
//    (m64n8k32) at two CTAs an SM with a deeper ring: their products are
//    few, and the patch copies, which stream the codes once from memory,
//    are what they wait on.  The wide bf16 epilogue swaps channel pairs
//    across the 4 lanes of a quad (shuffles), so each lane writes 8
//    neighbouring channels of a pixel in one 16-byte store: a quarter of the
//    store instructions of a pair a lane, whole 32-byte sectors (f32 pairs
//    already fill a sector, and there the shuffles cost more than they
//    save).  No split K and no atomics: every run gives the same bits,
//    whatever the grid.
//
//    Measured on the H100 and not kept (PERF.md §6): 64-channel chunks in a
//    2-stage ring, and clusters of two CTAs taking a pair of tiles in
//    lockstep with each chunk's weights multicast to both; both were
//    slower at every wide shape.

#include "conv_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// quantize
// ---------------------------------------------------------------------------

constexpr int QTHREADS = 256;

__device__ __forceinline__ int8_t q8(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(QTHREADS)
quantize_s8_kernel(const T* __restrict__ x, const float* __restrict__ s_a,
                   int8_t* __restrict__ y, long long n) {
  const float s = *s_a;
  const long long step = (long long)gridDim.x * QTHREADS * 8;
  for (long long i = ((long long)blockIdx.x * QTHREADS + threadIdx.x) * 8; i < n; i += step) {
    if (i + 8 <= n) {
      float v[8];
      load8(x + i, v);
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= (uint32_t)(uint8_t)q8(v[j], s) << (8 * j);
        hi |= (uint32_t)(uint8_t)q8(v[j + 4], s) << (8 * j);
      }
      *reinterpret_cast<uint2*>(y + i) = make_uint2(lo, hi);
    } else {
      for (long long j = i; j < n; ++j) y[j] = q8(to_f32(x[j]), s);
    }
  }
}

// ---------------------------------------------------------------------------
// the int8 convolution
// ---------------------------------------------------------------------------

// The patch of a 16 x 16 output tile: 18 x 18 at stride 1; 33 x 33 at
// stride 2, a row's slot s holding column 2s (s < QEVEN) or 2(s - QEVEN) + 1.
template <int STRIDE, int BN>
struct Int8Cfg {
  static constexpr int QW = STRIDE == 1 ? conv::kTile + 2 : 2 * conv::kTile + 1;
  static constexpr int QEVEN = conv::kTile + 1;
  static constexpr uint32_t SBO = STRIDE * QW * 16;  // between a block's 8-row groups
  static constexpr int CTAS = BN == 8 ? 2 : 1;
  static constexpr int STAGES = BN == 8 ? (STRIDE == 1 ? 6 : 2) : (STRIDE == 1 ? 4 : 3);
  using C = conv::Cfg<32, BN, QW * QW, STAGES, 0, 1>;
};

// The producer's view of the patch: position (row, slot) is input pixel
// (r0 + row, c0 + column of the slot); zero outside the image and past Cin.
template <int STRIDE>
struct S8Fill {
  const int8_t* x;
  int H, W, Cin, b, r0, c0;

  __device__ __forceinline__ const void* src(int pos, int c) const {
    using K = Int8Cfg<STRIDE, 8>;
    const int row = pos / K::QW, slot = pos % K::QW;
    const int col = STRIDE == 1 ? slot : slot < K::QEVEN ? 2 * slot : 2 * (slot - K::QEVEN) + 1;
    const int hh = r0 + row, ww = c0 + col;
    if ((unsigned)hh >= (unsigned)H || (unsigned)ww >= (unsigned)W || c >= Cin) return nullptr;
    return x + (((size_t)b * H + hh) * W + ww) * Cin + c;
  }
};

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16_rn(a),
                                                              __float2bfloat16_rn(b));
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (second) p[1] = __float2bfloat16_rn(b);
  }
}

// A 4 x 4 transpose across the 4 lanes of a quad (t = lane % 4): on return
// w[s] holds what lane s held in w[t].  Two butterfly rounds, 4 shuffles.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {  // 2 x 2 blocks: lanes t and t ^ 2
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, (t & 2) ? w[u] : w[u + 2], 2);
    if (t & 2) w[u] = recv;
    else w[u + 2] = recv;
  }
#pragma unroll
  for (int u = 0; u < 4; u += 2) {  // within the blocks: lanes t and t ^ 1
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, (t & 1) ? w[u] : w[u + 1], 1);
    if (t & 1) w[u] = recv;
    else w[u + 1] = recv;
  }
}

// Channels n .. n + 7 (bf16) of one output pixel after the quad transpose,
// w[s] the pair 2s, 2s + 1: one 16-byte store when the row is aligned (Cout
// % 8 == 0) and all 8 are channels, else one store a channel below `valid`.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const uint32_t (&w)[4], int valid,
                                       bool vec) {
  if (vec && valid >= 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < valid) p[k] = __ushort_as_bfloat16((unsigned short)(w[k / 2] >> (16 * (k & 1))));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Persistent: CTA i walks work items i, i + gridDim.x, ... (image, 16 x 16
// output tile, N block; N blocks fastest).
template <int STRIDE, int BN, typename T>
__global__ void __launch_bounds__(conv::kThreads, Int8Cfg<STRIDE, BN>::CTAS)
conv2d_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const int8_t* __restrict__ x,
                         const float* __restrict__ w_scale, const float* __restrict__ s_a,
                         const float* __restrict__ bias, T* __restrict__ y, int H, int W,
                         int Cin, int Cout, int Ho, int Wo, int pad_t, int pad_l, int tiles_w,
                         int tiles_per_img, int n_blocks, int n_items) {
  using namespace hopper;
  using K = Int8Cfg<STRIDE, BN>;
  using C = typename K::C;
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
    if constexpr (BN > 8) setmaxnreg_dec<96>();
    conv::produce<C>(
        &tw, base, full, empty, nchunks, tid - 256, n_items, n_blocks, tiles_w, tiles_per_img,
        [&](const conv::Item& it) {
          return S8Fill<STRIDE>{x, H, W, Cin, it.b, STRIDE * it.h0 - pad_t,
                                STRIDE * it.w0 - pad_l};
        },
        [](const conv::Item&, uint32_t) {});
    return;
  }

  // consumer warpgroup c: output rows 8c .. 8c + 7 of the tile, blocks of
  // columns 0-7 and 8-15; row 8i + j of a block reads, at tap (dh, dw), the
  // patch row STRIDE * (8c + i) + dh and the slot of column STRIDE * j + dw
  if constexpr (BN > 8) setmaxnreg_inc<200>();
  const int c = tid / 128, wq = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  const float s = *s_a;
  const bool even = (Cout % 2) == 0;
  uint32_t q = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const conv::Item it = conv::item_of(i, n_blocks, tiles_w, tiles_per_img, BN);
    int32_t acc[2][BN / 2];
    conv::consume_item<C>(acc, base, full, empty, nchunks, K::SBO, lane, tid,
                          [c](int tap, int mb) {
                            const int dh = tap / 3, dw = tap % 3;
                            if constexpr (STRIDE == 1)
                              return (uint32_t)(((8 * c + dh) * K::QW + 8 * mb + dw) * 16);
                            const int slot0 = dw == 0 ? 0 : dw == 1 ? K::QEVEN : 1;
                            return (uint32_t)(((16 * c + dh) * K::QW + slot0 + 8 * mb) * 16);
                          }, conv::NoPrep{}, q);

    // epilogue: f32(acc) * (w_scale[n] * s_a) + bias[n], one rounding.
    // Accumulator row 16wq + g (+8) of block mb is output pixel
    // (8c + 2wq (+1), 8mb + g) of the tile; column 8j + 2t (+1) channel
    // n0 + 8j + 2t (+1).
    if constexpr (BN == 8 || std::is_same_v<T, float>) {  // a pair of channels a lane
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = it.n0 + 8 * j + 2 * t;
        if (n >= Cout) continue;
        const bool second = n + 1 < Cout;
        const float sc0 = __fmul_rn(__ldg(w_scale + n), s);
        const float sc1 = second ? __fmul_rn(__ldg(w_scale + n + 1), s) : 0.f;
        const float b0 = bias ? __ldg(bias + n) : 0.f;
        const float b1 = bias && second ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int ho = it.h0 + 8 * c + 2 * wq + h2, wo = it.w0 + 8 * mb + g;
            if (ho >= Ho || wo >= Wo) continue;
            float v0 = __fmul_rn(__int2float_rn(acc[mb][4 * j + 2 * h2]), sc0);
            float v1 = __fmul_rn(__int2float_rn(acc[mb][4 * j + 2 * h2 + 1]), sc1);
            if (bias) {
              v0 = __fadd_rn(v0, b0);
              v1 = __fadd_rn(v1, b1);
            }
            store2(y + (((size_t)it.b * Ho + ho) * Wo + wo) * Cout + n, v0, v1,
                   even && second, second);
          }
        }
      }
    } else {
      // bf16, four j at a time: a quad's lanes hold channel pairs 2t of
      // j .. j + 3; after the quad transpose lane t holds the 8 channels of
      // j + t, one 16-byte store (each pixel's 64 bytes written by a quad).
      const bool vec = (Cout % 8) == 0;
#pragma unroll
      for (int jg = 0; jg < BN / 32; ++jg) {
        float sc[4][2], bv[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = it.n0 + 8 * (4 * jg + u) + 2 * t + e;
            sc[u][e] = n < Cout ? __fmul_rn(__ldg(w_scale + n), s) : 0.f;
            bv[u][e] = n < Cout && bias ? __ldg(bias + n) : 0.f;
          }
        const int nq = it.n0 + 8 * (4 * jg + t);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            uint32_t w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int a = 4 * (4 * jg + u) + 2 * h2;
              float v0 = __fmul_rn(__int2float_rn(acc[mb][a]), sc[u][0]);
              float v1 = __fmul_rn(__int2float_rn(acc[mb][a + 1]), sc[u][1]);
              if (bias) {
                v0 = __fadd_rn(v0, bv[u][0]);
                v1 = __fadd_rn(v1, bv[u][1]);
              }
              w[u] = bf16_pair(v0, v1);
            }
            quad_transpose(w, t);
            const int ho = it.h0 + 8 * c + 2 * wq + h2, wo = it.w0 + 8 * mb + g;
            if (ho < Ho && wo < Wo && nq < Cout)
              store8(y + (((size_t)it.b * Ho + ho) * Wo + wo) * Cout + nq, w, Cout - nq, vec);
          }
        }
      }
    }
  }
}

template <int STRIDE, int BN, typename T>
cudaError_t launch_conv(const int8_t* x, const void* w, const float* w_scale, const float* s_a,
                        const float* bias, T* y, int B, int H, int W, int Cin, int Cout, int Ho,
                        int Wo, int pad_t, int pad_l, cudaStream_t stream) {
  using K = Int8Cfg<STRIDE, BN>;
  using C = typename K::C;
  const int tiles_w = (Wo + conv::kTile - 1) / conv::kTile;
  const int tiles_per_img = ((Ho + conv::kTile - 1) / conv::kTile) * tiles_w;
  const int n_blocks = (Cout + BN - 1) / BN;
  const long long n_items = (long long)B * tiles_per_img * n_blocks;
  if (n_items > 2147483647LL) return cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!conv::encode_weight_map_s8(&tw, w, Cin, Cout, C::BK, BN, conv::swizzle_of<C::SPAN>()))
    return cudaErrorInvalidValue;
  auto kernel = conv2d_int8_wgmma_kernel<STRIDE, BN, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<conv::persistent_grid(n_items, K::CTAS), conv::kThreads, C::SMEM, stream>>>(
      tw, x, w_scale, s_a, bias, y, H, W, Cin, Cout, Ho, Wo, pad_t, pad_l, tiles_w,
      tiles_per_img, n_blocks, (int)n_items);
  return cudaGetLastError();
}

// Cout <= 8 (the heads) takes the narrow N block.
template <typename T>
cudaError_t launch_conv_any(const int8_t* x, const void* w, const float* w_scale,
                            const float* s_a, const float* bias, T* y, int B, int H, int W,
                            int Cin, int Cout, int Ho, int Wo, int stride, int pad_t, int pad_l,
                            cudaStream_t st) {
  if (Cout <= 8)
    return stride == 1 ? launch_conv<1, 8, T>(x, w, w_scale, s_a, bias, y, B, H, W, Cin, Cout,
                                               Ho, Wo, pad_t, pad_l, st)
                       : launch_conv<2, 8, T>(x, w, w_scale, s_a, bias, y, B, H, W, Cin, Cout,
                                               Ho, Wo, pad_t, pad_l, st);
  return stride == 1 ? launch_conv<1, 128, T>(x, w, w_scale, s_a, bias, y, B, H, W, Cin, Cout,
                                               Ho, Wo, pad_t, pad_l, st)
                     : launch_conv<2, 128, T>(x, w, w_scale, s_a, bias, y, B, H, W, Cin, Cout,
                                               Ho, Wo, pad_t, pad_l, st);
}

}  // namespace

extern "C" int quantize_s8(const void* x, const void* s_a, void* y, long long n, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const long long want = (n + 8LL * QTHREADS - 1) / (8LL * QTHREADS);
  const int grid = (int)(want < 132 * 32 ? want : 132 * 32);
  const float* s = static_cast<const float*>(s_a);
  int8_t* out = static_cast<int8_t*>(y);
  if (dtype == 0)
    quantize_s8_kernel<float><<<grid, QTHREADS, 0, st>>>(static_cast<const float*>(x), s, out, n);
  else
    quantize_s8_kernel<__nv_bfloat16><<<grid, QTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s, out, n);
  return (int)cudaGetLastError();
}

// x: (B, H, W, Cin) int8 NHWC; w: (Cout, 3, 3, Cin) int8; w_scale: (Cout,)
// f32; s_a: one f32 on the device; bias: (Cout,) f32 or null; y: (B, Ho,
// Wo, Cout), dtype 0 = float32, 1 = bfloat16.  Every pointer 16-byte
// aligned.  Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int conv2d_int8(const void* x, const void* w, const void* w_scale, const void* s_a,
                           const void* bias, void* y, int B, int H, int W, int Cin, int Cout,
                           int Ho, int Wo, int stride, int pad_t, int pad_l, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || (Cin % 16) || Cout <= 0 || Ho <= 0 ||
      Wo <= 0 || (stride != 1 && stride != 2) || pad_t < 0 || pad_t > 1 || pad_l < 0 ||
      pad_l > 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W * Cin > (1LL << 40)) return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const float* ws = static_cast<const float*>(w_scale);
  const float* sp = static_cast<const float*>(s_a);
  const float* bp = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch_conv_any(xp, w, ws, sp, bp, static_cast<float*>(y), B, H, W, Cin, Cout,
                                Ho, Wo, stride, pad_t, pad_l, st);
  return (int)launch_conv_any(xp, w, ws, sp, bp, static_cast<__nv_bfloat16*>(y), B, H, W, Cin,
                              Cout, Ho, Wo, stride, pad_t, pad_l, st);
}

// The conv kernel's registers a thread at launch, dynamic shared memory and
// threads per CTA (bf16 out); which: 0 = stride 1 BN 128, 1 = stride 2 BN
// 128, 2 = stride 1 BN 8 (the heads), 3 = stride 2 BN 8.
extern "C" int conv2d_int8_info(int which, int* regs, int* smem, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err;
  using B16 = __nv_bfloat16;
  switch (which) {
    case 0: err = cudaFuncGetAttributes(&attr, conv2d_int8_wgmma_kernel<1, 128, B16>); *smem = Int8Cfg<1, 128>::C::SMEM; break;
    case 1: err = cudaFuncGetAttributes(&attr, conv2d_int8_wgmma_kernel<2, 128, B16>); *smem = Int8Cfg<2, 128>::C::SMEM; break;
    case 2: err = cudaFuncGetAttributes(&attr, conv2d_int8_wgmma_kernel<1, 8, B16>); *smem = Int8Cfg<1, 8>::C::SMEM; break;
    case 3: err = cudaFuncGetAttributes(&attr, conv2d_int8_wgmma_kernel<2, 8, B16>); *smem = Int8Cfg<2, 8>::C::SMEM; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *threads = conv::kThreads;
  return 0;
}
