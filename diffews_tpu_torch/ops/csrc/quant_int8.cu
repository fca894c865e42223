// W8A8 int8 quantize and 3x3 convolution for Hopper (sm_90a), CUDA C++:
// the int8 VAE (`vae_impl="int8"`) and the int8 UNet linears' quantize.
//
// Stands for the XLA ops of `diffews_tpu/ops/quant.py` (no Pallas kernel is
// behind them; XLA lowers them on the TPU):
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
//    epilogue is JAX's `y.astype(f32) * (w_scale * s_a) + bias` with no
//    contraction into an FMA (the _rn intrinsics; nvcc fuses a*b+c by
//    default), rounded once to the output dtype (f32 or bf16).
//    Bound: operations at the VAE's wide convs (B12 512² 128 -> 128: 0.93
//    TOP, 0.47 ms at 1979 TOPS, against 1.2 GB, 0.36 ms at 3.35 TB/s); bytes
//    at the conv_outs (Cout 3 and 8).
//    Design (a simple kernel that is right; a wgmma design is later work):
//    a CTA of 8 warps computes a 128-pixel x 128-channel output tile with
//    mma.sync m16n8k32 s8 (a warp: 64 x 32, 4 x 4 products per k-step); the
//    K loop walks the 9 taps x Cin in chunks of 32 channels; each chunk's
//    pixel rows (32 bytes) and weight rows land in shared memory by 16-byte
//    cp.async (zero fill outside the image, past Cin and past Cout) in a
//    3-stage ring; rows are padded to 48 bytes so the fragment loads hit
//    32 distinct banks.  No atomics, no split K: every run gives the same
//    bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int BM = 128, BN = 128, BK = 32;  // output pixels, channels; input channels a step
constexpr int ROW = 48;                     // shared-memory bytes per row (32 + 16 pad)
constexpr int STAGES = 3;
constexpr int CTHREADS = 256;
constexpr int TILE_BYTES = BM * ROW;        // == BN * ROW

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// Grid: (ceil(M / BM), ceil(Cout / BN)), M = B·Ho·Wo output pixels.
template <typename T>
__global__ void __launch_bounds__(CTHREADS)
conv2d_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ s_a,
                   const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
                   int Cout, int Ho, int Wo, int M, int stride, int pad_t, int pad_l) {
  __shared__ __align__(128) uint8_t smem[STAGES][2][TILE_BYTES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's copies: 16 bytes (half h) of pixel row `ar` and of
  // weight row `ar` (the same index: BM == BN)
  const int ar = tid >> 1, half = tid & 1;
  const int am = m0 + ar;
  int ab = 0, aiy = 0, aix = 0;
  if (am < M) {
    ab = am / (Ho * Wo);
    const int rem = am - ab * Ho * Wo;
    aiy = (rem / Wo) * stride - pad_t;
    aix = (rem % Wo) * stride - pad_l;
  }
  const int8_t* xb = x + (size_t)ab * H * W * Cin;
  const int bn = n0 + ar;
  const int8_t* wrow = w + (size_t)(bn < Cout ? bn : 0) * 9 * Cin;
  const uint32_t a_dst = smem_u32(&smem[0][0][ar * ROW + half * 16]);
  const uint32_t b_dst = smem_u32(&smem[0][1][ar * ROW + half * 16]);
  constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;

  const int nchunk = (Cin + BK - 1) / BK;
  const int nsteps = 9 * nchunk;

  auto load = [&](int step, int slot) {
    const int tap = step / nchunk, c = (step - tap * nchunk) * BK + half * 16;
    const int iy = aiy + tap / 3, ix = aix + tap % 3;
    const bool cin_ok = c < Cin;
    const bool a_ok = am < M && cin_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
    const int8_t* asrc = a_ok ? xb + ((size_t)iy * W + ix) * Cin + c : x;
    cp_async16(a_dst + slot * STAGE_BYTES, asrc, a_ok);
    const bool b_ok = bn < Cout && cin_ok;
    cp_async16(b_dst + slot * STAGE_BYTES, b_ok ? wrow + tap * Cin + c : w, b_ok);
  };

  // warp tile: 64 pixels (wm) x 32 channels (wn)
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the step's tiles landed; the slot refilled below is free
    const int next = step + STAGES - 1;
    if (next < nsteps) load(next, next % STAGES);
    cp_async_commit();

    const uint8_t* As = smem[step % STAGES][0];
    const uint8_t* Bs = smem[step % STAGES][1];
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t* r0 = As + (wm + i * 16 + g) * ROW + t4;
      const uint8_t* r8 = r0 + 8 * ROW;
      a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* r = Bs + (wn + j * 8 + g) * ROW + t4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(r);
      b[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
  }
  cp_async_wait<0>();

  // epilogue: f32(acc) * (w_scale[n] * s_a) + bias[n], one rounding
  const float s = *s_a;
  const bool even = (Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + (lane & 3) * 2;
    if (n >= Cout) continue;
    const bool second = n + 1 < Cout;
    const float sc0 = __fmul_rn(w_scale[n], s);
    const float sc1 = second ? __fmul_rn(w_scale[n + 1], s) : 0.f;
    const float b0 = bias ? bias[n] : 0.f, b1 = bias && second ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m >= M) continue;
        float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), sc0);
        float v1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sc1);
        if (bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        store2(y + (size_t)m * Cout + n, v0, v1, even && second, second);
      }
    }
  }
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

extern "C" int conv2d_int8(const void* x, const void* w, const void* w_scale, const void* s_a,
                           const void* bias, void* y, int B, int H, int W, int Cin, int Cout,
                           int Ho, int Wo, int stride, int pad_t, int pad_l, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || (Cin % 16) || Cout <= 0 || Ho <= 0 ||
      Wo <= 0 || (stride != 1 && stride != 2) || pad_t < 0 || pad_t > 1 || pad_l < 0 ||
      pad_l > 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * Ho * Wo;
  if (M > 2147483647LL || (long long)B * H * W * Cin > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* ws = static_cast<const float*>(w_scale);
  const float* sp = static_cast<const float*>(s_a);
  const float* bp = static_cast<const float*>(bias);
  if (dtype == 0)
    conv2d_int8_kernel<float><<<grid, CTHREADS, 0, st>>>(
        xp, wp, ws, sp, bp, static_cast<float*>(y), H, W, Cin, Cout, Ho, Wo, (int)M, stride,
        pad_t, pad_l);
  else
    conv2d_int8_kernel<__nv_bfloat16><<<grid, CTHREADS, 0, st>>>(
        xp, wp, ws, sp, bp, static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, Ho, Wo, (int)M,
        stride, pad_t, pad_l);
  return (int)cudaGetLastError();
}
