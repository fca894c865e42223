// Helpers shared by the GroupNorm and fused-resnet kernels: vector loads
// and stores of VEC elements (float or bf16) as one 2..16-byte access, the
// dtype's rounding, and the deterministic second pass that sums per-tile
// partial statistics.
//
// Both kernels reduce per-(b, c) sums over a whole image.  Blocks run in no
// order on Hopper and a float atomicAdd would make the sums depend on it, so
// every block writes its own partial sums to a scratch buffer laid out as
// (B, n_part, 2, C) f32 (Σ then Σ², per partial), and `sum_partials_kernel`
// adds them up in one fixed order.  The result is the same bit for bit on
// every run, and row b reads only its own partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stats {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the rounding a torch op with output dtype T applies.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// VEC consecutive elements at p (aligned to VEC * sizeof(T)) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  const R r = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_float(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(f[i]);
  *reinterpret_cast<R*>(p) = r;
}

// s1[b, c] = Σ_k part[b, k, 0, c], s2[b, c] = Σ_k part[b, k, 1, c].
// Block (32, 32), grid (ceil(C / 32), B): lane x owns a channel, row y sums
// the partials k = y, y + 32, ..., then row 0 adds the 32 row sums in
// order.  Launched by `launch_sum_partials`.
__global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ s1,
                    float* __restrict__ s2, int n_part, int C) {
  __shared__ float red[2][32][33];
  const int c = blockIdx.x * 32 + threadIdx.x, b = blockIdx.y;
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    const float* p = part + (size_t)b * n_part * 2 * C + c;
    for (int k = threadIdx.y; k < n_part; k += 32) {
      a1 += p[(size_t)k * 2 * C];
      a2 += p[(size_t)k * 2 * C + C];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = a1;
  red[1][threadIdx.y][threadIdx.x] = a2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < 32; ++y) {
      t1 += red[0][y][threadIdx.x];
      t2 += red[1][y][threadIdx.x];
    }
    s1[(size_t)b * C + c] = t1;
    s2[(size_t)b * C + c] = t2;
  }
}

inline cudaError_t launch_sum_partials(const float* part, float* s1, float* s2, int B,
                                       int n_part, int C, cudaStream_t stream) {
  sum_partials_kernel<<<dim3((C + 31) / 32, B), dim3(32, 32), 0, stream>>>(part, s1, s2,
                                                                          n_part, C);
  return cudaGetLastError();
}

}  // namespace stats
