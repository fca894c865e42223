// Helpers shared by the port's kernels (flash attention, the fused conv):
// bf16 packing, reductions over the four lanes of a quad (the lanes that
// share an accumulator row), 16-byte f32 loads and stores, and the fragment
// layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), which the register
// A operand of a wgmma ("rs") shares:
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8), a2 (row g, cols +8),
//            a3 (row g+8, cols +8);
//   B 16x8:  b0 (rows 2t..2t+1, col g), b1 (rows +8);
//   C 16x8:  c0..c1 (row g, cols 2t..2t+1), c2..c3 (row g+8).
// So the C fragments of two neighbouring 8-column tiles are, packed to
// bf16, the A fragment of a 16-wide k-step of the next product.
//
// This header is part of every source that includes it: `ops/_build.py`
// hashes it with each source, so an edited header rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

}  // namespace flash
