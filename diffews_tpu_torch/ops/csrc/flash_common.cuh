// Helpers shared by the port's kernels (flash attention, the convs):
// bf16 tensor-core products (mma.sync m16n8k16, f32 accumulate), ldmatrix
// loads of 8x8 bf16 tiles from shared memory, bf16 packing, and reductions
// over the four lanes of a quad (the lanes that share an accumulator row).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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
