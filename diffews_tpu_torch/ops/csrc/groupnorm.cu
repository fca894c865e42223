// GroupNorm(+SiLU) for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of `diffews_tpu/ops/groupnorm.py`:
//
//   _stats_kernel  -> gn_stats:  s1[b, c] = Σ_hw x[b, hw, c],
//                                s2[b, c] = Σ_hw x[b, hw, c]²     (f32)
//   _apply_kernel  -> gn_apply:  y = act(x·A[b, c] + B[b, c])
//
// on contiguous NHWC x (B, H·W, C), f32 or bf16.  The group fold (channel
// sums -> group mean and rstd -> per-channel A and B in x's dtype) runs
// between the two in plain PyTorch on (B, C) tensors, as in the JAX package.
//
// Both are bound by bytes: the stats pass reads x once, the apply pass
// reads x and writes y once; neither does enough arithmetic per byte to
// matter on this card.  So each thread moves 16 bytes per access (8 bf16 or
// 4 f32 channels of one pixel; fewer when C or a pointer's alignment does
// not allow it), neighbouring threads read neighbouring channels of a
// pixel, and each pass is one read of x with no layout copy around it.
//
// gn_stats is deterministic: no atomics.  Block (slab, channel chunk, b)
// sums the rows of its slab of pixels into registers, reduces its rows
// through shared memory in a fixed order and writes one partial per
// channel; `stats::sum_partials_kernel` then adds the slabs in order.
// Slabs keep the grid a few waves deep even at B = 12, C = 128, where one
// block per (b, channel chunk) would fill a tenth of the card's 132 SMs.
//
// gn_apply rounds like its plain version (`x * A + B` as two torch ops,
// then F.silu): the product is rounded to x's dtype, then the sum, with no
// FMA, and SiLU is x / (1 + exp(-x)) in f32, rounded once to x's dtype.

#include "stats_common.cuh"

namespace {

using stats::from_float;
using stats::load_vec;
using stats::round_to;
using stats::store_vec;

// Block (bx, by): thread x owns VEC channels starting at channel
// (blockIdx.y * bx + x) * VEC, thread y every by-th pixel of the slab.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
gn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
                        int rows_per_slab) {
  __shared__ float red[2][256 * 8];
  const int slab = blockIdx.x, b = blockIdx.z, nslab = gridDim.x;
  const int bx = blockDim.x, by = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int col = (blockIdx.y * bx + tx) * VEC;
  const bool active = col < C;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (active) {
    const int r0 = slab * rows_per_slab, r1 = min(HW, r0 + rows_per_slab);
    const T* base = x + (size_t)b * HW * C + col;
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += by) {
      float v[VEC];
      load_vec<T, VEC>(base + (size_t)r * C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[i] += v[i];
        s2[i] += v[i] * v[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[0][(ty * bx + tx) * VEC + i] = s1[i];
    red[1][(ty * bx + tx) * VEC + i] = s2[i];
  }
  __syncthreads();
  if (ty == 0 && active) {
    float* out = part + ((size_t)b * nslab + slab) * 2 * C + col;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float t1 = 0.f, t2 = 0.f;
      for (int y = 0; y < by; ++y) {
        t1 += red[0][(y * bx + tx) * VEC + i];
        t2 += red[1][(y * bx + tx) * VEC + i];
      }
      out[i] = t1;
      out[C + i] = t2;
    }
  }
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(256)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ A, const T* __restrict__ Bc,
                T* __restrict__ y, long long nvec, long long hwc, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec; v += stride) {
    const long long e = v * VEC;
    const size_t ab = (size_t)(e / hwc) * C + (size_t)(e % C);
    float xv[VEC], av[VEC], bv[VEC], out[VEC];
    load_vec<T, VEC>(x + e, xv);
    load_vec<T, VEC>(A + ab, av);
    load_vec<T, VEC>(Bc + ab, bv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float p = round_to<T>(__fmul_rn(xv[i], av[i]));
      float o = round_to<T>(__fadd_rn(p, bv[i]));
      if (SILU) o = o / (1.0f + expf(-o));
      out[i] = o;
    }
    store_vec<T, VEC>(y + e, out);
  }
}

template <typename T, int VEC>
cudaError_t stats_launch(const void* x, float* part, float* s1, float* s2, int B, int HW,
                         int C, int rows_per_slab, int nslab, cudaStream_t stream) {
  const int nvec = C / VEC;
  const int bx = nvec < 32 ? nvec : 32;
  const dim3 block(bx, 256 / bx);
  const dim3 grid(nslab, (nvec + bx - 1) / bx, B);
  gn_stats_partial_kernel<T, VEC><<<grid, block, 0, stream>>>(static_cast<const T*>(x), part,
                                                              HW, C, rows_per_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stats::launch_sum_partials(part, s1, s2, B, nslab, C, stream);
}

template <typename T, int VEC>
cudaError_t apply_launch(const void* x, const void* A, const void* Bc, void* y, int B, int HW,
                         int C, int silu, cudaStream_t stream) {
  const long long nvec = (long long)B * HW * C / VEC;
  const long long want = (nvec + 255) / 256;
  const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
  const T *xp = static_cast<const T*>(x), *ap = static_cast<const T*>(A),
          *bp = static_cast<const T*>(Bc);
  T* yp = static_cast<T*>(y);
  if (silu)
    gn_apply_kernel<T, VEC, true><<<grid, 256, 0, stream>>>(xp, ap, bp, yp, nvec,
                                                            (long long)HW * C, C);
  else
    gn_apply_kernel<T, VEC, false><<<grid, 256, 0, stream>>>(xp, ap, bp, yp, nvec,
                                                             (long long)HW * C, C);
  return cudaGetLastError();
}

bool vec_ok(int dtype, int vec, int C) {
  if (vec <= 0 || C % vec) return false;
  return dtype == 0 ? (vec == 1 || vec == 2 || vec == 4)
                    : (vec == 1 || vec == 2 || vec == 4 || vec == 8);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: channels per access (divides C;
// the pointers are aligned to vec elements).  part: (B, nslab, 2, C) f32
// scratch; s1, s2: (B, C) f32.  Returns the CUDA error of the launches
// (0 = cudaSuccess); the kernels run asynchronously on `stream`.
extern "C" int gn_stats(const void* x, void* part, void* s1, void* s2, int B, int HW, int C,
                        int dtype, int vec, int rows_per_slab, int nslab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || !vec_ok(dtype, vec, C) ||
      rows_per_slab <= 0 || nslab <= 0 || (long long)rows_per_slab * nslab < HW ||
      (long long)rows_per_slab * (nslab - 1) >= HW || (C / vec + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  float *p = static_cast<float*>(part), *a = static_cast<float*>(s1),
        *b = static_cast<float*>(s2);
  if (dtype == 0) {
    switch (vec) {
      case 4: return (int)stats_launch<float, 4>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
      case 2: return (int)stats_launch<float, 2>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
      default: return (int)stats_launch<float, 1>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
    }
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    switch (vec) {
      case 8: return (int)stats_launch<bf, 8>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
      case 4: return (int)stats_launch<bf, 4>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
      case 2: return (int)stats_launch<bf, 2>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
      default: return (int)stats_launch<bf, 1>(x, p, a, b, B, HW, C, rows_per_slab, nslab, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// A, B: (B, C) in x's dtype.  silu: 0 = identity, 1 = SiLU.
extern "C" int gn_apply(const void* x, const void* A, const void* Bc, void* y, int B, int HW,
                        int C, int dtype, int vec, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || HW <= 0 || C <= 0 || !vec_ok(dtype, vec, C))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 4: return (int)apply_launch<float, 4>(x, A, Bc, y, B, HW, C, silu, s);
      case 2: return (int)apply_launch<float, 2>(x, A, Bc, y, B, HW, C, silu, s);
      default: return (int)apply_launch<float, 1>(x, A, Bc, y, B, HW, C, silu, s);
    }
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    switch (vec) {
      case 8: return (int)apply_launch<bf, 8>(x, A, Bc, y, B, HW, C, silu, s);
      case 4: return (int)apply_launch<bf, 4>(x, A, Bc, y, B, HW, C, silu, s);
      case 2: return (int)apply_launch<bf, 2>(x, A, Bc, y, B, HW, C, silu, s);
      default: return (int)apply_launch<bf, 1>(x, A, Bc, y, B, HW, C, silu, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
