// Multi-tensor clip_by_global_norm -> AdamW -> apply_if_finite for Hopper
// (sm_90a), CUDA C++: the train step's optimizer over every leaf in three
// launches.
//
// Replaces no Pallas kernel: the JAX package leaves the optax chain
// (`diffews_tpu/training/state.py`) to XLA's fusion.  The port's plain
// version (`training/optim.py`) runs some 25 torch ops a leaf, which over the
// SD-2.1 UNet's 688 leaves is about 21k launch calls a step.
//
// Bound by bytes.  The SD-2.1 UNet has 865.9 M float32 masters.  The apply
// pass reads p, g, nu (f32) and mu (bf16) and writes p, nu and mu: 24 bytes
// a parameter, 20.8 GB, 6.2 ms at 3.35 TB/s.  The norm pass reads g once
// more: 3.5 GB, 1.0 ms.  So each tensor is read and written once, 16 bytes a
// thread an access (8 for a bf16 moment); the norm is a pass of its own only
// because the clip needs the global norm before the first update.
//
// One chunk table covers every leaf: row (leaf, index, group) is elements
// [index·chunk, min((index+1)·chunk, numel)) of the leaf, and one block walks
// one chunk.  The leaf table (p, mu, nu, numel) is fixed for the life of the
// optimizer state; the gradients' pointers come each step in an array of
// their own.
//
//   adamw_norm_kernel:     per chunk, the f32 Σg² and a non-finite flag taken
//                          from isfinite(g) itself (a finite g whose square
//                          overflows is still finite for apply_if_finite);
//   adamw_finalise_kernel: one block adds the chunks' partials in a fixed
//                          order (in double) into the norm groups (one
//                          unsharded; under a sharded layout: replicated,
//                          "data", "model", both) and writes the group sums,
//                          sqrt(Σ of all groups) and the finite bit;
//   adamw_apply_kernel<M>: the update of `training/optim.py`, element by
//                          element, M the first moment's type (float or
//                          bf16).  It reads the step's device scalars (norm,
//                          clip trigger, apply bit, bias corrections, −lr)
//                          and writes nothing when the apply bit is false, so
//                          a skipped step leaves every byte as it was.
//
// Deterministic: no atomics; each block reduces in a fixed order and the
// finalise adds the partials in chunk order, so the same inputs give the
// same bits on every run.
//
// The apply rounds each operation as the plain version's torch ops do, one
// kernel an op: correctly rounded f32 multiply, divide, add and square root
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fsqrt_rn: no contraction to FMA, no
// fast math), the moment stored with __float2bfloat16_rn.  Given the same
// norm it is bit for bit the plain loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FINALISE_THREADS = 1024;
constexpr int GROUPS = 4;

struct Leaf {  // the int64 row (p, mu, nu, numel) of the leaf table
  float* p;
  void* mu;
  float* nu;
  long long numel;
};

struct Chunk {  // the int32 row (leaf, index, group, 0) of the chunk table
  int leaf, index, group, pad;
};

struct Scalars {  // the step's 0-d device tensors
  const float* gnorm;
  const bool* keep;
  const bool* apply;
  const float* bc1;
  const float* bc2;
  const float* neg_lr;
};

struct Hyper {  // the chain's constants, each the f32 that torch rounds it to
  float max_norm, c1, b1, c2, b2, eps, wd;
};

struct Step {
  float gnorm, bc1, bc2, neg_lr;
  bool keep;
  Hyper h;
};

__device__ __forceinline__ int chunk_len(const Chunk& c, long long numel, int chunk) {
  const long long left = numel - (long long)c.index * chunk;
  return (int)(left < chunk ? left : chunk);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// four consecutive elements as one access (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  uint2 r;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __float2bfloat16_rn(f[i]);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Σ of `v` over the block in a fixed order (butterfly in each warp, then
// the warps' sums in order by thread 0); the result is thread 0's.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
  return s;
}

__global__ void __launch_bounds__(THREADS)
adamw_norm_kernel(const Leaf* __restrict__ leaves, const Chunk* __restrict__ chunks,
                  const float* const* __restrict__ grads, int chunk,
                  float* __restrict__ partial, int* __restrict__ flags) {
  const Chunk c = chunks[blockIdx.x];
  const int len = chunk_len(c, leaves[c.leaf].numel, chunk);
  const float* g = grads[c.leaf] + (long long)c.index * chunk;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  bool bad = false;
  int done = 0;
  if (aligned(g, 16)) {
    const int nv = len >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      float v[4];
      load4(g + 4 * i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = __fmaf_rn(v[k], v[k], a[k]);
        bad |= !isfinite(v[k]);
      }
    }
    done = nv << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += THREADS) {
    const float v = g[i];
    a[0] = __fmaf_rn(v, v, a[0]);
    bad |= !isfinite(v);
  }
  const float s = block_sum((a[0] + a[1]) + (a[2] + a[3]));
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    flags[blockIdx.x] = any_bad;
  }
}

__global__ void __launch_bounds__(FINALISE_THREADS)
adamw_finalise_kernel(const Chunk* __restrict__ chunks, const float* __restrict__ partial,
                      const int* __restrict__ flags, int n_chunks, float* __restrict__ sums,
                      bool* __restrict__ finite) {
  __shared__ double red[GROUPS][FINALISE_THREADS];
  double acc[GROUPS] = {0.0, 0.0, 0.0, 0.0};
  int bad = 0;
  for (int i = threadIdx.x; i < n_chunks; i += FINALISE_THREADS) {
    const int grp = chunks[i].group;
    const double v = partial[i];
#pragma unroll
    for (int k = 0; k < GROUPS; ++k)
      if (k == grp) acc[k] += v;
    bad |= flags[i];
  }
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) red[k][threadIdx.x] = acc[k];
  bad = __syncthreads_or(bad);
  for (int s = FINALISE_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int k = 0; k < GROUPS; ++k) {
      sums[k] = (float)red[k][0];
      total += red[k][0];
    }
    sums[GROUPS] = __fsqrt_rn((float)total);
    *finite = !bad;
  }
}

// training/optim.py's update of one element, op for op in f32
__device__ __forceinline__ void adamw_element(float g, float& p, float& m, float& v,
                                              const Step& s) {
  if (!s.keep) g = __fmul_rn(__fdiv_rn(g, s.gnorm), s.h.max_norm);
  m = __fadd_rn(__fmul_rn(s.h.c1, g), __fmul_rn(s.h.b1, m));
  v = __fadd_rn(__fmul_rn(s.h.c2, __fmul_rn(g, g)), __fmul_rn(s.h.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.h.eps);
  const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den), __fmul_rn(s.h.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
adamw_apply_kernel(const Leaf* __restrict__ leaves, const Chunk* __restrict__ chunks,
                   const float* const* __restrict__ grads, int chunk, Scalars sc, Hyper h) {
  if (!*sc.apply) return;
  const Step s{*sc.gnorm, *sc.bc1, *sc.bc2, *sc.neg_lr, *sc.keep, h};
  const Chunk c = chunks[blockIdx.x];
  const Leaf leaf = leaves[c.leaf];
  const int len = chunk_len(c, leaf.numel, chunk);
  const long long start = (long long)c.index * chunk;
  float* p = leaf.p + start;
  M* mu = static_cast<M*>(leaf.mu) + start;
  float* nu = leaf.nu + start;
  const float* g = grads[c.leaf] + start;
  int done = 0;
  if (aligned(p, 16) && aligned(nu, 16) && aligned(g, 16) && aligned(mu, 4 * sizeof(M))) {
    const int nv = len >> 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      float gv[4], pv[4], mv[4], vv[4];
      load4(g + 4 * i, gv);
      load4(p + 4 * i, pv);
      load4(mu + 4 * i, mv);
      load4(nu + 4 * i, vv);
#pragma unroll
      for (int k = 0; k < 4; ++k) adamw_element(gv[k], pv[k], mv[k], vv[k], s);
      store4(p + 4 * i, pv);
      store4(mu + 4 * i, mv);
      store4(nu + 4 * i, vv);
    }
    done = nv << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += THREADS) {
    float pv = p[i], mv = to_float(mu[i]), vv = nu[i];
    adamw_element(g[i], pv, mv, vv, s);
    p[i] = pv;
    from_float(mv, mu + i);
    nu[i] = vv;
  }
}

}  // namespace

// leaves: (n_leaves, 4) int64 rows (p, mu, nu, numel); chunks: (n_chunks, 4)
// int32 rows (leaf, index, group, 0); grads: n_leaves float pointers;
// partial: n_chunks f32, flags: n_chunks int32 scratch.  Returns the CUDA
// error of the launch (0 = cudaSuccess); it runs asynchronously on `stream`.
extern "C" int adamw_norm(const void* leaves, const void* chunks, const void* grads,
                          int n_chunks, int chunk, void* partial, void* flags, void* stream) {
  if (n_chunks < 0 || chunk <= 0 || chunk % 4) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  adamw_norm_kernel<<<n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Chunk*>(chunks),
      static_cast<const float* const*>(grads), chunk, static_cast<float*>(partial),
      static_cast<int*>(flags));
  return (int)cudaGetLastError();
}

// sums: 5 f32 (the four groups' Σg², then sqrt of their total); finite: one
// bool (no chunk flagged).
extern "C" int adamw_finalise(const void* chunks, const void* partial, const void* flags,
                              int n_chunks, void* sums, void* finite, void* stream) {
  if (n_chunks < 0) return (int)cudaErrorInvalidValue;
  adamw_finalise_kernel<<<1, FINALISE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Chunk*>(chunks), static_cast<const float*>(partial),
      static_cast<const int*>(flags), n_chunks, static_cast<float*>(sums),
      static_cast<bool*>(finite));
  return (int)cudaGetLastError();
}

// mu_dtype: 0 = float32, 1 = bfloat16.  gnorm, bc1, bc2, neg_lr: 0-d f32 and
// keep, apply: 0-d bool device tensors.  The floats: max_grad_norm, 1 − b1,
// b1 (bf16-rounded for a bf16 moment), 1 − b2, b2, eps, weight decay.
extern "C" int adamw_apply(const void* leaves, const void* chunks, const void* grads,
                           int n_chunks, int chunk, int mu_dtype, const void* gnorm,
                           const void* keep, const void* apply, const void* bc1,
                           const void* bc2, const void* neg_lr, float max_norm, float c1,
                           float b1, float c2, float b2, float eps, float wd, void* stream) {
  if (n_chunks < 0 || chunk <= 0 || chunk % 4 || (mu_dtype != 0 && mu_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  const Scalars sc{static_cast<const float*>(gnorm), static_cast<const bool*>(keep),
                   static_cast<const bool*>(apply), static_cast<const float*>(bc1),
                   static_cast<const float*>(bc2), static_cast<const float*>(neg_lr)};
  const Hyper h{max_norm, c1, b1, c2, b2, eps, wd};
  const Leaf* l = static_cast<const Leaf*>(leaves);
  const Chunk* c = static_cast<const Chunk*>(chunks);
  const float* const* g = static_cast<const float* const*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_dtype == 0)
    adamw_apply_kernel<float><<<n_chunks, THREADS, 0, s>>>(l, c, g, chunk, sc, h);
  else
    adamw_apply_kernel<__nv_bfloat16><<<n_chunks, THREADS, 0, s>>>(l, c, g, chunk, sc, h);
  return (int)cudaGetLastError();
}
