// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `diffews_tpu/ops/flash_attention.py::
// _flash_kernel` (driven by `_flash_forward`, exposed as `flash_attention`
// and `flash_attention_lse`).  Same function, not a block-by-block copy:
//
//   O[b, i, h, :] = sum_j softmax_j(scale * q_i . k_j | valid_j) * v_j
//   LSE[b, i, h]  = log sum_{valid j} exp(scale * q_i . k_j)      (f32)
//
// with an optional key mask `(B, Skv)` (uint8, nonzero = attend) shared by
// every head of a batch row.  Operands stay in the JAX package's (B, S, H,
// D) layout, contiguous; O is written in the input dtype, LSE as (B, Sq, H).
//
// Design.  One CTA per (q-tile, b*h); a loop over KV tiles inside the CTA
// takes the place of the TPU's sequential "arbitrary" grid axis, carrying
// the online-softmax state (running max m, sum l, f32 accumulator) in
// registers.  Three kernels share that shape:
//
//  - flash_fwd_mma_kernel, bf16 with d <= 64 (every UNet site): four warps
//    of 16 query rows each; per 64-key tile, S = Q K^T and O += P V run on
//    the tensor cores (mma.sync m16n8k16, f32 accumulate).  P is rounded
//    to bf16 for P V, as the TPU kernel does (AV_BF16); l sums the f32 P.
//    K and V tiles sit in shared memory with padded rows (no bank
//    conflicts); V's fragments come through ldmatrix.trans.
//  - flash_fwd_mma_wide_kernel, bf16 with d = 512 (the VAE mid block): the
//    same arithmetic, with eight warps sharing a 64-row q-tile because one
//    warp cannot hold 16 rows x 512 dims of O (comment at the kernel).
//  - flash_fwd_kernel, f32 at every d: plain f32 FMAs, so f32 inputs get
//    f32 products.  Each query row belongs to TPR consecutive lanes (TPR =
//    1 for d <= 64, 8 for d = 512); a lane holds D/TPR dims of q and of the
//    accumulator and reads K/V rows from shared memory (a broadcast for
//    TPR = 1, contiguous 16-byte chunks for TPR = 8).  Per chunk of 16 keys
//    it rescales the accumulator once.
//
// O is normalised at the end (acc / l) in all three.
//
// Masked keys get exactly zero weight whatever the tile order: the kernels
// set p = 0 for them instead of adding a large negative bias, so a tile of
// only masked keys cannot contribute before a later tile rescales it away.
// A row with no valid key at all writes O = 0 and LSE = -inf.
//
// What bounds it on this card: at the UNet's 64x64 level (d = 64, Sq =
// 4096, Skv = 4096*(1+n)) the work is about 4*Sq*Skv*d FLOPs per head
// against about 2*(Sq + 2*Skv)*d bytes, hundreds of FLOPs per byte, so it
// is compute-bound, at the bf16 tensor-core rate (989 TFLOP/s); the VAE's
// d = 512 more so.  The mma.sync kernels load each tile synchronously, so
// latency is hidden only by other warps and CTAs on the SM; the FMA kernel
// runs at the f32 rate (67 TFLOP/s) at best.  A wgmma/TMA pipeline is the
// later step; see PERF.md.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kChunk = 16;  // keys per online-softmax update

// D: head dim.  TPR: lanes per query row.  NT: threads per CTA.  BK: keys
// per shared-memory tile.
template <int D, int TPR, int NT, int BK>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Skv, float scale_log2) {
  constexpr int ROWS = NT / TPR;  // query rows per CTA
  constexpr int NC = D / (4 * TPR);  // float4 chunks of q/acc per lane
  static_assert(D % (4 * TPR) == 0, "head dim must split into float4 chunks");
  static_assert(BK % kChunk == 0, "KV tile must hold whole chunks");
  static_assert(32 % TPR == 0, "a row's lanes must sit in one warp");

  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* vs = ks + BK * D;                       // [BK][D]
  float* kbias = vs + BK * D;                    // [BK]: 0 or -inf

  const int tid = threadIdx.x;
  const int lane_c = tid % TPR;
  const int row = blockIdx.x * ROWS + tid / TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bool row_ok = row < Sq;

  // q, pre-scaled by scale*log2(e) so scores come out in log2 units
  float4 qr[NC];
  float4 acc[NC];
  const float* qrow = q + ((size_t)(b * Sq + (row_ok ? row : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float4 x = row_ok ? load4(qrow + 4 * (i * TPR + lane_c))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2,
                        x.w * scale_log2);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;  // running max (log2 units)
  float l = 0.f;        // running sum of 2^(s - m)

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BK * (D / 4); c += NT) {
      const int j = c / (D / 4);
      const int dd = (c % (D / 4)) * 4;
      const int key = kv0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < Skv) {
        const size_t off = ((size_t)(b * Skv + key) * H + h) * D + dd;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(ks + j * D + dd, kx);
      store4(vs + j * D + dd, vx);
    }
    for (int j = tid; j < BK; j += NT) {
      const int key = kv0 + j;
      const bool ok = key < Skv && (mask == nullptr || mask[(size_t)b * Skv + key] != 0);
      kbias[j] = ok ? 0.f : -INFINITY;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int dd = 4 * (i * TPR + lane_c);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(ks + (j0 + jj) * D + dd);
          s[jj] = fmaf(qr[i].x, kk.x, s[jj]);
          s[jj] = fmaf(qr[i].y, kk.y, s[jj]);
          s[jj] = fmaf(qr[i].z, kk.z, s[jj]);
          s[jj] = fmaf(qr[i].w, kk.w, s[jj]);
        }
      }
      if (TPR > 1) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off);
        }
      }
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] += kbias[j0 + jj];
        mx = fmaxf(mx, s[jj]);
      }
      // m == mx == -inf (no valid key yet): nothing to rescale
      const float alpha = (mx == -INFINITY) ? 1.f : exp2f(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
      }
      m = mx;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = (s[jj] == -INFINITY) ? 0.f : exp2f(s[jj] - mx);
        l += p;
        s[jj] = p;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int dd = 4 * (i * TPR + lane_c);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j0 + jj) * D + dd);
          acc[i].x = fmaf(s[jj], vv.x, acc[i].x);
          acc[i].y = fmaf(s[jj], vv.y, acc[i].y);
          acc[i].z = fmaf(s[jj], vv.z, acc[i].z);
          acc[i].w = fmaf(s[jj], vv.w, acc[i].w);
        }
      }
    }
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      store4(orow + 4 * (i * TPR + lane_c),
             make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv));
    }
    if (lane_c == 0)
      lse[(size_t)(b * Sq + row) * H + h] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
  }
}

// --- bf16 tensor-core kernels ----------------------------------------------

// With the fragment layouts of `flash_common.cuh`, the C fragments of two
// neighbouring 8-key score tiles are, packed to bf16, the A fragment of P
// for the next product.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2) {
  constexpr int BQ = 64;       // query rows per CTA, 16 per warp
  constexpr int BKV = 64;      // keys per tile
  constexpr int KS = D + 8;    // padded row stride of the K/V tiles (bf16)
  constexpr int NKT = BKV / 8;  // 8-key score tiles
  constexpr int NDT = D / 8;    // 8-dim output tiles
  constexpr int KD = D / 16;    // k-steps of Q K^T
  static_assert(D % 16 == 0 && NDT % 2 == 0, "head dim must be a multiple of 16");

  __shared__ __align__(16) __nv_bfloat16 ks[BKV * KS];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * KS];
  __shared__ float kbias[BKV];  // 0 or -inf

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  const size_t row_stride = (size_t)H * D;  // elements between sequence positions
  const __nv_bfloat16* qb = q + (size_t)b * Sq * row_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * row_stride + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * row_stride + (size_t)h * D;

  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kd * 16 + (i >> 1) * 8 + 2 * t;
      qa[kd][i] = row < Sq
          ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * row_stride + col) : 0u;
    }
  }
  float oacc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    constexpr int CH = D / 8;  // 16-byte chunks per key row
    for (int c = tid; c < BKV * CH; c += 128) {
      const int j = c / CH, dd = (c % CH) * 8;
      const int key = kv0 + j;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)key * row_stride + dd);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)key * row_stride + dd);
      }
      *reinterpret_cast<uint4*>(ks + j * KS + dd) = kx;
      *reinterpret_cast<uint4*>(vs + j * KS + dd) = vx;
    }
    for (int j = tid; j < BKV; j += 128) {
      const int key = kv0 + j;
      const bool ok = key < Skv && (mask == nullptr || mask[(size_t)b * Skv + key] != 0);
      kbias[j] = ok ? 0.f : -INFINITY;
    }
    __syncthreads();

    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * KS + kd * 16 + 2 * t;
        mma_bf16(s[n], qa[kd], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = kbias[n * 8 + 2 * t + e];
        s[n][e] = fmaf(s[n][e], scale_log2, bias);
        s[n][2 + e] = fmaf(s[n][2 + e], scale_log2, bias);
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // mx == -inf: no valid key yet in this row, nothing to rescale
    const float alpha0 = (mx0 == -INFINITY) ? 1.f : exp2f(m0 - mx0);
    const float alpha1 = (mx1 == -INFINITY) ? 1.f : exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      oacc[n][0] *= alpha0; oacc[n][1] *= alpha0;
      oacc[n][2] *= alpha1; oacc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = (s[n][e] == -INFINITY) ? 0.f : exp2f(s[n][e] - mx0);
        s[n][2 + e] = (s[n][2 + e] == -INFINITY) ? 0.f : exp2f(s[n][2 + e] - mx1);
        l0 += s[n][e];
        l1 += s[n][2 + e];
      }
    }

#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // ldmatrix.x4.trans: lanes 8i..8i+7 address the rows of 8x8 matrix i,
      // i = (keys +8 if odd) + (dims +8 if i >= 2); lane gets b0/b1 of two
      // neighbouring 8-dim output tiles
      const int key = kk * 16 + (lane & 8) + (lane & 7);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + key * KS + (n + (lane >> 4)) * 8);
        mma_bf16(oacc[n], pa, vf[0], vf[1]);
        mma_bf16(oacc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    if (row >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = o + ((size_t)b * Sq + row) * row_stride + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(oacc[n][2 * half] * inv, oacc[n][2 * half + 1] * inv);
    }
    if (t == 0)
      lse[((size_t)b * Sq + row) * H + h] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask,
                       void* o, float* lse, int B, int H, int Sq, int Skv,
                       float scale, cudaStream_t stream) {
  const dim3 grid((Sq + 63) / 64, B * H);
  flash_fwd_mma_kernel<D><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), lse, H, Sq, Skv, scale * kLog2e);
  return cudaGetLastError();
}

// bf16, d = 512 (the VAE mid attention).  A warp cannot hold 16 rows x 512
// dims of O (256 registers a lane), so eight warps share a 64-row q-tile:
// warp w owns rows 16*(w%4).. and, for S, keys 32*(w/4).. of each 64-key
// tile, for O, dims 256*(w/4)..  The two warps of a row block swap their
// partial row maxima through shared memory, so both keep the same running
// max; P goes through shared memory to the warp that owns the other dims.
// Q, K and V tiles (64 x 512 bf16 each) sit in 205 KB of dynamic shared
// memory: one CTA per SM.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_fwd_mma_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2) {
  constexpr int BQ = 64, BKV = 64, NT = 256;
  constexpr int KS = D + 8;       // padded row stride of the Q/K/V tiles (bf16)
  constexpr int PS = BKV + 8;     // padded row stride of the P tile
  constexpr int NKT = BKV / 16;   // 8-key score tiles of a warp (32 keys)
  constexpr int NDT = D / 16;     // 8-dim output tiles of a warp (D/2 dims)
  constexpr int KD = D / 16;      // k-steps of Q K^T
  constexpr int CH = D / 8;       // 16-byte chunks per row
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");

  extern __shared__ uint4 smem_w[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_w);
  __nv_bfloat16* ks = qs + BQ * KS;
  __nv_bfloat16* vs = ks + BKV * KS;
  __nv_bfloat16* ps = vs + BKV * KS;
  float* part = reinterpret_cast<float*>(ps + BQ * PS);  // [2][BQ] row partials
  float* kbias = part + 2 * BQ;                          // [BKV]: 0 or -inf

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = (warp & 3) * 16, hf = warp >> 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * row_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * row_stride + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * row_stride + (size_t)h * D;

  for (int c = tid; c < BQ * CH; c += NT) {
    const int i = c / CH, dd = (c % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + i < Sq) x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + i) * row_stride + dd);
    *reinterpret_cast<uint4*>(qs + i * KS + dd) = x;
  }

  float oacc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows rb+g, rb+g+8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums
  // ldmatrix.x4 (A operand): lanes 8i..8i+7 address rows of 8x8 matrix i =
  // (rows +8 if i odd) + (cols +8 if i >= 2)
  const int a_row = rb + (lane & 7) + (lane & 8);
  const int a_col = (lane >> 4) * 8;
  const int v_key = (lane & 8) + (lane & 7);

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // the previous tile (K, V, P, partials) is consumed
    for (int c = tid; c < BKV * CH; c += NT) {
      const int j = c / CH, dd = (c % CH) * 8;
      const int key = kv0 + j;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)key * row_stride + dd);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)key * row_stride + dd);
      }
      *reinterpret_cast<uint4*>(ks + j * KS + dd) = kx;
      *reinterpret_cast<uint4*>(vs + j * KS + dd) = vx;
    }
    for (int j = tid; j < BKV; j += NT) {
      const int key = kv0 + j;
      const bool ok = key < Skv && (mask == nullptr || mask[(size_t)b * Skv + key] != 0);
      kbias[j] = ok ? 0.f : -INFINITY;
    }
    __syncthreads();

    // S for rows rb.., keys 32*hf..
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qs + a_row * KS + kd * 16 + a_col);
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        const __nv_bfloat16* kp = ks + (hf * 32 + n * 8 + g) * KS + kd * 16 + 2 * t;
        mma_bf16(s[n], qa, *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = kbias[hf * 32 + n * 8 + 2 * t + e];
        s[n][e] = fmaf(s[n][e], scale_log2, bias);
        s[n][2 + e] = fmaf(s[n][2 + e], scale_log2, bias);
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t == 0) {
      part[hf * BQ + rb + g] = mx0;
      part[hf * BQ + rb + g + 8] = mx1;
    }
    __syncthreads();
    // the same expression in both warps of a row block: the same running max
    mx0 = fmaxf(m0, fmaxf(part[rb + g], part[BQ + rb + g]));
    mx1 = fmaxf(m1, fmaxf(part[rb + g + 8], part[BQ + rb + g + 8]));
    const float alpha0 = (mx0 == -INFINITY) ? 1.f : exp2f(m0 - mx0);
    const float alpha1 = (mx1 == -INFINITY) ? 1.f : exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      oacc[n][0] *= alpha0; oacc[n][1] *= alpha0;
      oacc[n][2] *= alpha1; oacc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const float p0 = (s[n][0] == -INFINITY) ? 0.f : exp2f(s[n][0] - mx0);
      const float p1 = (s[n][1] == -INFINITY) ? 0.f : exp2f(s[n][1] - mx0);
      const float p2 = (s[n][2] == -INFINITY) ? 0.f : exp2f(s[n][2] - mx1);
      const float p3 = (s[n][3] == -INFINITY) ? 0.f : exp2f(s[n][3] - mx1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      const int col = hf * 32 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + (rb + g) * PS + col) = pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + (rb + g + 8) * PS + col) = pack_bf16(p2, p3);
    }
    __syncthreads();  // P of both key halves is in place

    // O[rows rb.., dims (D/2)*hf..] += P V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, ps + a_row * PS + kk * 16 + a_col);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + v_key) * KS + hf * (D / 2) + (n + (lane >> 4)) * 8);
        mma_bf16(oacc[n], pa, vf[0], vf[1]);
        mma_bf16(oacc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // full row sums: the quad's lanes, then the other key half's warp (the
  // last tile's reads of the max partials ended before its P barrier)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (t == 0) {
    part[hf * BQ + rb + g] = l0;
    part[hf * BQ + rb + g + 8] = l1;
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = rb + g + 8 * half, row = q0 + i;
    if (row >= Sq) continue;
    const float l = part[i] + part[BQ + i], m = half ? m1 : m0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = o + ((size_t)b * Sq + row) * row_stride + (size_t)h * D + hf * (D / 2);
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(oacc[n][2 * half] * inv, oacc[n][2 * half + 1] * inv);
    }
    if (hf == 0 && t == 0)
      lse[((size_t)b * Sq + row) * H + h] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
  }
}

template <int D>
cudaError_t launch_mma_wide(const void* q, const void* k, const void* v, const void* mask,
                            void* o, float* lse, int B, int H, int Sq, int Skv,
                            float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(64 * (D + 8) * 3 + 64 * 72) * sizeof(__nv_bfloat16)
                      + (size_t)(2 * 64 + 64) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 63) / 64, B * H);
  flash_fwd_mma_wide_kernel<D><<<grid, 256, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), lse, H, Sq, Skv, scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int TPR, int NT, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* o, float* lse, int B, int H, int Sq, int Skv,
                   float scale, cudaStream_t stream) {
  constexpr int ROWS = NT / TPR;
  const size_t smem = (size_t)(2 * BK * D + BK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, TPR, NT, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  flash_fwd_kernel<D, TPR, NT, BK><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(o), lse, H, Sq, Skv,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* mask,
                         void* o, float* lse, int B, int H, int Sq, int Skv, int D,
                         float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, 1, 128, 64>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 32: return launch<32, 1, 128, 64>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 64: return launch<64, 1, 128, 64>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 512: return launch<512, 8, 256, 16>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* mask,
                          void* o, float* lse, int B, int H, int Sq, int Skv, int D,
                          float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 32: return launch_mma<32>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 64: return launch_mma<64>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 512: return launch_mma_wide<512>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask may be null.  Returns the CUDA
// error of the launch (0 = cudaSuccess); the kernel runs asynchronously on
// `stream`.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, void* lse, int B,
                                   int H, int Sq, int Skv, int D, int dtype,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, mask, o, l, B, H, Sq, Skv, D, scale, s);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, mask, o, l, B, H, Sq, Skv, D, scale, s);
  return (int)cudaErrorInvalidValue;
}
