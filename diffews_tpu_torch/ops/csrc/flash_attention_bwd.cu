// Flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of `diffews_tpu/ops/flash_attention.py`
// that `_flash_backward` launches for `flash_attention`'s custom VJP:
//
//   _bwd_dq_kernel   ->  flash_bwd_dq_mma_kernel (bf16), flash_bwd_dq_kernel (f32)
//   _bwd_dkv_kernel  ->  flash_bwd_dkv_mma_kernel (bf16), flash_bwd_dkv_kernel (f32)
//
// They compute what the TPU kernels compute.  With s = scale * q_i . k_j,
// p_ij = exp(s_ij - LSE_i) (the forward's saved f32 log-sum-exp), dp_ij =
// g_i . v_j, delta_i = rowsum(O_i * g_i) (computed outside, as on the TPU)
// and ds_ij = p_ij * (dp_ij - delta_i):
//
//   dQ_i = scale * sum_j ds_ij k_j      dK_j = scale * sum_i ds_ij q_i
//   dV_j = sum_i p_ij g_i
//
// with f32 accumulation and outputs in the input dtype.  Masking follows the
// forward: a masked key gets p = 0 exactly (not exp of a -1e30 bias), so
// masked keys get dK = dV = 0 exactly; a row with no valid key (LSE = -inf)
// gets dQ = 0 and adds nothing to dK/dV.  Operands keep the (B, S, H, D)
// layout; LSE and delta are (B, Sq, H) f32; the key mask is (B, Skv) uint8.
//
// Design.  The TPU's two-pass split stays, because it needs no atomics:
// every output element is written by one thread, so gradients are
// deterministic.  The TPU grid axis that carried the f32 accumulator in
// VMEM scratch (sequential "arbitrary" steps) becomes a loop inside the CTA
// with the accumulator in registers:
//  - dq: one CTA per (64-row q-tile, b*h), looping over 64-key tiles;
//  - dkv: one CTA per (64-key tile, b*h), looping over 64-row q-tiles.  A
//    CTA whose keys are all masked (padded shots) writes zeros and stops.
// bf16 (d <= 64) runs every product on the tensor cores with the forward's
// fragment scheme: the Q/G (dq) or K/V (dkv) rows of a warp sit in A
// fragments; S and dP come out as C fragments, which packed to bf16 are the
// A fragments of dS (and P) for the next product; the transposed operands
// (K for dQ = dS K, G and Q for dV = P^T G and dK = dS^T Q) come from
// row-major shared-memory tiles through ldmatrix.trans.  P and dS are
// rounded to bf16 for those products, as the forward rounds P.  f32 runs on
// the FMA pipes, a row on TPR lanes.
//
// What bounds it on this card: per head the work is 6*Sq*Skv*d (dq) and
// 8*Sq*Skv*d (dkv) FLOPs against about 4*(Sq + Skv)*d bytes, hundreds of
// FLOPs per byte at the UNet's shapes, so both are compute-bound, at the
// bf16 tensor-core rate (989 TFLOP/s) or the f32 rate (67 TFLOP/s).  Tiles
// are loaded synchronously and S, dP and dS are recomputed in both passes;
// a one-pass FA2 form with wgmma/TMA is the later step (see PERF.md).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kChunk = 8;  // f32 kernels: keys (dq) or queries (dkv) per register block

// --- f32 kernels (FMA) -------------------------------------------------------

// dQ for f32.  Each query row belongs to TPR consecutive lanes, each holding
// D/TPR dims of q, g and the accumulator; K/V tiles of 64 keys are read
// from shared memory.
template <int D, int TPR>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, float* __restrict__ dq, int H,
                    int Sq, int Skv, float scale, float scale_log2) {
  constexpr int NT = 128, BK = 64;
  constexpr int ROWS = NT / TPR;
  constexpr int NC = D / (4 * TPR);  // float4 chunks per lane
  static_assert(D % (4 * TPR) == 0, "head dim must split into float4 chunks");
  static_assert(BK % kChunk == 0, "KV tile must hold whole chunks");

  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ float kval[BK];  // 1 = valid key

  const int tid = threadIdx.x;
  const int lane_c = tid % TPR;
  const int row = blockIdx.x * ROWS + tid / TPR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool row_ok = row < Sq;
  const size_t ridx = (size_t)(b * Sq + (row_ok ? row : 0)) * H + h;

  float4 qr[NC], gr[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int dd = 4 * (i * TPR + lane_c);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = row_ok ? load4(q + ridx * D + dd) : z;
    gr[i] = row_ok ? load4(g + ridx * D + dd) : z;
    acc[i] = z;
  }
  // rows past Sq and rows with no valid key (LSE = -inf) contribute nothing
  const float lse2 = row_ok ? lse[ridx] * kLog2e : -INFINITY;
  const float dl = row_ok ? delta[ridx] : 0.f;
  const bool live = lse2 != -INFINITY;

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BK * (D / 4); c += NT) {
      const int j = c / (D / 4), dd = (c % (D / 4)) * 4, key = kv0 + j;
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
      kval[j] = (key < Skv && (mask == nullptr || mask[(size_t)b * Skv + key] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int dd = 4 * (i * TPR + lane_c);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kk = load4(ks + (j0 + jj) * D + dd);
          const float4 vv = load4(vs + (j0 + jj) * D + dd);
          s[jj] = fmaf(qr[i].x, kk.x, s[jj]);
          s[jj] = fmaf(qr[i].y, kk.y, s[jj]);
          s[jj] = fmaf(qr[i].z, kk.z, s[jj]);
          s[jj] = fmaf(qr[i].w, kk.w, s[jj]);
          dp[jj] = fmaf(gr[i].x, vv.x, dp[jj]);
          dp[jj] = fmaf(gr[i].y, vv.y, dp[jj]);
          dp[jj] = fmaf(gr[i].z, vv.z, dp[jj]);
          dp[jj] = fmaf(gr[i].w, vv.w, dp[jj]);
        }
      }
      if (TPR > 1) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1) {
            s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off);
            dp[jj] += __shfl_xor_sync(0xffffffffu, dp[jj], off);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = (live && kval[j0 + jj] != 0.f) ? exp2f(fmaf(s[jj], scale_log2, -lse2)) : 0.f;
        s[jj] = p * (dp[jj] - dl);  // ds
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int dd = 4 * (i * TPR + lane_c);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kk = load4(ks + (j0 + jj) * D + dd);
          acc[i].x = fmaf(s[jj], kk.x, acc[i].x);
          acc[i].y = fmaf(s[jj], kk.y, acc[i].y);
          acc[i].z = fmaf(s[jj], kk.z, acc[i].z);
          acc[i].w = fmaf(s[jj], kk.w, acc[i].w);
        }
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      store4(dq + ridx * D + 4 * (i * TPR + lane_c),
             make_float4(acc[i].x * scale, acc[i].y * scale, acc[i].z * scale, acc[i].w * scale));
    }
  }
}

// dK and dV for f32.  Each key row belongs to TPR consecutive lanes, each
// holding D/TPR dims of k, v and both accumulators; Q/G tiles of 64 rows
// (with their LSE and delta) are read from shared memory.
template <int D, int TPR>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ mask, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Skv, float scale,
                     float scale_log2) {
  constexpr int NT = 128, BQ = 64;
  constexpr int ROWS = NT / TPR;
  constexpr int NC = D / (4 * TPR);
  static_assert(D % (4 * TPR) == 0, "head dim must split into float4 chunks");
  static_assert(BQ % kChunk == 0, "q tile must hold whole chunks");

  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float gs[BQ * D];
  __shared__ float lse_s[BQ];  // log2 units; -inf for rows past Sq
  __shared__ float dl_s[BQ];

  const int tid = threadIdx.x;
  const int lane_c = tid % TPR;
  const int key = blockIdx.x * ROWS + tid / TPR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool in_range = key < Skv;
  const bool key_ok = in_range && (mask == nullptr || mask[(size_t)b * Skv + key] != 0);
  const size_t kidx = (size_t)(b * Skv + (in_range ? key : 0)) * H + h;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

  // every key of the CTA masked (padded shots): dK = dV = 0, nothing to read
  if (!__syncthreads_or(key_ok)) {
    if (in_range) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        store4(dk + kidx * D + 4 * (i * TPR + lane_c), z);
        store4(dv + kidx * D + 4 * (i * TPR + lane_c), z);
      }
    }
    return;
  }

  float4 kr[NC], vr[NC], adk[NC], adv[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int dd = 4 * (i * TPR + lane_c);
    kr[i] = in_range ? load4(k + kidx * D + dd) : z;
    vr[i] = in_range ? load4(v + kidx * D + dd) : z;
    adk[i] = adv[i] = z;
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BQ * (D / 4); c += NT) {
      const int i = c / (D / 4), dd = (c % (D / 4)) * 4, row = q0 + i;
      float4 qx = z, gx = z;
      if (row < Sq) {
        const size_t off = ((size_t)(b * Sq + row) * H + h) * D + dd;
        qx = load4(q + off);
        gx = load4(g + off);
      }
      store4(qs + i * D + dd, qx);
      store4(gs + i * D + dd, gx);
    }
    for (int i = tid; i < BQ; i += NT) {
      const int row = q0 + i;
      const size_t ridx = (size_t)(b * Sq + row) * H + h;
      lse_s[i] = row < Sq ? lse[ridx] * kLog2e : -INFINITY;
      dl_s[i] = row < Sq ? delta[ridx] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int i0 = 0; i0 < BQ; i0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) s[ii] = dp[ii] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int dd = 4 * (i * TPR + lane_c);
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          const float4 qq = load4(qs + (i0 + ii) * D + dd);
          const float4 gg = load4(gs + (i0 + ii) * D + dd);
          s[ii] = fmaf(kr[i].x, qq.x, s[ii]);
          s[ii] = fmaf(kr[i].y, qq.y, s[ii]);
          s[ii] = fmaf(kr[i].z, qq.z, s[ii]);
          s[ii] = fmaf(kr[i].w, qq.w, s[ii]);
          dp[ii] = fmaf(vr[i].x, gg.x, dp[ii]);
          dp[ii] = fmaf(vr[i].y, gg.y, dp[ii]);
          dp[ii] = fmaf(vr[i].z, gg.z, dp[ii]);
          dp[ii] = fmaf(vr[i].w, gg.w, dp[ii]);
        }
      }
      if (TPR > 1) {
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1) {
            s[ii] += __shfl_xor_sync(0xffffffffu, s[ii], off);
            dp[ii] += __shfl_xor_sync(0xffffffffu, dp[ii], off);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) {
        const float l2 = lse_s[i0 + ii];
        const float p = (key_ok && l2 != -INFINITY) ? exp2f(fmaf(s[ii], scale_log2, -l2)) : 0.f;
        dp[ii] = p * (dp[ii] - dl_s[i0 + ii]);  // ds
        s[ii] = p;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int dd = 4 * (i * TPR + lane_c);
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          const float4 qq = load4(qs + (i0 + ii) * D + dd);
          const float4 gg = load4(gs + (i0 + ii) * D + dd);
          adv[i].x = fmaf(s[ii], gg.x, adv[i].x);
          adv[i].y = fmaf(s[ii], gg.y, adv[i].y);
          adv[i].z = fmaf(s[ii], gg.z, adv[i].z);
          adv[i].w = fmaf(s[ii], gg.w, adv[i].w);
          adk[i].x = fmaf(dp[ii], qq.x, adk[i].x);
          adk[i].y = fmaf(dp[ii], qq.y, adk[i].y);
          adk[i].z = fmaf(dp[ii], qq.z, adk[i].z);
          adk[i].w = fmaf(dp[ii], qq.w, adk[i].w);
        }
      }
    }
  }

  if (in_range) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int dd = 4 * (i * TPR + lane_c);
      store4(dk + kidx * D + dd,
             make_float4(adk[i].x * scale, adk[i].y * scale, adk[i].z * scale, adk[i].w * scale));
      store4(dv + kidx * D + dd, adv[i]);
    }
  }
}

// --- bf16 tensor-core kernels, d <= 64 ---------------------------------------

// Loads the A fragments of rows r0 and r0 + 8 of a (rows, D) bf16 operand
// whose rows are `stride` elements apart; rows at or past `n` read as zero.
template <int KD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[KD][4], const __nv_bfloat16* base,
                                            size_t stride, int r0, int n, int t) {
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ((i & 1) ? 8 : 0);
      const int col = kd * 16 + (i >> 1) * 8 + 2 * t;
      a[kd][i] = row < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)row * stride + col)
                         : 0u;
    }
  }
}

// Copies rows [r0, r0 + 64) of a (rows, D) bf16 operand into a padded
// shared-memory tile; rows at or past `n` are zero.
template <int D, int KS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          size_t stride, int r0, int n, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CH; c += 128) {
    const int j = c / CH, dd = (c % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + j < n) x = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + j) * stride + dd);
    *reinterpret_cast<uint4*>(dst + j * KS + dd) = x;
  }
}

// dQ for bf16: four warps of 16 query rows; per 64-key tile, S = Q K^T and
// dP = G V^T on the tensor cores, dS = P (dP - delta) in f32 registers,
// then dQ += dS K with K's fragments through ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                        int H, int Sq, int Skv, float scale, float scale_log2) {
  constexpr int BQ = 64, BKV = 64;
  constexpr int KS = D + 8;      // padded row stride of the K/V tiles (bf16)
  constexpr int NKT = BKV / 8;   // 8-key score tiles
  constexpr int NDT = D / 8;     // 8-dim output tiles
  constexpr int KD = D / 16;     // k-steps over the head dim
  static_assert(D % 16 == 0 && NDT % 2 == 0, "head dim must be a multiple of 16");

  __shared__ __align__(16) __nv_bfloat16 ks[BKV * KS];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * KS];
  __shared__ float kval[BKV];  // 1 = valid key

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = blockIdx.x * BQ + warp * 16 + gq, r1 = r0 + 8;
  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * row_stride + (size_t)h * D;
  const __nv_bfloat16* gb = g + (size_t)b * Sq * row_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * row_stride + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * row_stride + (size_t)h * D;

  uint32_t qa[KD][4], ga[KD][4];
  load_a_rows<KD>(qa, qb, row_stride, r0, Sq, t);
  load_a_rows<KD>(ga, gb, row_stride, r0, Sq, t);
  const size_t i0 = ((size_t)b * Sq + r0) * H + h, i1 = ((size_t)b * Sq + r1) * H + h;
  const float lse0 = r0 < Sq ? lse[i0] * kLog2e : -INFINITY;
  const float lse1 = r1 < Sq ? lse[i1] * kLog2e : -INFINITY;
  const float dl0 = r0 < Sq ? delta[i0] : 0.f;
  const float dl1 = r1 < Sq ? delta[i1] : 0.f;
  const bool live0 = lse0 != -INFINITY, live1 = lse1 != -INFINITY;

  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D, KS>(ks, kb, row_stride, kv0, Skv, tid);
    load_tile<D, KS>(vs, vb, row_stride, kv0, Skv, tid);
    for (int j = tid; j < BKV; j += 128) {
      const int key = kv0 + j;
      kval[j] = (key < Skv && (mask == nullptr || mask[(size_t)b * Skv + key] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        const __nv_bfloat16* kp = ks + (n * 8 + gq) * KS + kd * 16 + 2 * t;
        const __nv_bfloat16* vp = vs + (n * 8 + gq) * KS + kd * 16 + 2 * t;
        mma_bf16(s[n], qa[kd], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
        mma_bf16(dp[n], ga[kd], *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
    // dS = P (dP - delta), in place of S
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kval[n * 8 + 2 * t + e] != 0.f;
        const float p0 = (ok && live0) ? exp2f(fmaf(s[n][e], scale_log2, -lse0)) : 0.f;
        const float p1 = (ok && live1) ? exp2f(fmaf(s[n][2 + e], scale_log2, -lse1)) : 0.f;
        s[n][e] = p0 * (dp[n][e] - dl0);
        s[n][2 + e] = p1 * (dp[n][2 + e] - dl1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // ldmatrix.x4.trans: lanes 8i..8i+7 address the rows of 8x8 matrix i,
      // i = (keys +8 if odd) + (dims +8 if i >= 2)
      const int key = kk * 16 + (lane & 8) + (lane & 7);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, ks + key * KS + (n + (lane >> 4)) * 8);
        mma_bf16(acc[n], da, kf[0], kf[1]);
        mma_bf16(acc[n + 1], da, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= Sq) continue;
    __nv_bfloat16* drow = dq + ((size_t)b * Sq + row) * row_stride + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

// dK and dV for bf16: four warps of 16 keys; per 64-row q-tile, S^T = K Q^T
// and dP^T = V G^T on the tensor cores (K and V rows in A fragments, Q and
// G rows of the shared tile as B operands), P^T and dS^T in f32 registers,
// then dV += P^T G and dK += dS^T Q with G's and Q's fragments through
// ldmatrix.trans.  Each lane's two keys are fixed, so their mask is read
// once.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, float scale,
                         float scale_log2) {
  constexpr int BQ = 64, BKV = 64;
  constexpr int KS = D + 8;      // padded row stride of the Q/G tiles (bf16)
  constexpr int NQT = BQ / 8;    // 8-query score tiles
  constexpr int NDT = D / 8;     // 8-dim output tiles
  constexpr int KD = D / 16;     // k-steps over the head dim
  static_assert(D % 16 == 0 && NDT % 2 == 0, "head dim must be a multiple of 16");

  __shared__ __align__(16) __nv_bfloat16 qs[BQ * KS];
  __shared__ __align__(16) __nv_bfloat16 gs[BQ * KS];
  __shared__ float lse_s[BQ];  // log2 units; -inf for rows past Sq
  __shared__ float dl_s[BQ];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BKV + warp * 16 + gq, k1 = k0 + 8;
  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * row_stride + (size_t)h * D;
  const __nv_bfloat16* gb = g + (size_t)b * Sq * row_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * row_stride + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * row_stride + (size_t)h * D;
  __nv_bfloat16* dkb = dk + (size_t)b * Skv * row_stride + (size_t)h * D;
  __nv_bfloat16* dvb = dv + (size_t)b * Skv * row_stride + (size_t)h * D;

  const bool ok0 = k0 < Skv && (mask == nullptr || mask[(size_t)b * Skv + k0] != 0);
  const bool ok1 = k1 < Skv && (mask == nullptr || mask[(size_t)b * Skv + k1] != 0);

  // every key of the CTA masked (padded shots): dK = dV = 0, nothing to read
  if (!__syncthreads_or(ok0 || ok1)) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? k1 : k0;
      if (key >= Skv) continue;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)key * row_stride + n * 8 + 2 * t) = 0u;
        *reinterpret_cast<uint32_t*>(dvb + (size_t)key * row_stride + n * 8 + 2 * t) = 0u;
      }
    }
    return;
  }

  uint32_t ka[KD][4], va[KD][4];
  load_a_rows<KD>(ka, kb, row_stride, k0, Skv, t);
  load_a_rows<KD>(va, vb, row_stride, k0, Skv, t);

  float adk[NDT][4], adv[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
    adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D, KS>(qs, qb, row_stride, q0, Sq, tid);
    load_tile<D, KS>(gs, gb, row_stride, q0, Sq, tid);
    for (int i = tid; i < BQ; i += 128) {
      const int row = q0 + i;
      const size_t ridx = ((size_t)b * Sq + row) * H + h;
      lse_s[i] = row < Sq ? lse[ridx] * kLog2e : -INFINITY;
      dl_s[i] = row < Sq ? delta[ridx] : 0.f;
    }
    __syncthreads();

    // rows of the C fragments are keys (k0, k1), columns queries
    float s[NQT][4], dp[NQT][4];
#pragma unroll
    for (int n = 0; n < NQT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int n = 0; n < NQT; ++n) {
        const __nv_bfloat16* qp = qs + (n * 8 + gq) * KS + kd * 16 + 2 * t;
        const __nv_bfloat16* gp = gs + (n * 8 + gq) * KS + kd * 16 + 2 * t;
        mma_bf16(s[n], ka[kd], *reinterpret_cast<const uint32_t*>(qp),
                 *reinterpret_cast<const uint32_t*>(qp + 8));
        mma_bf16(dp[n], va[kd], *reinterpret_cast<const uint32_t*>(gp),
                 *reinterpret_cast<const uint32_t*>(gp + 8));
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int n = 0; n < NQT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        const float l2 = lse_s[col], dlt = dl_s[col];
        const bool live = l2 != -INFINITY;
        const float p0 = (ok0 && live) ? exp2f(fmaf(s[n][e], scale_log2, -l2)) : 0.f;
        const float p1 = (ok1 && live) ? exp2f(fmaf(s[n][2 + e], scale_log2, -l2)) : 0.f;
        dp[n][e] = p0 * (dp[n][e] - dlt);
        dp[n][2 + e] = p1 * (dp[n][2 + e] - dlt);
        s[n][e] = p0;
        s[n][2 + e] = p1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int row = kk * 16 + (lane & 8) + (lane & 7);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        uint32_t gf[4], qf[4];
        ldmatrix_x4_trans(gf, gs + row * KS + (n + (lane >> 4)) * 8);
        mma_bf16(adv[n], pa, gf[0], gf[1]);
        mma_bf16(adv[n + 1], pa, gf[2], gf[3]);
        ldmatrix_x4_trans(qf, qs + row * KS + (n + (lane >> 4)) * 8);
        mma_bf16(adk[n], da, qf[0], qf[1]);
        mma_bf16(adk[n + 1], da, qf[2], qf[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? k1 : k0;
    if (key >= Skv) continue;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key * row_stride + n * 8 + 2 * t) =
          pack_bf16(adk[n][2 * half] * scale, adk[n][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key * row_stride + n * 8 + 2 * t) =
          pack_bf16(adv[n][2 * half], adv[n][2 * half + 1]);
    }
  }
}

// --- launch --------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const uint8_t* mask;
  int B, H, Sq, Skv;
  float scale;
  cudaStream_t stream;
};

template <int D, int TPR>
cudaError_t dq_f32(const Args& a, void* dq) {
  const dim3 grid((a.Sq + 128 / TPR - 1) / (128 / TPR), a.B * a.H);
  flash_bwd_dq_kernel<D, TPR><<<grid, 128, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse, a.delta, a.mask,
      static_cast<float*>(dq), a.H, a.Sq, a.Skv, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int TPR>
cudaError_t dkv_f32(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.Skv + 128 / TPR - 1) / (128 / TPR), a.B * a.H);
  flash_bwd_dkv_kernel<D, TPR><<<grid, 128, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse, a.delta, a.mask,
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Sq, a.Skv, a.scale,
      a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const Args& a, void* dq) {
  const dim3 grid((a.Sq + 63) / 64, a.B * a.H);
  flash_bwd_dq_mma_kernel<D><<<grid, 128, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.g), a.lse,
      a.delta, a.mask, static_cast<__nv_bfloat16*>(dq), a.H, a.Sq, a.Skv, a.scale,
      a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_bf16(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.Skv + 63) / 64, a.B * a.H);
  flash_bwd_dkv_mma_kernel<D><<<grid, 128, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.g), a.lse,
      a.delta, a.mask, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.H,
      a.Sq, a.Skv, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

bool valid(int B, int H, int Sq, int Skv) {
  return B > 0 && H > 0 && Sq > 0 && Skv > 0 && B * H <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64}.  mask may be null.
// lse and delta are (B, Sq, H) f32.  Each returns the CUDA error of its
// launch (0 = cudaSuccess); the kernel runs asynchronously on `stream`.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      const void* mask, void* dq, int B, int H, int Sq,
                                      int Skv, int D, int dtype, float scale, void* stream) {
  if (!valid(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), B, H, Sq, Skv, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    switch (D) {
      case 16: return (int)dq_f32<16, 1>(a, dq);
      case 32: return (int)dq_f32<32, 2>(a, dq);
      case 64: return (int)dq_f32<64, 4>(a, dq);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return (int)dq_bf16<16>(a, dq);
      case 32: return (int)dq_bf16<32>(a, dq);
      case 64: return (int)dq_bf16<64>(a, dq);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* g, const void* lse, const void* delta,
                                       const void* mask, void* dk, void* dv, int B, int H,
                                       int Sq, int Skv, int D, int dtype, float scale,
                                       void* stream) {
  if (!valid(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), B, H, Sq, Skv, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    switch (D) {
      case 16: return (int)dkv_f32<16, 1>(a, dk, dv);
      case 32: return (int)dkv_f32<32, 2>(a, dk, dv);
      case 64: return (int)dkv_f32<64, 4>(a, dk, dv);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return (int)dkv_bf16<16>(a, dk, dv);
      case 32: return (int)dkv_bf16<32>(a, dk, dv);
      case 64: return (int)dkv_bf16<64>(a, dk, dv);
    }
  }
  return (int)cudaErrorInvalidValue;
}
