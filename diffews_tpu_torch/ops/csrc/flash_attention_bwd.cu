// Flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of `diffews_tpu/ops/flash_attention.py`
// that `_flash_backward` launches for `flash_attention`'s custom VJP:
//
//   _bwd_dq_kernel   ->  flash_bwd_dq_wgmma_kernel (bf16), flash_bwd_dq_kernel (f32)
//   _bwd_dkv_kernel  ->  flash_bwd_dkv_wgmma_kernel (bf16), flash_bwd_dkv_kernel (f32)
//
// They compute what the TPU kernels compute.  With s = scale * q_i . k_j,
// p_ij = exp(s_ij - LSE_i) (the forward's saved f32 log-sum-exp), dp_ij =
// g_i . v_j, delta_i = rowsum(O_i * g_i) and ds_ij = p_ij * (dp_ij - delta_i):
//
//   dQ_i = scale * sum_j ds_ij k_j      dK_j = scale * sum_i ds_ij q_i
//   dV_j = sum_i p_ij g_i
//
// with f32 accumulation and outputs in the input dtype; in bf16, P and dS
// are rounded to bf16 for the products, as the forward rounds P.  Masking
// follows the forward: a masked key gets p = 0 exactly (not exp of a -1e30
// bias), so masked keys get dK = dV = 0 exactly; a row with no valid key
// (LSE = -inf) gets dQ = 0 and adds nothing to dK/dV.  Operands keep the
// (B, S, H, D) layout; LSE is (B, Sq, H) f32; the key mask is (B, Skv) uint8.
//
// Two passes and no atomics: every output element is written by one
// thread, so gradients are bit-deterministic.  The bf16 dq pass reads O
// too: it computes delta in f32 and writes it, with -LSE*log2(e), as
// (B*H, Sq) rows (`RowStats`), so the dkv pass can copy a q-tile's values
// with one contiguous bulk copy (in (B, Sq, H) one head's values lie H
// floats apart, which no TMA box can take).  The f32 pair keeps the torch
// delta of the plain version (the f32 dq kernel only copies it), so f32
// gradients round as before.
//
// What bounds it on this card: per head the work is 6*Sq*Skv*d (dq: S, dP,
// dQ) and 8*Sq*Skv*d (dkv: S, dP, dV, dK) FLOPs against about 4*(Sq +
// Skv)*d bytes, hundreds of FLOPs per byte at the UNet's shapes, so both are
// compute-bound, at the bf16 tensor-core rate (989 TFLOP/s).  What the bf16
// design does about it, as the forward (`flash_attention_fwd.cu`) does:
//
//  - warp specialisation: a producer warp keeps TMA loads in flight through
//    a ring of full/empty mbarriers; two consumer warpgroups run every
//    product on wgmma (f32 accumulators in registers), setmaxnreg moving
//    registers from the producer to them;
//  - no transposed copy: the operands that enter a product transposed (K in
//    dQ = dS K, g in dV = P^T g, Q in dK = dS^T Q) are read MN-major from
//    their (row, d) tiles through the descriptor's transpose bit, and P, dS
//    go from the accumulators, packed to bf16, straight into the A
//    fragments of wgmma's register-A form;
//  - skipped work: dq's producer votes over each key tile's mask bytes and
//    skips tiles with no valid key (the padded shots), handing the key bits
//    over beside the tile (`hopper::kv_ring_produce`, shared with the
//    forward); a dkv CTA whose keys are all masked writes zeros and stops;
//  - a filled card: at B = 1 a grid of one CTA per tile is one or two
//    partial waves on 132 SMs (dq at the 64x64 level: 160 CTAs), so each
//    pass splits its walk (keys for dq, queries for dkv) over gridDim.z
//    CTAs when that fills the waves better (`plan_splits`).  Split CTAs
//    write f32 partials that `flash_bwd_sum_splits_kernel` adds in split
//    order, so the result stays deterministic.
//
// f32 runs on the FMA pipes, a row on TPR lanes (the parity paths use it).

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using hopper::TileMeta;

// Per-row statistics the dq pass writes for the dkv pass: (2, B*H, Sq_pad)
// f32, -LSE*log2(e) (-inf for a row with no valid key and, in bf16, for
// the rows past Sq up to Sq_pad) and delta.
struct RowStats {
  float* base;
  int bh_count, sq_pad;
  __device__ __forceinline__ float* neg_lse2(int bh) const {
    return base + (size_t)bh * sq_pad;
  }
  __device__ __forceinline__ float* delta(int bh) const {
    return base + ((size_t)bh_count + bh) * sq_pad;
  }
  __device__ __forceinline__ void put(int bh, int row, float nl, float dl) const {
    neg_lse2(bh)[row] = nl;
    delta(bh)[row] = dl;
  }
};

constexpr int kStatsRows = 128;  // Sq_pad is a multiple of this (the bf16 dq tile)
constexpr int kMaxSplits = 8;
constexpr int kMinSplitRows = 1024;  // keys (dq) or query rows (dkv) a split walks at least

constexpr int kChunk = 8;  // f32 kernels: keys (dq) or queries (dkv) per register block

// --- f32 kernels (FMA) -------------------------------------------------------

// dQ for f32.  Each query row belongs to TPR consecutive lanes, each holding
// D/TPR dims of q, g and the accumulator; K/V tiles of 64 keys are read
// from shared memory.  delta (B, Sq, H) comes from the caller, computed in
// torch as the plain version computes it, so f32 gradients repeat the
// plain path's rounding; the kernel copies it, with -LSE*log2e, into the
// row statistics for the dkv pass (`RowStats`).
template <int D, int TPR>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ delta, const float* __restrict__ lse,
                    const uint8_t* __restrict__ mask, float* __restrict__ dq,
                    RowStats st, int H, int Sq, int Skv, float scale, float scale_log2) {
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
  const float dl = row_ok ? delta[ridx] : 0.f;
  const float lse2 = row_ok ? lse[ridx] * kLog2e : -INFINITY;
  const bool live = lse2 != -INFINITY;
  if (row_ok && lane_c == 0) st.put(bh, row, live ? -lse2 : -INFINITY, dl);

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
                     RowStats st, const uint8_t* __restrict__ mask, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Skv, float scale,
                     float scale_log2) {
  constexpr int NT = 128, BQ = 64;
  constexpr int ROWS = NT / TPR;
  constexpr int NC = D / (4 * TPR);
  static_assert(D % (4 * TPR) == 0, "head dim must split into float4 chunks");
  static_assert(BQ % kChunk == 0, "q tile must hold whole chunks");

  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float gs[BQ * D];
  __shared__ float nl_s[BQ];  // -LSE in log2 units; -inf for dead rows and rows past Sq
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
      nl_s[i] = row < Sq ? st.neg_lse2(bh)[row] : -INFINITY;
      dl_s[i] = row < Sq ? st.delta(bh)[row] : 0.f;
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
        const float nl = nl_s[i0 + ii];
        const float p = (key_ok && nl != -INFINITY) ? exp2f(fmaf(s[ii], scale_log2, nl)) : 0.f;
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

// --- bf16: warp-specialised wgmma kernels, d in {16, 32, 64} ---------------
//
// A CTA is three warpgroups: two consumers (threads 0-255) and a producer
// (256-383, of which one warp works).  Rows are D*2 bytes, one swizzle span
// (128 B at d = 64, 64 at 32, 32 at 16), as TMA writes them and a wgmma
// descriptor of the same swizzle reads them.

// Packs a 16-column k-step of f32 accumulator values (rows g and g+8,
// columns 8j + 2t (+1) for j = 2kk, 2kk+1) into wgmma's A fragment: x0/x1
// are this lane's values of rows g / g+8 in the two 8-column groups.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], int j, float r0e0, float r0e1,
                                       float r1e0, float r1e1) {
  a[2 * (j % 2)] = pack_bf16(r0e0, r0e1);
  a[2 * (j % 2) + 1] = pack_bf16(r1e0, r1e1);
}

// delta = rowsum(O * g) of one row in f32: the quad's four lanes take D/4
// dims each (4 bf16 per 8-byte load); rows at or past Sq give 0.
template <int D>
__device__ __forceinline__ float row_delta(const __nv_bfloat16* o, const __nv_bfloat16* g,
                                           bool ok, int t) {
  float acc = 0.f;
  if (ok) {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int col = t * (D / 4) + 4 * i;
      const uint2 ov = *reinterpret_cast<const uint2*>(o + col);
      const uint2 gv = *reinterpret_cast<const uint2*>(g + col);
      const float2 o0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
      const float2 o1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
      const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv.x));
      const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv.y));
      acc += o0.x * g0.x + o0.y * g0.y + o1.x * g1.x + o1.y * g1.y;
    }
  }
  return quad_sum(acc);
}

// dq: 128 query rows per CTA (64 per consumer warpgroup), key tiles of 128
// through a STAGES-deep K+V ring; Q and g loaded once.
template <int D>
struct DqCfg {
  static constexpr int BQ = 128, BKV = 128, STAGES = 3;
  static constexpr int SPAN = D * 2;
  static constexpr int Q_BYTES = BQ * SPAN;    // Q or g
  static constexpr int KV_BYTES = BKV * SPAN;  // one K or one V tile
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int META_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = META_OFF + STAGES * (int)sizeof(TileMeta);
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// The consumers, per key tile: S = Q K^T and dP = g V^T (wgmma, both
// operands K-major in shared memory), P = 2^(S*scale*log2e - LSE*log2e)
// with the tile's key bits applied, dS = P (dP - delta) packed to bf16,
// dQ += dS K (wgmma with dS from registers, K read MN-major).  Split z
// walks key tiles [z*tps, (z+1)*tps); with more than one split it writes
// f32 partials of dQ / scale to `part` ((splits, B, Sq, H, D)), else dQ.
// Split 0 writes the row statistics.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                          const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                          float* __restrict__ part, RowStats st, int H, int Sq, int Skv,
                          int tps, float scale, float scale_log2) {
  using namespace hopper;
  using C = DqCfg<D>;
  constexpr int SPAN = C::SPAN, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* gs = base + C::Q_BYTES;
  uint8_t* ks = base + C::K_OFF;  // [STAGES][BKV rows]
  uint8_t* vs = base + C::V_OFF;
  TileMeta* meta = reinterpret_cast<TileMeta*>(base + C::META_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ, split = blockIdx.z;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid / 32 != 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * C::Q_BYTES);
      tma_load_4d(qs, &tq, qbar, 0, h, q0, b);
      tma_load_4d(gs, &tg, qbar, 0, h, q0, b);
    }
    const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Skv;
    const int j0 = split * tps, j1 = min((Skv + BKV - 1) / BKV, j0 + tps);
    kv_ring_produce<STAGES, BKV>(&tk, &tv, ks, vs, C::KV_BYTES, meta, full, empty, mrow, h, b,
                                 j0, j1, Skv, lane);
    return;
  }

  // consumer warpgroup c: query rows q0 + 64c + 16*warp + gq (+8)
  setmaxnreg_inc<232>();
  const int c = tid / 128, warp = (tid % 128) / 32, gq = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * c + 16 * warp + gq, r1 = r0 + 8;
  // row statistics, while Q and g arrive: nl = -LSE*log2e (-inf: no valid
  // key, or past Sq, so p = 2^-inf = 0), delta from O and g
  float nl[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    const bool ok = row < Sq;
    const size_t off = (((size_t)b * Sq + (ok ? row : 0)) * H + h) * D;
    dl[half] = row_delta<D>(o + off, g + off, ok, t);
    const float l = ok ? lse[((size_t)b * Sq + row) * H + h] : -INFINITY;
    nl[half] = l == -INFINITY ? -INFINITY : -l * kLog2e;
    if (split == 0 && t == 0) st.put(bh, row, nl[half], dl[half]);
  }
  const uint32_t q_addr = smem_addr(qs + c * 64 * SPAN), g_addr = smem_addr(gs + c * 64 * SPAN);
  float acc[D / 2];  // dQ / scale, rows r0 (+8), dims 8j + 2t (+1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    if (meta[stage].tile < 0) break;
    uint32_t sh[BKV / 32];  // bit 8*(j%4) + e: key 8j + 2t + e of word j/4
#pragma unroll
    for (int w = 0; w < BKV / 32; ++w) sh[w] = meta[stage].bits[w] >> (2 * t);
    const uint32_t k_addr = smem_addr(ks + stage * C::KV_BYTES);
    const uint32_t v_addr = smem_addr(vs + stage * C::KV_BYTES);
    float s[BKV / 2], dp[BKV / 2];  // rows as acc, keys 8j + 2t (+1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, 0>(s, make_desc<SPAN>(q_addr + kk * 32), make_desc<SPAN>(k_addr + kk * 32),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, 0>(dp, make_desc<SPAN>(g_addr + kk * 32), make_desc<SPAN>(v_addr + kk * 32),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    uint32_t ds[BKV / 16][4];  // dS in bf16: the A fragments of dS K
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (sh[j / 4] >> (8 * (j % 4) + e)) & 1u;
        const float p0 = ok ? ex2(fmaf(s[4 * j + e], scale_log2, nl[0])) : 0.f;
        const float p1 = ok ? ex2(fmaf(s[4 * j + 2 + e], scale_log2, nl[1])) : 0.f;
        d[e] = p0 * (dp[4 * j + e] - dl[0]);
        d[2 + e] = p1 * (dp[4 * j + 2 + e] - dl[1]);
      }
      pack_a(ds[j / 2], j, d[0], d[1], d[2], d[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<D>(acc, ds[kk], make_desc<SPAN>(k_addr + kk * 16 * SPAN), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= Sq) continue;
    const size_t off = (((size_t)b * Sq + row) * H + h) * D;
    if (part == nullptr) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dq + off + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
    } else {
      float* p = part + (size_t)split * gridDim.y * Sq * D + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(p + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// dkv: 128 keys per CTA (64 per consumer warpgroup), K and V loaded once;
// q-tiles of 64 rows, with their row statistics, through a STAGES-deep ring.
template <int D>
struct DkvCfg {
  static constexpr int BKV = 128, BQ = 64, STAGES = 4;
  static constexpr int SPAN = D * 2;
  static constexpr int K_BYTES = BKV * SPAN;  // K or V
  static constexpr int T_BYTES = BQ * SPAN;   // one Q or one g tile
  static constexpr int ST_BYTES = 2 * BQ * 4; // one tile's -LSE*log2e and delta
  static constexpr int Q_OFF = 2 * K_BYTES;
  static constexpr int G_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int ST_OFF = G_OFF + STAGES * T_BYTES;
  static constexpr int BAR_OFF = ST_OFF + STAGES * ST_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// The consumers, per q-tile: S^T = K Q^T and dP^T = V g^T (wgmma, both
// K-major), P^T and dS^T with the lane's two key rows' validity (read once)
// and the tile's statistics, then dV += P^T g and dK += dS^T Q (P^T, dS^T
// from registers; g and Q read MN-major).  Split z walks q-tiles [z*tps,
// (z+1)*tps); with more than one split it writes f32 partials of dK /
// scale and dV to `part` ((splits, 2, B, Skv, H, D)), else dK and dV.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, RowStats st,
                           const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int H,
                           int Sq, int Skv, int tps, float scale, float scale_log2) {
  using namespace hopper;
  using C = DkvCfg<D>;
  constexpr int SPAN = C::SPAN, BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = base;
  uint8_t* vs = base + C::K_BYTES;
  uint8_t* qs = base + C::Q_OFF;  // [STAGES][BQ rows]
  uint8_t* gs = base + C::G_OFF;
  float* sts = reinterpret_cast<float*>(base + C::ST_OFF);  // [STAGES][2][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * C::BKV, split = blockIdx.z;
  const size_t count = (size_t)gridDim.y * Skv * D;  // elements of dK (or dV)
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  const bool key_ok = tid < C::BKV && k0 + tid < Skv &&
                      (mask == nullptr || mask[(size_t)b * Skv + k0 + tid] != 0);
  // every key of the CTA masked (padded shots): dK = dV = 0, nothing to read
  if (!__syncthreads_or(key_ok)) {
    const int nkeys = min(C::BKV, Skv - k0);
    for (int i = tid; i < nkeys * (D / 8); i += blockDim.x) {
      const size_t off = (((size_t)b * Skv + k0 + i / (D / 8)) * H + h) * D + (i % (D / 8)) * 8;
      if (part == nullptr) {
        *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        float* p = part + (size_t)split * 2 * count + off;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        store4(p, z);
        store4(p + 4, z);
        store4(p + count, z);
        store4(p + count + 4, z);
      }
    }
    return;
  }

  const int i0 = split * tps, i1 = min((Sq + BQ - 1) / BQ, i0 + tps);
  if (tid >= 256) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid / 32 != 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * C::K_BYTES);
      tma_load_4d(ks, &tk, kvbar, 0, h, k0, b);
      tma_load_4d(vs, &tv, kvbar, 0, h, k0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = i0; i < i1; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * C::T_BYTES + C::ST_BYTES);
        tma_load_4d(qs + stage * C::T_BYTES, &tq, &full[stage], 0, h, i * BQ, b);
        tma_load_4d(gs + stage * C::T_BYTES, &tg, &full[stage], 0, h, i * BQ, b);
        float* dst = sts + stage * 2 * BQ;
        bulk_load(dst, st.neg_lse2(bh) + i * BQ, BQ * 4, &full[stage]);
        bulk_load(dst + BQ, st.delta(bh) + i * BQ, BQ * 4, &full[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroup c: keys k0 + 64c + 16*warp + gq (+8)
  setmaxnreg_inc<232>();
  const int c = tid / 128, warp = (tid % 128) / 32, gq = lane / 4, t = lane % 4;
  const int kr0 = k0 + 64 * c + 16 * warp + gq, kr1 = kr0 + 8;
  // keys past Skv are zero-filled by TMA (score 0, not -inf): masked by index
  const bool ok0 = kr0 < Skv && (mask == nullptr || mask[(size_t)b * Skv + kr0] != 0);
  const bool ok1 = kr1 < Skv && (mask == nullptr || mask[(size_t)b * Skv + kr1] != 0);
  const uint32_t k_addr = smem_addr(ks + c * 64 * SPAN), v_addr = smem_addr(vs + c * 64 * SPAN);
  float adk[D / 2], adv[D / 2];  // dK / scale and dV, keys kr0 (+8), dims 8j + 2t (+1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  mbar_wait(kvbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int i = i0; i < i1; ++i) {
    mbar_wait(&full[stage], phase);
    const uint32_t q_addr = smem_addr(qs + stage * C::T_BYTES);
    const uint32_t g_addr = smem_addr(gs + stage * C::T_BYTES);
    const float* nls = sts + stage * 2 * BQ;
    const float* dls = nls + BQ;
    float s[BQ / 2], dp[BQ / 2];  // keys as rows, queries 8j + 2t (+1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, 0>(s, make_desc<SPAN>(k_addr + kk * 32), make_desc<SPAN>(q_addr + kk * 32),
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, 0>(dp, make_desc<SPAN>(v_addr + kk * 32), make_desc<SPAN>(g_addr + kk * 32),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T in bf16
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 nl = *reinterpret_cast<const float2*>(nls + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
      const float p00 = ok0 ? ex2(fmaf(s[4 * j], scale_log2, nl.x)) : 0.f;
      const float p01 = ok0 ? ex2(fmaf(s[4 * j + 1], scale_log2, nl.y)) : 0.f;
      const float p10 = ok1 ? ex2(fmaf(s[4 * j + 2], scale_log2, nl.x)) : 0.f;
      const float p11 = ok1 ? ex2(fmaf(s[4 * j + 3], scale_log2, nl.y)) : 0.f;
      pack_a(pa[j / 2], j, p00, p01, p10, p11);
      pack_a(da[j / 2], j, p00 * (dp[4 * j] - dl.x), p01 * (dp[4 * j + 1] - dl.y),
             p10 * (dp[4 * j + 2] - dl.x), p11 * (dp[4 * j + 3] - dl.y));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<D>(adv, pa[kk], make_desc<SPAN>(g_addr + kk * 16 * SPAN), 1);
      wgmma_rs<D>(adk, da[kk], make_desc<SPAN>(q_addr + kk * 16 * SPAN), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(adv);
    fence_operands(adk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kr1 : kr0;
    if (key >= Skv) continue;
    const size_t off = (((size_t)b * Skv + key) * H + h) * D;
    if (part == nullptr) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t) =
            pack_bf16(adk[4 * j + 2 * half] * scale, adk[4 * j + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t) =
            pack_bf16(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
      }
    } else {
      float* p = part + (size_t)split * 2 * count + off;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(p + 8 * j + 2 * t) =
            make_float2(adk[4 * j + 2 * half], adk[4 * j + 2 * half + 1]);
        *reinterpret_cast<float2*>(p + count + 8 * j + 2 * t) =
            make_float2(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// out0 = bf16(scale0 * sum over splits of part[split]), the splits added
// in order; `count` elements (a multiple of 4) per split, `stride` apart.
// With out1, the `count` elements after each split's first go to out1
// (scale1) in the same launch (dK and dV).
__global__ void __launch_bounds__(256)
flash_bwd_sum_splits_kernel(const float* __restrict__ part, int splits, size_t count,
                            size_t stride, float scale0, __nv_bfloat16* __restrict__ out0,
                            float scale1, __nv_bfloat16* __restrict__ out1) {
  size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const bool second = i >= count;
  if (second && (out1 == nullptr || i >= 2 * count)) return;
  const float scale = second ? scale1 : scale0;
  __nv_bfloat16* out = second ? out1 : out0;
  if (second) {
    i -= count;
    part += count;
  }
  float4 a = load4(part + i);
  for (int s = 1; s < splits; ++s) {
    const float4 x = load4(part + s * stride + i);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  *reinterpret_cast<uint2*>(out + i) =
      make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
}

// --- launch --------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g;
  const uint8_t* mask;
  RowStats st;
  int B, H, Sq, Skv;
  float scale;
  cudaStream_t stream;
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// How a pass of `ctas` CTAs (one CTA an SM: 384 threads at up to 232
// registers) splits a walk of `walk` tiles: the fewest splits, each at
// least `min_tiles` long, whose grid fills its last wave to 85%, else the
// fullest.  Returns the tiles per split; *splits is the count that needs.
// A function of the shapes alone, so a call's split, and its bits, repeat.
// (Measured on the H100: splits of 3-6 tiles, at the 32x32 level, cost
// more in partials and sums than the fuller waves give back.)
int plan_splits(int ctas, int walk, int min_tiles, int* splits) {
  const int sms = sm_count();
  int best = 1;
  double best_fill = 0.0;
  for (int n = 1; n <= kMaxSplits && (n == 1 || n * min_tiles <= walk); ++n) {
    const int total = ctas * n, waves = (total + sms - 1) / sms;
    const double fill = (double)total / ((double)waves * sms);
    if (fill > best_fill + 1e-9) {
      best = n;
      best_fill = fill;
    }
    if (fill >= 0.85) break;
  }
  const int tps = (walk + best - 1) / best;
  *splits = (walk + tps - 1) / tps;
  return tps;
}

struct Plan {
  int dq_splits, dq_tps, dkv_splits, dkv_tps, sq_pad;
};

Plan make_plan(int B, int H, int Sq, int Skv, int dtype) {
  Plan p{1, 0, 1, 0, (Sq + kStatsRows - 1) / kStatsRows * kStatsRows};
  if (dtype == 1) {  // the bf16 kernels' tiles (the same at every d)
    using Q = DqCfg<64>;
    using K = DkvCfg<64>;
    p.dq_tps = plan_splits((Sq + Q::BQ - 1) / Q::BQ * B * H, (Skv + Q::BKV - 1) / Q::BKV,
                           kMinSplitRows / Q::BKV, &p.dq_splits);
    p.dkv_tps = plan_splits((Skv + K::BKV - 1) / K::BKV * B * H, (Sq + K::BQ - 1) / K::BQ,
                            kMinSplitRows / K::BQ, &p.dkv_splits);
  }
  return p;
}

template <int D, int TPR>
cudaError_t dq_f32(const Args& a, const float* delta, const float* lse, void* dq) {
  const dim3 grid((a.Sq + 128 / TPR - 1) / (128 / TPR), a.B * a.H);
  flash_bwd_dq_kernel<D, TPR><<<grid, 128, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g),
      delta, lse, a.mask, static_cast<float*>(dq), a.st, a.H, a.Sq,
      a.Skv, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int TPR>
cudaError_t dkv_f32(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.Skv + 128 / TPR - 1) / (128 / TPR), a.B * a.H);
  flash_bwd_dkv_kernel<D, TPR><<<grid, 128, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.st, a.mask,
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Sq, a.Skv, a.scale,
      a.scale * kLog2e);
  return cudaGetLastError();
}

// The tensor maps of q and g (boxes of q_rows) and k and v (kv_rows).
template <int D>
bool encode_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap* tq, CUtensorMap* tg,
                 CUtensorMap* tk, CUtensorMap* tv) {
  constexpr CUtensorMapSwizzle sw = hopper::Swizzle<D * 2>::tma;
  return hopper::encode_bshd_map(tq, a.q, a.B, a.Sq, a.H, D, D, q_rows, sw) &&
         hopper::encode_bshd_map(tg, a.g, a.B, a.Sq, a.H, D, D, q_rows, sw) &&
         hopper::encode_bshd_map(tk, a.k, a.B, a.Skv, a.H, D, D, kv_rows, sw) &&
         hopper::encode_bshd_map(tv, a.v, a.B, a.Skv, a.H, D, D, kv_rows, sw);
}

cudaError_t sum_splits(const float* part, int splits, size_t count, size_t stride, float scale0,
                       void* out0, float scale1, void* out1, cudaStream_t stream) {
  const size_t n = (out1 == nullptr ? 1 : 2) * count / 4;
  flash_bwd_sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, splits, count, stride, scale0, static_cast<__nv_bfloat16*>(out0), scale1,
      static_cast<__nv_bfloat16*>(out1));
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const Args& a, const Plan& p, const void* o, const float* lse, void* dq,
                    float* work) {
  using C = DqCfg<D>;
  CUtensorMap tq, tg, tk, tv;
  if (!encode_maps<D>(a, C::BQ, C::BKV, &tq, &tg, &tk, &tv)) return cudaErrorInvalidValue;
  if (p.dq_splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per process
      flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  float* part = p.dq_splits > 1 ? work : nullptr;
  const dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.B * a.H, p.dq_splits);
  flash_bwd_dq_wgmma_kernel<D><<<grid, 384, C::SMEM, a.stream>>>(
      tq, tg, tk, tv, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(a.g), lse, a.mask, static_cast<__nv_bfloat16*>(dq),
      part, a.st, a.H, a.Sq, a.Skv, p.dq_tps, a.scale, a.scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const size_t count = (size_t)a.B * a.Sq * a.H * D;
  return sum_splits(part, p.dq_splits, count, count, a.scale, dq, 0.f, nullptr, a.stream);
}

template <int D>
cudaError_t dkv_bf16(const Args& a, const Plan& p, void* dk, void* dv, float* work) {
  using C = DkvCfg<D>;
  CUtensorMap tq, tg, tk, tv;
  if (!encode_maps<D>(a, C::BQ, C::BKV, &tq, &tg, &tk, &tv)) return cudaErrorInvalidValue;
  if (p.dkv_splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per process
      flash_bwd_dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  float* part = p.dkv_splits > 1 ? work : nullptr;
  const dim3 grid((a.Skv + C::BKV - 1) / C::BKV, a.B * a.H, p.dkv_splits);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, 384, C::SMEM, a.stream>>>(
      tq, tg, tk, tv, a.st, a.mask, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, a.H, a.Sq, a.Skv, p.dkv_tps, a.scale,
      a.scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const size_t count = (size_t)a.B * a.Skv * a.H * D;
  return sum_splits(part, p.dkv_splits, count, 2 * count, a.scale, dk, 1.f, dv, a.stream);
}

bool valid(int B, int H, int Sq, int Skv) {
  return B > 0 && H > 0 && Sq > 0 && Skv > 0 && B * H <= 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* g, const void* mask,
               void* stats, int B, int H, int Sq, int Skv, float scale, void* stream) {
  const int sq_pad = (Sq + kStatsRows - 1) / kStatsRows * kStatsRows;
  return Args{q, k, v, g, static_cast<const uint8_t*>(mask),
              RowStats{static_cast<float*>(stats), B * H, sq_pad}, B, H, Sq, Skv, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The backward's plan at these extents (dtype: 0 = float32, 1 = bfloat16):
// out[0] / out[1] = the dq / dkv pass's splits (f32 partials of
// splits * B*Sq*H*D, resp. splits * 2 * B*Skv*H*D floats are needed as
// `work` when > 1), out[2] = Sq_pad, the row length of the (2, B*H,
// Sq_pad) f32 row statistics.
extern "C" int flash_attention_bwd_plan(int B, int H, int Sq, int Skv, int dtype, int* out) {
  if (!valid(B, H, Sq, Skv) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, Sq, Skv, dtype);
  out[0] = p.dq_splits;
  out[1] = p.dkv_splits;
  out[2] = p.sq_pad;
  return 0;
}

// dQ; writes the row statistics `stats` for the dkv pass.  D in {16, 32,
// 64}; mask may be null; lse is (B, Sq, H) f32.  bf16 computes delta from
// o, the forward's output; f32 takes `delta` ((B, Sq, H) f32) instead.
// `work`: f32 scratch of the plan's size (null when the plan has one
// split).  Returns the CUDA error of the launches (0 = cudaSuccess); the
// kernels run asynchronously on `stream`.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* g, const void* o, const void* delta,
                                      const void* lse, const void* mask, void* dq, void* stats,
                                      void* work, int B, int H, int Sq, int Skv, int D,
                                      int dtype, float scale, void* stream) {
  if (!valid(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, mask, stats, B, H, Sq, Skv, scale, stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0) {
    const float* dl = static_cast<const float*>(delta);
    if (dl == nullptr) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 16: return (int)dq_f32<16, 1>(a, dl, l, dq);
      case 32: return (int)dq_f32<32, 2>(a, dl, l, dq);
      case 64: return (int)dq_f32<64, 4>(a, dl, l, dq);
    }
  } else if (dtype == 1) {
    const Plan p = make_plan(B, H, Sq, Skv, dtype);
    float* w = static_cast<float*>(work);
    switch (D) {
      case 16: return (int)dq_bf16<16>(a, p, o, l, dq, w);
      case 32: return (int)dq_bf16<32>(a, p, o, l, dq, w);
      case 64: return (int)dq_bf16<64>(a, p, o, l, dq, w);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// dK and dV from the row statistics the dq pass wrote; arguments as
// `flash_attention_bwd_dq`.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* g, const void* stats, const void* mask,
                                       void* dk, void* dv, void* work, int B, int H, int Sq,
                                       int Skv, int D, int dtype, float scale, void* stream) {
  if (!valid(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, mask, const_cast<void*>(stats), B, H, Sq, Skv, scale,
                           stream);
  if (dtype == 0) {
    switch (D) {
      case 16: return (int)dkv_f32<16, 1>(a, dk, dv);
      case 32: return (int)dkv_f32<32, 2>(a, dk, dv);
      case 64: return (int)dkv_f32<64, 4>(a, dk, dv);
    }
  } else if (dtype == 1) {
    const Plan p = make_plan(B, H, Sq, Skv, dtype);
    float* w = static_cast<float*>(work);
    switch (D) {
      case 16: return (int)dkv_bf16<16>(a, p, dk, dv, w);
      case 32: return (int)dkv_bf16<32>(a, p, dk, dv, w);
      case 64: return (int)dkv_bf16<64>(a, p, dk, dv, w);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Resources of the bf16 kernels at head dim D, kind 0 = dq, 1 = dkv:
// registers a thread at launch (setmaxnreg then gives the producer
// warpgroup 40 and the consumers 232), dynamic shared memory in bytes and
// threads per CTA.  Returns the CUDA error (0 = cudaSuccess).
extern "C" int flash_attention_bwd_info(int D, int kind, int* regs, int* smem, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
#define BWD_INFO(d)                                                              \
  case d:                                                                        \
    if (kind == 0) {                                                             \
      err = cudaFuncGetAttributes(&attr, flash_bwd_dq_wgmma_kernel<d>);          \
      *smem = DqCfg<d>::SMEM;                                                    \
    } else if (kind == 1) {                                                      \
      err = cudaFuncGetAttributes(&attr, flash_bwd_dkv_wgmma_kernel<d>);         \
      *smem = DkvCfg<d>::SMEM;                                                   \
    }                                                                            \
    break;
  switch (D) {
    BWD_INFO(16)
    BWD_INFO(32)
    BWD_INFO(64)
  }
#undef BWD_INFO
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *threads = 384;
  return 0;
}
