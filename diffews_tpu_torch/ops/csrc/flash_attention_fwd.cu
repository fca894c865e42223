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
//  - flash_fwd_wgmma_kernel, bf16 with d <= 64 (every UNet site): warp-
//    specialised for Hopper.  A producer warp streams 128-key K and V
//    tiles by TMA into a 3-stage ring guarded by full/empty mbarriers and
//    skips tiles whose keys are all masked; two consumer warpgroups of 64
//    query rows each run S = Q K^T (wgmma, both operands in shared
//    memory) and O += P V (wgmma, P from registers, V read MN-major
//    straight from its (key, d) tile), f32 accumulate.  P is rounded to
//    bf16 for P V, as the TPU kernel does (AV_BF16); l sums the f32 P.
//  - flash_fwd_wgmma_wide_kernel, bf16 with d = 512 (the VAE mid block):
//    the same pipeline with O's dims split over the two consumer
//    warpgroups (comment at the kernel).
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
// A row with no valid key at all writes O = 0 and LSE = -inf.  Keys at
// index >= Skv (TMA zero-fills them, so their scores are 0, not -inf) are
// masked by index.
//
// What bounds it on this card: at the UNet's 64x64 level (d = 64, Sq =
// 4096, Skv = 4096*(1+n)) the work is about 4*Sq*Skv*d FLOPs per head
// against about 2*(Sq + 2*Skv)*d bytes, hundreds of FLOPs per byte, so it
// is compute-bound, at the bf16 tensor-core rate (989 TFLOP/s); the VAE's
// d = 512 more so.  At d = 64 the softmax's one exponential per score
// costs as much MUFU time as the score's 256 tensor-core FLOPs, so the two
// consumer warpgroups overlap one's softmax with the other's products; the
// TMA ring keeps loads off their path.  The FMA kernel runs at the f32
// rate (67 TFLOP/s) at best.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using hopper::TileMeta;

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

// --- bf16: warp-specialised wgmma kernels -----------------------------------
//
// A CTA is three warpgroups: two consumers (threads 0-255) and a producer
// (256-383, of which one warp works).  The producer loads Q once, then
// walks the KV tiles of its batch row (`hopper::kv_ring_produce`, shared
// with the backward's dq kernel): it reads the tile's mask bytes,
// turns them into one bit per key by warp votes (keys at index >= Skv
// invalid), skips a tile with no valid key outright (no load, no product,
// no exponential: its running max is unchanged and alpha = 1, so skipping
// it is bit-identical to computing it), and otherwise waits for a free
// stage of the ring, writes the tile index and its key bits beside it and
// issues TMA loads that complete on the stage's "full" mbarrier.  After
// the last tile it hands over a stage with tile index -1.  The consumers
// run S = Q K^T and O += P V on wgmma (f32 accumulators in registers),
// the online softmax on the S fragments, and release the stage on its
// "empty" mbarrier.  setmaxnreg moves registers from the producer to the
// consumers.

// New running max (scale*log2e units) from the old one and a tile's raw
// row max; alpha rescales the old state (1 while no key was valid).
__device__ __forceinline__ float online_max(float& m, float raw_max, float scale_log2) {
  const float mn = fmaxf(m, raw_max * scale_log2);
  const float alpha = mn == -INFINITY ? 1.f : hopper::ex2(m - mn);
  m = mn;
  return alpha;
}

// p = 2^(s*scale_log2 - m): 0 for a masked key (s = -inf) once m is finite.
__device__ __forceinline__ float softmax_p(float s, float m, float scale_log2) {
  return hopper::ex2(fmaf(s, scale_log2, m == -INFINITY ? 0.f : -m));
}

// The online softmax of one tile's S fragments (rows g and g+8 of the
// warp's 16): masks keys by the tile's bits, updates the running max m
// and sum l, returns the rescale factors alpha of the previous O, and
// writes P in bf16 as the A fragments of P V (k-step kk = keys 16kk..).
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], const uint32_t* bits, int t,
                                             float scale_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1,
                                             uint32_t (&p)[BKV / 16][4]) {
  uint32_t sh[BKV / 32];  // bit 8*(j%4) + e: key 8j + 2t + e of word j/4
#pragma unroll
  for (int w = 0; w < BKV / 32; ++w) sh[w] = bits[w] >> (2 * t);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = (sh[j / 4] >> (8 * (j % 4) + e)) & 1u;
      s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
      s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] : -INFINITY;
      mx0 = fmaxf(mx0, s[4 * j + e]);
      mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
    }
  }
  alpha0 = online_max(m0, quad_max(mx0), scale_log2);
  alpha1 = online_max(m1, quad_max(mx1), scale_log2);
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const float p0 = softmax_p(s[4 * j], m0, scale_log2);
    const float p1 = softmax_p(s[4 * j + 1], m0, scale_log2);
    const float p2 = softmax_p(s[4 * j + 2], m1, scale_log2);
    const float p3 = softmax_p(s[4 * j + 3], m1, scale_log2);
    l0 += p0 + p1;
    l1 += p2 + p3;
    p[j / 2][2 * (j % 2)] = flash::pack_bf16(p0, p1);
    p[j / 2][2 * (j % 2) + 1] = flash::pack_bf16(p2, p3);
  }
}

// d in {16, 32, 64}: 128 query rows per CTA (64 per consumer warpgroup),
// 128-key tiles, a ring of STAGES K+V stages.  Rows are D*2 bytes, so one
// row is one swizzle span (128 B at d = 64, 64 B at 32, 32 B at 16).
template <int D>
struct SmallCfg {
  static constexpr int BQ = 128, BKV = 128, STAGES = 3;
  static constexpr int SPAN = D * 2;
  static constexpr int Q_BYTES = BQ * SPAN;
  static constexpr int KV_BYTES = BKV * SPAN;  // one K or one V tile
  static constexpr int META_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BAR_OFF = META_OFF + STAGES * (int)sizeof(TileMeta);
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2) {
  using namespace hopper;
  using C = SmallCfg<D>;
  constexpr int SPAN = C::SPAN, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + C::Q_BYTES;                 // [STAGES][BKV rows]
  uint8_t* vs = ks + STAGES * C::KV_BYTES;       // [STAGES][BKV rows]
  TileMeta* meta = reinterpret_cast<TileMeta*>(base + C::META_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
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
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      tma_load_4d(qs, &tq, qbar, 0, h, q0, b);
    }
    const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Skv;
    kv_ring_produce<STAGES, BKV>(&tk, &tv, ks, vs, C::KV_BYTES, meta, full, empty, mrow, h, b,
                                 0, (Skv + BKV - 1) / BKV, Skv, lane);
    return;
  }

  // consumer warpgroup c: query rows q0 + 64c ..
  setmaxnreg_inc<232>();
  const int c = tid / 128, warp = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  const uint32_t q_addr = smem_addr(qs + c * 64 * SPAN);
  float acc[D / 2];  // O, rows 16*warp + g (+8), dims 8j + 2t (+1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, scale*log2e units
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums
  mbar_wait(qbar, 0);

  // One tile at a time: S, softmax, P V; the other consumer warpgroup's
  // products overlap this one's softmax where the two drift apart.
  // (Measured slower, PERF.md: ping-pong turns between the two, and S of
  // tile i+1 in flight beside P V of tile i.)
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    if (meta[stage].tile < 0) break;
    uint32_t bits[4];  // read before the product: off the softmax's path
#pragma unroll
    for (int w = 0; w < 4; ++w) bits[w] = meta[stage].bits[w];
    const uint32_t k_addr = smem_addr(ks + stage * C::KV_BYTES);
    float s[BKV / 2];  // S, rows as acc, keys 8j + 2t (+1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, 0>(s, make_desc<SPAN>(q_addr + kk * 32), make_desc<SPAN>(k_addr + kk * 32),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    float alpha0, alpha1;
    uint32_t p[BKV / 16][4];  // P in bf16: the A fragments of P V
    softmax_tile<BKV>(s, bits, t, scale_log2, m0, m1, l0, l1, alpha0, alpha1, p);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha0; acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1; acc[4 * j + 3] *= alpha1;
    }
    wgmma_fence();
    const uint32_t v_addr = smem_addr(vs + stage * C::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<D>(acc, p[kk], make_desc<SPAN>(v_addr + kk * 16 * SPAN), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 64 * c + 16 * warp + g + 8 * half;
    if (row >= Sq) continue;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          flash::pack_bf16(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
    if (t == 0)
      lse[((size_t)b * Sq + row) * H + h] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
  }
}

// d = 512 (the VAE mid block): 64 query rows per CTA, shared by both
// consumer warpgroups, and 64-key tiles.  A 64 x 512 f32 O is 256
// registers a thread in one warpgroup, so warpgroup c keeps O's dims
// 256c..256c+255 (128 registers).  S is split by keys: c computes keys
// 32c..32c+31 of each tile over all 512 dims; the two exchange row maxima
// through shared memory, so both keep the same running max, and write
// their halves of P (bf16) into one shared tile, which each reads whole
// for P V.  Named barriers order the exchange (ids 1 and 2, 256 threads).
// Q (64 KB) and one tile each of K and V (64 KB each) fill 200 KB: a ring
// of two K+V stages does not fit in 227 KB, so K and V are staged
// separately, one buffer each, with their own full/empty barriers: K of
// tile j+1 loads during softmax and P V of tile j, V of tile j+1 during
// S of tile j+1.  Every tile is loaded as eight 64-dim boxes (one
// 128-byte swizzle span each) into eight 64-row sub-tiles.
struct WideCfg {
  static constexpr int D = 512, BQ = 64, BKV = 64, SUB = 64, NSUB = D / SUB;
  static constexpr int SUB_BYTES = 64 * 128;         // one 64-row, 64-dim sub-tile
  static constexpr int TILE_BYTES = NSUB * SUB_BYTES;  // Q, K or V: 64 KB
  static constexpr int P_OFF = 3 * TILE_BYTES;       // P: 64 x 64 bf16, 128-byte swizzle
  static constexpr int RED_OFF = P_OFF + BQ * 128;   // [2][64] f32 row partials
  static constexpr int META_OFF = RED_OFF + 2 * BQ * 4;
  static constexpr int BAR_OFF = META_OFF + (int)sizeof(TileMeta);
  static constexpr int SMEM = BAR_OFF + 5 * 8 + 1024;
};

__global__ void __launch_bounds__(384, 1)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2) {
  using namespace hopper;
  using C = WideCfg;
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + C::TILE_BYTES;
  uint8_t* vs = ks + C::TILE_BYTES;
  uint8_t* ps = base + C::P_OFF;
  float* red = reinterpret_cast<float*>(base + C::RED_OFF);
  TileMeta* meta = reinterpret_cast<TileMeta*>(base + C::META_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t *qbar = bars, *kfull = bars + 1, *kempty = bars + 2, *vfull = bars + 3,
           *vempty = bars + 4;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kfull, 1);
    mbar_init(kempty, 8);
    mbar_init(vfull, 1);
    mbar_init(vempty, 8);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid / 32 != 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, C::TILE_BYTES);
      for (int i = 0; i < C::NSUB; ++i)
        tma_load_4d(qs + i * C::SUB_BYTES, &tq, qbar, i * C::SUB, h, q0, b);
    }
    const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Skv;
    const int ntiles = (Skv + C::BKV - 1) / C::BKV;
    uint32_t phase = 0;
    for (int j = 0; j < ntiles; ++j) {
      uint32_t bits[2];
      if (!tile_bits<2>(bits, mrow, j, Skv, lane)) continue;  // every key masked
      mbar_wait(kempty, phase ^ 1);
      if (lane == 0) {
        meta->tile = j;
        meta->bits[0] = bits[0];
        meta->bits[1] = bits[1];
        mbar_arrive_expect_tx(kfull, C::TILE_BYTES);
        for (int i = 0; i < C::NSUB; ++i)
          tma_load_4d(ks + i * C::SUB_BYTES, &tk, kfull, i * C::SUB, h, j * C::BKV, b);
      }
      __syncwarp();
      mbar_wait(vempty, phase ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(vfull, C::TILE_BYTES);
        for (int i = 0; i < C::NSUB; ++i)
          tma_load_4d(vs + i * C::SUB_BYTES, &tv, vfull, i * C::SUB, h, j * C::BKV, b);
      }
      __syncwarp();
      phase ^= 1;
    }
    mbar_wait(kempty, phase ^ 1);
    if (lane == 0) {
      meta->tile = -1;
      mbar_arrive(kfull);
    }
    return;
  }

  // consumer warpgroup c: keys 32c.. of S, dims 256c.. of O, all 64 rows
  setmaxnreg_inc<232>();
  const int c = tid / 128, warp = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;  // this lane's rows r0, r0 + 8
  const uint32_t q_addr = smem_addr(qs), k_addr = smem_addr(ks) + c * 32 * 128;
  const uint32_t v_addr = smem_addr(vs) + c * 4 * C::SUB_BYTES, p_addr = smem_addr(ps);
  float acc[128];  // O, rows r0 (+8), dims 256c + 8j + 2t (+1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the sums over keys 32c..
  mbar_wait(qbar, 0);

  uint32_t phase = 0;
  for (;;) {
    mbar_wait(kfull, phase);
    if (meta->tile < 0) break;
    const uint32_t sh = meta->bits[c] >> (2 * t);

    float s[16];  // S, rows r0 (+8), keys 32c + 8j + 2t (+1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::SUB_BYTES + (kk % 4) * 32;
      wgmma_ss<32, 0>(s, make_desc<128>(q_addr + off), make_desc<128>(k_addr + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(kempty);

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (sh >> (8 * j + e)) & 1u;
        s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
        s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (t == 0) {
      red[c * 64 + r0] = mx0;
      red[c * 64 + r0 + 8] = mx1;
    }
    named_bar_sync(1, 256);
    // the same expression in both warpgroups: the same running max
    const float alpha0 = online_max(m0, fmaxf(red[r0], red[64 + r0]), scale_log2);
    const float alpha1 = online_max(m1, fmaxf(red[r0 + 8], red[64 + r0 + 8]), scale_log2);
    l0 *= alpha0;
    l1 *= alpha1;
    fence_operands(acc);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[4 * j] *= alpha0; acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1; acc[4 * j + 3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p0 = softmax_p(s[4 * j], m0, scale_log2);
      const float p1 = softmax_p(s[4 * j + 1], m0, scale_log2);
      const float p2 = softmax_p(s[4 * j + 2], m1, scale_log2);
      const float p3 = softmax_p(s[4 * j + 3], m1, scale_log2);
      l0 += p0 + p1;
      l1 += p2 + p3;
      // P[r][key], key = 32c + 8j + 2t: 16-byte chunk (4c + j) ^ (r % 8) of row r
      const int chunk = (4 * c + j) ^ g;
      *reinterpret_cast<uint32_t*>(ps + r0 * 128 + chunk * 16 + 4 * t) = flash::pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + (r0 + 8) * 128 + chunk * 16 + 4 * t) =
          flash::pack_bf16(p2, p3);
    }
    fence_proxy_async();
    named_bar_sync(2, 256);  // both halves of P are in place

    mbar_wait(vfull, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BKV / 16; ++kk)
      wgmma_ss<256, 1>(acc, make_desc<128>(p_addr + kk * 32),
                       make_desc<128>(v_addr + kk * 16 * 128, C::SUB_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty);
    phase ^= 1;
  }

  // full row sums: the quad's lanes, then the other key half's warpgroup
  // (its reads of the max partials ended before the last P barrier)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    red[c * 64 + r0] = l0;
    red[c * 64 + r0 + 8] = l1;
  }
  named_bar_sync(1, 256);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + 8 * half, row = q0 + i;
    if (row >= Sq) continue;
    const float l = red[i] + red[64 + i], m = half ? m1 : m0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = o + (((size_t)b * Sq + row) * H + h) * D + 256 * c;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          flash::pack_bf16(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
    if (c == 0 && t == 0)
      lse[((size_t)b * Sq + row) * H + h] = l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
  }
}

template <typename Kernel>
cudaError_t launch_tma(Kernel kernel, int smem, int box_d, int box_rows, int rows_per_cta,
                       CUtensorMapSwizzle swizzle, const void* q, const void* k,
                       const void* v, const void* mask, void* o, float* lse, int B, int H,
                       int Sq, int Skv, int D, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bshd_map(&tq, q, B, Sq, H, D, box_d, rows_per_cta, swizzle) ||
      !hopper::encode_bshd_map(&tk, k, B, Skv, H, D, box_d, box_rows, swizzle) ||
      !hopper::encode_bshd_map(&tv, v, B, Skv, H, D, box_d, box_rows, swizzle))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + rows_per_cta - 1) / rows_per_cta, B * H);
  kernel<<<grid, 384, smem, stream>>>(tq, tk, tv, static_cast<const uint8_t*>(mask),
                                      static_cast<__nv_bfloat16*>(o), lse, H, Sq, Skv,
                                      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* mask,
                         void* o, float* lse, int B, int H, int Sq, int Skv, float scale,
                         cudaStream_t stream) {
  using C = SmallCfg<D>;
  return launch_tma(flash_fwd_wgmma_kernel<D>, C::SMEM, D, C::BKV, C::BQ,
                    hopper::Swizzle<C::SPAN>::tma, q, k, v, mask, o, lse, B, H, Sq, Skv, D,
                    scale, stream);
}

cudaError_t launch_wgmma_wide(const void* q, const void* k, const void* v, const void* mask,
                              void* o, float* lse, int B, int H, int Sq, int Skv, float scale,
                              cudaStream_t stream) {
  using C = WideCfg;
  return launch_tma(flash_fwd_wgmma_wide_kernel, C::SMEM, C::SUB, C::BKV, C::BQ,
                    CU_TENSOR_MAP_SWIZZLE_128B, q, k, v, mask, o, lse, B, H, Sq, Skv, C::D,
                    scale, stream);
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
    case 16: return launch_wgmma<16>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 32: return launch_wgmma<32>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 64: return launch_wgmma<64>(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
    case 512: return launch_wgmma_wide(q, k, v, mask, o, lse, B, H, Sq, Skv, scale, stream);
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

// Resources of the bf16 kernel at head dim D: registers a thread at launch
// (setmaxnreg then gives the producer warpgroup 40 and the consumers
// 232), dynamic shared memory in bytes and threads per CTA.  Returns the
// CUDA error (0 = cudaSuccess).
extern "C" int flash_attention_fwd_info(int D, int* regs, int* smem, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (D) {
    case 16: err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma_kernel<16>); *smem = SmallCfg<16>::SMEM; break;
    case 32: err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma_kernel<32>); *smem = SmallCfg<32>::SMEM; break;
    case 64: err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma_kernel<64>); *smem = SmallCfg<64>::SMEM; break;
    case 512: err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma_wide_kernel); *smem = WideCfg::SMEM; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *threads = 384;
  return 0;
}
