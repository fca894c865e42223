// The implicit-GEMM core shared by the port's 3x3 convolutions on Hopper
// (sm_90a): in bf16 the fused GroupNorm-apply + SiLU + conv3x3
// (`fused_resnet.cu`) and the stride-2 downsample (`downsample.cu`); in
// int8 the W8A8 conv (`quant_int8.cu`).  The element type is a parameter
// (ESIZE bytes): a 16-byte patch group holds 8 bf16 or 16 int8 channels, a
// wgmma k-step reads 32 bytes of K (m64nNk16 bf16 with f32 accumulators,
// m64nNk32 s8 with s32 ones), and the byte geometry is the same.
//
// GEMM view: M = output pixels, N = Cout, K = 9 taps x Cin.  A CTA owns a
// 16 x 16 tile of output pixels of one image and BN output channels, and
// walks Cin in chunks of BK channels.  Per chunk it holds, in one stage of
// a ring in shared memory:
//
//  - the chunk's weights for all nine taps, [tap][BN rows][BK channels],
//    one TMA load of a (BK, BN, 9) box (from the wrapper's [tap][Cout][Cin]
//    bf16 repack, or the int8 (Cout, 3, 3, Cin) weights in place), rows
//    swizzled by the BK*ESIZE-byte span: the K-major B operand.
//    Channels past Cin and rows past Cout are TMA's zero fill;
//  - the tile's input patch, [16-byte channel group][position][16 bytes]:
//    the no-swizzle core-matrix layout, in which a window that starts at any
//    position is a valid wgmma A descriptor.  So each of the nine taps
//    reads its shifted (or, at stride 2, strided) window of the one patch
//    in place: no copy per tap.  Producer threads fill it with 16-byte
//    cp.async copies, zero-filled by coordinate outside the image and past
//    Cin, so both operands are zero past Cin (a stale NaN in shared memory
//    never meets a zero weight).
//
// A CTA is three warpgroups.  The producer warpgroup (threads 256..383)
// fills the stages: all 128 threads copy each chunk's patch, one of them
// issues the weights' TMA load, and the copies arrive on the stage's "full"
// mbarrier as they land (cp.async.mbarrier.arrive.noinc).  The fused
// conv's patch is transformed in place (affine, SiLU, padding mask, bf16
// rounding) by the consumers themselves, chunk k + 1's while the tensor
// cores run chunk k's products, which leaves the producer nothing but
// copies (a transform in the producer held the tensor cores back by a
// third).  The two consumer warpgroups each own 8 tile rows: two 8 x 8
// pixel blocks, each one m64
// wgmma block (row 8i + j = pixel (i, j) of the block: 8-row groups one
// patch row apart, a constant stride), with f32 (bf16) or s32 (int8)
// accumulators of both blocks in registers (BN = 128: 128 a thread).  They issue a chunk's
// 9 x (SPAN / 32) x 2 products as one wgmma group, release the previous
// chunk's stage when that group's predecessor is done (so the tensor
// cores see the next chunk's products queued behind the current ones),
// and run the kernel's own epilogue on the accumulators.  No K is split
// across CTAs and nothing is atomic: every output, and every statistics
// partial, is a fixed function of its inputs, whatever the grid.
//
// The grid is persistent (one CTA per SM, or two for the fused conv's
// heads, walks work items: a tile and an N block), and the ring runs on
// across items, so the producer fills the next item's first chunks while
// the consumers run an epilogue.
//
// Why 256 pixels a CTA: every pixel tile re-reads all nine taps' weights
// from L2 (at 128 -> 128 channels, 295 KB against 83 KB of patch), so the
// weight traffic per pixel halves with each doubling of the tile.

#pragma once

#include <type_traits>

#include "hopper_common.cuh"

namespace conv {

constexpr int kThreads = 384;  // two consumer warpgroups + one producer warpgroup
constexpr int kTile = 16;      // output tile: 16 x 16 pixels

// BK: input channels per chunk; BN: output channels per CTA; NPOS: patch
// positions; STAGES: ring depth; EXTRA: bytes of the kernel's own scratch
// (at EXTRA_OFF) after the ring; ESIZE: bytes an element (2: bf16 with f32
// accumulators, 1: int8 with s32 ones).
template <int BK_, int BN_, int NPOS_, int STAGES_, int EXTRA_, int ESIZE_ = 2>
struct Cfg {
  static constexpr int BK = BK_, BN = BN_, NPOS = NPOS_, STAGES = STAGES_, ESIZE = ESIZE_;
  using Acc = std::conditional_t<ESIZE == 1, int32_t, float>;
  static constexpr int CPG = 16 / ESIZE;            // channels of a 16-byte group
  static constexpr int G = BK / CPG;                // 16-byte groups a chunk
  static constexpr int SPAN = BK * ESIZE;           // weight row bytes = swizzle span
  static constexpr int KSTEPS = SPAN / 32;          // wgmma k-steps a chunk (32 bytes of K)
  static constexpr int W_BYTES = 9 * BN * SPAN;     // a chunk's weights
  static constexpr int PATCH_OFF = (W_BYTES + 1023) / 1024 * 1024;
  static constexpr int LBO = NPOS * 16;             // between 16-byte groups
  static constexpr int PATCH_BYTES = G * LBO;
  static constexpr int STAGE_BYTES = (PATCH_OFF + PATCH_BYTES + 1023) / 1024 * 1024;
  static constexpr int EXTRA_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = EXTRA_OFF + EXTRA_;
  static constexpr int N_BARS = 2 * STAGES + 2;     // full, empty per stage; 2 of the kernel's
  static constexpr int SMEM = BAR_OFF + N_BARS * 8 + 1024;  // + alignment slack
  static constexpr int ITEMS = G * NPOS;            // 16-byte copies a chunk
  static_assert(ESIZE == 1 || ESIZE == 2, "bf16 or int8");
  static_assert(SPAN % 32 == 0, "chunk shape");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int SPAN>
constexpr CUtensorMapSwizzle swizzle_of() { return hopper::Swizzle<SPAN>::tma; }

// Host: the tensor map of the repacked weights [9][Cout][Cin] (bf16) as the
// 3-D tensor (Cin, Cout, 9), boxes of (bk, bn, 9): one chunk, all taps.
inline bool encode_weight_map(CUtensorMap* map, const void* w, int Cin, int Cout, int bk,
                              int bn, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cout * Cin * 2};
  const cuuint32_t box[3] = {(cuuint32_t)bk, (cuuint32_t)bn, 9};
  return hopper::encode_tiled(map, w, 3, dims, strides, box, swizzle);
}

// Host: the tensor map of int8 weights in their own (Cout, 3, 3, Cin)
// layout, read in place as the 3-D tensor (Cin, Cout, 9) with byte strides
// (9 * Cin, Cin) (multiples of 16 when Cin % 16 == 0), boxes of (bk, bn, 9):
// one chunk, all taps, in the [tap][bn][bk] order of the bf16 repack.
inline bool encode_weight_map_s8(CUtensorMap* map, const void* w, int Cin, int Cout, int bk,
                                 int bn, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * 9, (cuuint64_t)Cin};
  const cuuint32_t box[3] = {(cuuint32_t)bk, (cuuint32_t)bn, 9};
  return hopper::encode_tiled(map, w, 3, dims, strides, box, swizzle,
                              CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

// Host: the persistent grid, `per_sm` CTAs an SM (at most one per work item).
inline int persistent_grid(long long items, int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ctas = (long long)sms * per_sm;
  return (int)(items < ctas ? items : ctas);
}

// 1024-aligned base of the dynamic shared memory.  An offset added to the
// shared array itself (not a round trip through an integer) keeps the
// pointer in the shared space, so accesses through it compile to LDS/STS
// with 32-bit addresses, not to generic loads and stores.
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

// A CTA walks its work items (tiles x N blocks) and each item's chunks;
// `q` counts the chunks of the walk so far: chunk q sits in stage
// q % STAGES, in phase (q / STAGES) & 1 of its barriers.
// A work item: image b, output tile (h0, w0), N block n0.  Items are
// numbered with N blocks fastest, so a tile's N blocks run side by side
// and share its patch in L2.
struct Item {
  int b, h0, w0, n0;
};
__device__ __forceinline__ Item item_of(int i, int n_blocks, int tiles_w, int tiles_per_img,
                                        int bn) {
  const int tile = (i / n_blocks) % tiles_per_img;
  return {i / n_blocks / tiles_per_img, (tile / tiles_w) * kTile, (tile % tiles_w) * kTile,
          (i % n_blocks) * bn};
}

// Thread 0: "full" expects the producer warpgroup's 128 copy arrivals and
// the weights' TMA arrival; "empty" the 8 consumer warps'.
template <class C>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < C::STAGES; ++s) {
    hopper::mbar_init(&full[s], 129);
    hopper::mbar_init(&empty[s], 8);
  }
}

// The producer warpgroup (thread p of 128) over the CTA's work items
// (blockIdx.x, + gridDim.x, ... < n_items) and each item's `nchunks`
// chunks: for each, once the stage is free, thread 0 issues the weights'
// TMA load and all 128 copy the patch, 16 bytes a copy, arriving on the
// stage's "full" barrier as their copies land.  make_fill(item) gives the
// item's Fill:
//   x             any valid global address (the source of a zero fill);
//   src(pos, c)   the global address of channels c..c+CPG-1 (16 bytes) at
//                 patch position pos, or nullptr where they are zero.
// after_item(item, r) runs on all 128 threads after the r-th item's chunks.
template <class C, class MakeFill, class AfterItem>
__device__ __forceinline__ void produce(const CUtensorMap* tw, uint8_t* base, uint64_t* full,
                                        uint64_t* empty, int nchunks, int p, int n_items,
                                        int n_blocks, int tiles_w, int tiles_per_img,
                                        MakeFill make_fill, AfterItem after_item) {
  using namespace hopper;
  constexpr int ITERS = (C::ITEMS + 127) / 128;
  static_assert(128 % C::G == 0, "a thread's channel group is fixed");
  const int grp = p % C::G;
  uint32_t q = 0, r = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++r) {
    const Item item = item_of(i, n_blocks, tiles_w, tiles_per_img, C::BN);
    const auto fill = make_fill(item);
    for (int k = 0; k < nchunks; ++k, ++q) {
      const int s = q % C::STAGES;
      mbar_wait(&empty[s], ((q / C::STAGES) & 1) ^ 1);
      uint8_t* st = base + s * C::STAGE_BYTES;
      if (p == 0) {
        mbar_arrive_expect_tx(&full[s], C::W_BYTES);
        tma_load_3d(st, tw, &full[s], k * C::BK, item.n0, 0);
      }
      uint8_t* patch = st + C::PATCH_OFF + grp * C::LBO;
      const int c0 = k * C::BK + grp * C::CPG;
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int idx = p + it * 128;
        if (idx < C::ITEMS) {
          const void* src = fill.src(idx / C::G, c0);
          cp_async_16(patch + (idx / C::G) * 16, src ? src : fill.x, src ? 16 : 0);
        }
      }
      cp_async_arrive_noinc(&full[s]);
    }
    after_item(item, r);
  }
}

// No transform of the patch (the downsample's).
struct NoPrep {
  static constexpr bool kActive = false;
  struct Coef {};
  __device__ __forceinline__ Coef load(int, int) const { return {}; }
  __device__ __forceinline__ void operator()(uint8_t*, int, int, const Coef&) const {}
};

// A consumer warpgroup, one item's `nchunks` chunks: acc[mb] = the m64
// block mb (of 2) x the chunks' weights, over the nine taps.  a_off(tap,
// mb): byte offset in a 16-byte-group plane of the patch of the block's
// first row at that tap; sbo: bytes between the block's 8-row groups.
// Each stage is released once the products of the chunk after it are
// queued and its own are done.  With an active Prep, the two consumer
// warpgroups (thread ct of 256) transform each chunk's patch in place,
// prep(patch, k, ct, prep.load(k, ct)), before its products: chunk k + 1's
// while chunk k's products run on the tensor cores (its coefficients'
// loads issued before the wait for chunk k - 1's products); a barrier over
// both warpgroups (id 3) then hands it to the products.
template <class C, class AOff, class Prep>
__device__ __forceinline__ void consume_item(typename C::Acc (&acc)[2][C::BN / 2], uint8_t* base,
                                             uint64_t* full, uint64_t* empty, int nchunks,
                                             uint32_t sbo, int lane, int ct, AOff a_off,
                                             const Prep& prep, uint32_t& q) {
  using namespace hopper;
  auto stage = [&](uint32_t qq) { return base + (qq % C::STAGES) * C::STAGE_BYTES; };
  // chunk qq (k of the item) may be multiplied
  auto ready = [&](uint32_t qq, int k, const typename Prep::Coef& cf) {
    mbar_wait(&full[qq % C::STAGES], (qq / C::STAGES) & 1);
    if constexpr (Prep::kActive) {
      prep(stage(qq) + C::PATCH_OFF, k, ct, cf);
      fence_proxy_async();  // the patch's generic-proxy stores, before wgmma reads them
      named_bar_sync(3, 256);
    } else {
      fence_proxy_async();  // cp.async stores (generic proxy) before the wgmma reads
    }
  };
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) acc[mb][i] = 0;
  if constexpr (Prep::kActive) ready(q, 0, prep.load(0, ct));
  for (int k = 0; k < nchunks; ++k, ++q) {
    if constexpr (!Prep::kActive) ready(q, k, {});
    const uint32_t w_addr = smem_addr(stage(q));
    const uint32_t p_addr = w_addr + C::PATCH_OFF;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int ks = 0; ks < C::KSTEPS; ++ks)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const uint64_t da =
              make_desc_plain(p_addr + a_off(tap, mb) + ks * 2 * C::LBO, C::LBO, sbo);
          const uint64_t db = make_desc<C::SPAN>(w_addr + tap * C::BN * C::SPAN + ks * 32);
          if constexpr (C::ESIZE == 1)
            wgmma_s8<C::BN>(acc[mb], da, db, 1);
          else
            wgmma_ss<C::BN, 0>(acc[mb], da, db, 1);
        }
    wgmma_commit();
    typename Prep::Coef cf;
    if constexpr (Prep::kActive)
      if (k + 1 < nchunks) cf = prep.load(k + 1, ct);
    if (k > 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(q - 1) % C::STAGES]);
    }
    if constexpr (Prep::kActive)
      if (k + 1 < nchunks) ready(q + 1, k + 1, cf);
  }
  wgmma_wait<0>();
  fence_operands(acc[0]);
  fence_operands(acc[1]);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[(q - 1) % C::STAGES]);
}

}  // namespace conv
