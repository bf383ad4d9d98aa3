// The bf16 attention backward on Hopper's tensor cores, D = 64 and 128: the
// dkv and dq kernels, dense (included by flash_attention_bwd.cu) and under
// the segment mask (SEG, included by flash_attention_seg_bwd.cu).  f32 and
// D = 256 keep the CUDA-core body of attention_bwd_tile.cuh (at D = 256 the
// dkv accumulators alone, dK and dV, are 256 f32 registers a thread).
// Tiles, operand descriptors and fragment layouts: hopper.cuh.
//
// Replaces the TPU kernels paddle_tpu/incubate/kernels/flash_attention.py::
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel, and under SEG
// _flash_bwd_seg_dkv_kernel and _flash_bwd_seg_dq_kernel, with their
// rounding: s =
// (q . k) * scale and p = exp(s - lse) in f32 (here exp2 of s * scale *
// log2 e - lse * log2 e); p is rounded to bf16 before dV += p^T dO; dS = p *
// (dP - delta) * scale is rounded to bf16 before dK += dS^T Q and dQ += dS K;
// every product accumulates in f32.  Causal is row >= col with S == Sk (the
// wrapper checks).
//
// Bound on the H100: at [4, 2048, 16, 128] causal the pair does 5 products
// of 2 * D flops for each visible (query, key) pair, ~172 GFLOP against ~80
// MB of traffic, so it is bound by the tensor cores' 989 TFLOP/s.  Both
// kernels recompute S and dP (7 products in all, as the TPU split does) so
// that each output tile has one owner: no atomics, and two calls on the
// same inputs give the same bits.
//
// A block is one producer warp and kWG consumer warpgroups of 64 rows.  The
// producer loads the block's own tiles once by TMA (one mbarrier), then
// feeds a ring of kStages stages of the other operand pair along the walk
// (full/empty mbarriers, as the forward); the consumers run every product
// on wgmma m64n64k16 with f32 accumulators in registers.
//
// dq: a block owns kM query rows (Q, dO once) and walks key tiles (K, V in
// the ring) up to the diagonal when causal, the longest query tiles first.
//   S = Q K^T and dP = dO V^T: two K-major wgmma_ss chains, one commit.
//   p and dS on the fragments; lse and delta are per row, in registers.
//   dQ += dS K: dS packed to bf16 A fragments in place, K MN-major.
// dkv: a block owns kM keys (K, V once) and walks query tiles (Q, dO and
// their lse * log2 e and delta, staged by the producer warp's lanes beside
// the tile) from the diagonal tile when causal.
//   S^T = K Q^T and dP^T = V dO^T: two K-major wgmma_ss chains.
//   p^T and dS^T on the fragments; lse and delta index the columns, so
//   each thread reads its 16 columns' values from the stage.
//   dV += P^T dO and dK += dS^T Q: bf16 A fragments, dO and Q MN-major.
// Masks: the diagonal tile (row >= col) and the ragged key tile of dq
// (col < Sk) are masked element by element with exp2(-1e30) = 0; a query
// row past S takes lse = 1e30, so its p is 0 exactly without a test, and
// its zero-filled dO gives dP = 0.
//
// SEG (a compile-time lane: the dense instantiations keep their
// instructions).  A pair is visible where seg_q[row] == seg_k[col] as well.
// The producer warp walks as the forward's does: the block's owned rows
// (queries for dq, keys for dkv) give [min, max] of their ids, each lane
// judges one candidate tile of the walk by its own ids' range, and a tile
// whose range is disjoint is skipped (no equal pair there, so this is
// exact for unsorted ids; the causal tiles are skipped as in the dense
// walk).  The walk's length is known only to the producer, so it writes
// each kept tile's index beside the stage and ends with -1 (`tile_of`).
// Every producer lane stages the tile's 64 ids beside it (and dkv's row
// stats), so the ids of the walked axis come from shared memory as int2
// pairs, and the owned rows' two ids a thread stay in registers.  Every
// kept tile is masked element by element, after lse is subtracted: a row
// that sees no key has lse ~ -1e30, so masking s before the subtraction
// would give exp2(0) = 1.  An owner whose walk is empty writes zeros.
#pragma once

#include <climits>

#include "hopper.cuh"

namespace ptt {
namespace wg {

// Registers decide kWG: at more than 160 threads ptxas caps a thread at 168
// registers.  dq holds dQ (D / 2 a thread) beside S and dP (32 each); dkv
// holds dK and dV (D each) beside S^T and dP^T, so it runs one warpgroup
// (160 threads, up to 255 registers).
template <int HD, bool DKV, bool SEG> struct BwdCfg {
  static constexpr int kWG = DKV ? 1 : 2;                // consumer warpgroups
  static constexpr int kM = 64 * kWG;                    // rows a block owns
  static constexpr int kNC = HD / 64;                    // 64-column blocks
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr int kThreads = kWG * 128 + 32;        // + producer warp
  static constexpr int kTileBytes = 64 * HD * 2;         // one ring tile
  static constexpr int kOwnBytes = kM * HD * 2;          // one owned tile
  static constexpr int kSegWord = DKV ? 128 : 0;         // ids in a stage
  static constexpr int kStatWords = kSegWord + (SEG ? 64 : 0);
  static constexpr int kStatBytes = 4 * kStatWords;  // lse2, delta; seg ids
  static constexpr size_t kSmem = 1024 + 2 * kOwnBytes +
                                  kStages * (2 * kTileBytes + kStatBytes) +
                                  256;          // align, barriers, tile_of
};

// Shared memory of a block: its own two tiles, the ring's two tiles a stage,
// the stages' words (dkv: row stats; SEG: segment ids), then the barriers
// and (SEG) the index of the tile in each stage.
template <class C> struct BwdSmem {
  uint8_t* own0;     // Q (dq) or K (dkv)
  uint8_t* own1;     // dO (dq) or V (dkv)
  uint8_t* ring0;    // K (dq) or Q (dkv), kStages tiles
  uint8_t* ring1;    // V (dq) or dO (dkv)
  // kStages x [dkv: lse * log2 e (64), delta (64); SEG: seg ids (64)]
  float* stats;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_bar;
  int* tile_of;      // SEG: the stage's tile, -1 at the end of the walk
  __device__ explicit BwdSmem(uint8_t* raw) {
    own0 = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    own1 = own0 + C::kOwnBytes;
    ring0 = own1 + C::kOwnBytes;
    ring1 = ring0 + C::kStages * C::kTileBytes;
    stats = reinterpret_cast<float*>(ring1 + C::kStages * C::kTileBytes);
    full = reinterpret_cast<uint64_t*>(ring1 + C::kStages * C::kTileBytes +
                                       C::kStages * C::kStatBytes);
    empty = full + C::kStages;
    own_bar = empty + C::kStages;
    tile_of = reinterpret_cast<int*>(own_bar + 1);
  }
  __device__ int* seg_ids(int stage) const {
    return reinterpret_cast<int*>(stats + stage * C::kStatWords) +
           C::kSegWord;
  }
};

// Barrier set-up: `full` takes `full_count` arrivals plus the copies' bytes,
// `empty` one arrival per consumer warp.
template <class C>
__device__ __forceinline__ void init_barriers(const BwdSmem<C>& sm,
                                              int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sm.full[s], full_count);
      mbar_init(&sm.empty[s], 4 * C::kWG);
    }
    mbar_init(sm.own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The block's own two [kM x HD] tiles at rows r0.. of one (b, h), once.
template <class C>
__device__ __forceinline__ void load_own(const BwdSmem<C>& sm,
                                         const CUtensorMap* t0,
                                         const CUtensorMap* t1, int h, int r0,
                                         int b) {
  mbar_expect_tx(sm.own_bar, 2 * C::kOwnBytes);
  for (int g = 0; g < C::kWG; ++g)
    for (int c = 0; c < C::kNC; ++c) {
      const int o = (g * C::kNC + c) * kBlockBytes;
      tma_load(sm.own0 + o, t0, sm.own_bar, 64 * c, h, r0 + 64 * g, b);
      tma_load(sm.own1 + o, t1, sm.own_bar, 64 * c, h, r0 + 64 * g, b);
    }
}

// Stage `stage` of the ring: the two [64 x HD] tiles at rows 64 * t.
template <class C>
__device__ __forceinline__ void load_ring(const BwdSmem<C>& sm, int stage,
                                          const CUtensorMap* t0,
                                          const CUtensorMap* t1, int h, int t,
                                          int b) {
  mbar_expect_tx(&sm.full[stage], 2 * C::kTileBytes);
  for (int c = 0; c < C::kNC; ++c) {
    const int o = stage * C::kTileBytes + c * kBlockBytes;
    tma_load(sm.ring0 + o, t0, &sm.full[stage], 64 * c, h, 64 * t, b);
    tma_load(sm.ring1 + o, t1, &sm.full[stage], 64 * c, h, 64 * t, b);
  }
}

// acc = A0 B0^T and acc2 = A1 B1^T over HD, all four operands K-major
// [64 x HD] tiles in shared memory; waits for both.
template <int HD>
__device__ __forceinline__ void two_products(float (&acc)[32],
                                             float (&acc2)[32], uint32_t a0,
                                             uint32_t b0, uint32_t a1,
                                             uint32_t b1) {
  fence_regs(acc);
  fence_regs(acc2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(acc, desc_k(a0, kk), desc_k(b0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(acc2, desc_k(a1, kk), desc_k(b1, kk), kk > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  fence_regs(acc2);
}

// [min, max] of ids[p0 .. p1 - 1] over the 32 lanes of a warp.
__device__ __forceinline__ int2 seg_range(const int* __restrict__ ids, int p0,
                                          int p1, int lane) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int p = p0 + lane; p < p1; p += 32) {
    lo = min(lo, ids[p]);
    hi = max(hi, ids[p]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// The SEG producer's walk, on all 32 lanes of the producer warp: of the
// 64-position tiles t_first.. that start before `end` in `ids` (one batch
// row of the walked axis's segment ids), each lane judges one tile a round
// by its ids' range against the owned rows' `own`, and the kept tiles go
// through the ring in order.  Every lane stages the tile's ids (0 past
// `end`; the row/col bounds mask those) and calls `fill(stage, tile)`,
// which stages more and arrives on `full` (lane 0 with the copies).  Then
// the -1 sentinel, with all 32 arrivals.
template <class C, class Fill>
__device__ __forceinline__ void seg_walk(const BwdSmem<C>& sm,
                                         const int* __restrict__ ids,
                                         int t_first, int end, int2 own,
                                         int lane, Fill&& fill) {
  const int n_tiles = (end + 63) / 64;
  int stage = 0;
  uint32_t phase = 0;
  for (int t0 = t_first; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    bool keep = false;
    if (t < n_tiles) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int c = 64 * t; c < min(64 * t + 64, end); ++c) {
        lo = min(lo, ids[c]);
        hi = max(hi, ids[c]);
      }
      keep = hi >= own.x && lo <= own.y;
    }
    // the same mask on every lane: the whole warp stages each kept tile
    for (unsigned todo = __ballot_sync(0xffffffffu, keep); todo;
         todo &= todo - 1) {
      const int tile = t0 + __ffs(todo) - 1;
      mbar_wait(&sm.empty[stage], phase ^ 1);
      int* sid = sm.seg_ids(stage);
      for (int i = lane; i < 64; i += 32) {
        const int c = 64 * tile + i;
        sid[i] = c < end ? ids[c] : 0;
      }
      if (lane == 0) sm.tile_of[stage] = tile;
      fill(stage, tile);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);       // end of the walk
  if (lane == 0) sm.tile_of[stage] = -1;
  mbar_arrive(&sm.full[stage]);
}

// seg_q [B, S] and seg_k [B, Sk] int32 are read under SEG only.
template <int HD, bool SEG>
__global__ void __launch_bounds__(BwdCfg<HD, false, SEG>::kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg_q,
                   const int* __restrict__ seg_k,
                   __nv_bfloat16* __restrict__ dq, int S, int Sk, int H,
                   int causal, float scale) {
  using C = BwdCfg<HD, false, SEG>;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<C> sm(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * C::kM;   // longest first
  const int kv_end = causal ? min(r0 + C::kM, S) : Sk;
  const int n_tiles = (kv_end + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm, SEG ? 32 : 1);

  if (warp == 4 * C::kWG) {
    // ---- producer warp: Q and dO once, then the K/V ring ----
    if constexpr (SEG) {
      if (lane == 0) load_own(sm, &tq, &tdo, h, r0, b);
      const int2 own =
          seg_range(seg_q + (size_t)b * S, r0, min(r0 + C::kM, S), lane);
      seg_walk(sm, seg_k + (size_t)b * Sk, 0, kv_end, own, lane,
               [&](int stage, int t) {
                 if (lane == 0)
                   load_ring(sm, stage, &tk, &tv, h, t, b);
                 else
                   mbar_arrive(&sm.full[stage]);
               });
    } else if (lane == 0) {
      load_own(sm, &tq, &tdo, h, r0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        load_ring(sm, stage, &tk, &tv, h, t, b);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int g = warp / 4, w = warp % 4;
  const int g_row0 = r0 + 64 * g;
  const int row0 = g_row0 + 16 * w + lane / 4, row1 = row0 + 8;
  // keys this warpgroup's rows can see end before g_end
  const int g_end = g_row0 >= S ? 0 : (causal ? min(g_row0 + 64, S) : Sk);
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
  int sq[2];                                  // SEG: the two rows' ids
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    lse2[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e : -kNegInf;
    dl[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    if constexpr (SEG) sq[r] = row < S ? seg_q[(size_t)b * S + row] : 0;
  }

  float acc[C::kNC][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int n = 0; n < C::kNC; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  const uint32_t qaddr = smem_u32(sm.own0 + g * C::kNC * kBlockBytes);
  const uint32_t doaddr = smem_u32(sm.own1 + g * C::kNC * kBlockBytes);

  mbar_wait(sm.own_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  // dense: in lockstep with the producer; SEG: the tile it wrote beside
  // the stage, -1 at the end of the walk
  for (int it = 0; SEG || it < n_tiles; ++it) {
    mbar_wait(&sm.full[stage], phase);
    const int t = SEG ? sm.tile_of[stage] : it;
    if (SEG && t < 0) break;
    const int k0 = 64 * t;
    if (k0 < g_end) {
      const uint32_t kaddr = smem_u32(sm.ring0 + stage * C::kTileBytes);
      const uint32_t vaddr = smem_u32(sm.ring1 + stage * C::kTileBytes);
      two_products<HD>(s, dp, qaddr, kaddr, doaddr, vaddr);

      // p = exp2(s * scale * log2 e - lse * log2 e); dS = p (dP - delta) scale
      const bool masked = k0 + 64 > Sk || (causal && k0 + 63 > g_row0);
      const int* sid = sm.seg_ids(stage);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = fmaf(s[i], sl2, -lse2[r]);
        if (masked) {
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (col >= Sk || (causal && col > (r ? row1 : row0))) x = kNegInf;
        }
        if constexpr (SEG) {                  // the two columns' ids
          const int2 ids = *reinterpret_cast<const int2*>(
              sid + 8 * (i >> 2) + 2 * (lane & 3));
          if (((i & 1) ? ids.y : ids.x) != sq[r]) x = kNegInf;
        }
        const float p = ex2(x);
        dp[i] = p * (dp[i] - dl[r]) * scale;
      }

      // dQ += dS K (dS bf16 from registers, K MN-major)
      uint32_t da[4][4];
      to_frags(dp, da);
#pragma unroll
      for (int n = 0; n < C::kNC; ++n) fence_regs(acc[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < C::kNC; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc[n], da[kk], desc_mn(kaddr, n, kk));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int n = 0; n < C::kNC; ++n) fence_regs(acc[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* o0 = dq + (((size_t)b * S + row0) * H + h) * HD;
  __nv_bfloat16* o1 = dq + (((size_t)b * S + row1) * H + h) * HD;
#pragma unroll
  for (int n = 0; n < C::kNC; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * n + 8 * j + 2 * (lane & 3);
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(acc[n][4 * j], acc[n][4 * j + 1]);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(acc[n][4 * j + 2], acc[n][4 * j + 3]);
    }
}

template <int HD, bool SEG>
__global__ void __launch_bounds__(BwdCfg<HD, true, SEG>::kThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int S, int Sk, int H,
                    int causal, float scale) {
  using C = BwdCfg<HD, true, SEG>;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<C> sm(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * C::kM;                     // longest first
  const int t_first = causal ? k0 / 64 : 0;              // S == Sk if causal
  const int n_tiles = (S + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm, 32);                 // every producer lane arrives

  if (warp == 4 * C::kWG) {
    // ---- producer warp: K and V once, then the Q/dO ring with each query
    // tile's lse * log2 e and delta (1e30 past S: p = 0 there) ----
    if (lane == 0) load_own(sm, &tk, &tv, h, k0, b);
    auto fill = [&](int stage, int t) {
      float* st = sm.stats + stage * C::kStatWords;
      for (int i = lane; i < 64; i += 32) {
        const int row = 64 * t + i;
        const bool in = row < S;
        st[i] = in ? lse[(size_t)bh * S + row] * kLog2e : -kNegInf;
        st[64 + i] = in ? delta[(size_t)bh * S + row] : 0.f;
      }
      if (lane == 0)
        load_ring(sm, stage, &tq, &tdo, h, t, b);
      else
        mbar_arrive(&sm.full[stage]);
    };
    if constexpr (SEG) {
      const int2 own =
          seg_range(seg_k + (size_t)b * Sk, k0, min(k0 + C::kM, Sk), lane);
      seg_walk(sm, seg_q + (size_t)b * S, t_first, S, own, lane, fill);
    } else {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_first; t < n_tiles; ++t) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        fill(stage, t);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int g = warp / 4, w = warp % 4;
  const int g_k0 = k0 + 64 * g;
  const int key0 = g_k0 + 16 * w + lane / 4;   // this thread's keys: +0, +8
  const float sl2 = scale * kLog2e;
  int sk[2];                                  // SEG: the two keys' ids
  if constexpr (SEG)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      sk[hh] = key < Sk ? seg_k[(size_t)b * Sk + key] : 0;
    }

  float dka[C::kNC][32], dva[C::kNC][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int n = 0; n < C::kNC; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[n][i] = dva[n][i] = 0.f;
  const uint32_t kaddr = smem_u32(sm.own0 + g * C::kNC * kBlockBytes);
  const uint32_t vaddr = smem_u32(sm.own1 + g * C::kNC * kBlockBytes);

  mbar_wait(sm.own_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = t_first; SEG || it < n_tiles; ++it) {   // as in dq
    mbar_wait(&sm.full[stage], phase);
    const int t = SEG ? sm.tile_of[stage] : it;
    if (SEG && t < 0) break;
    const int q0 = 64 * t;
    // does this warpgroup see any (query, key) pair of the tile?
    if (g_k0 < Sk && !(causal && q0 + 63 < g_k0)) {
      const uint32_t qaddr = smem_u32(sm.ring0 + stage * C::kTileBytes);
      const uint32_t doaddr = smem_u32(sm.ring1 + stage * C::kTileBytes);
      two_products<HD>(s, dp, kaddr, qaddr, vaddr, doaddr);

      // p^T and dS^T; column c of the tile is query q0 + c
      const float* st = sm.stats + stage * C::kStatWords;
      const int* sid = sm.seg_ids(stage);
      const bool diag = causal && q0 < g_k0 + 63;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(st + c);
        const float2 d2 = *reinterpret_cast<const float2*>(st + 64 + c);
        int2 ids = make_int2(0, 0);                // the two queries' ids
        if constexpr (SEG) ids = *reinterpret_cast<const int2*>(sid + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            float x = fmaf(s[i], sl2, -(e ? l2.y : l2.x));
            if (diag && key0 + 8 * hh > q0 + c + e) x = kNegInf;
            if constexpr (SEG)
              if ((e ? ids.y : ids.x) != sk[hh]) x = kNegInf;
            const float p = ex2(x);
            dp[i] = p * (dp[i] - (e ? d2.y : d2.x)) * scale;
            s[i] = p;
          }
      }

      // dV += P^T dO and dK += dS^T Q (bf16 from registers, MN-major B)
      uint32_t pa[4][4], da[4][4];
      to_frags(s, pa);
      to_frags(dp, da);
#pragma unroll
      for (int n = 0; n < C::kNC; ++n) {
        fence_regs(dva[n]);
        fence_regs(dka[n]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < C::kNC; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dva[n], pa[kk], desc_mn(doaddr, n, kk));
#pragma unroll
      for (int n = 0; n < C::kNC; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dka[n], da[kk], desc_mn(qaddr, n, kk));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int n = 0; n < C::kNC; ++n) {
        fence_regs(dva[n]);
        fence_regs(dka[n]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= Sk) continue;
    const size_t o = (((size_t)b * Sk + key) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < C::kNC; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j + 2 * (lane & 3);
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(dk + o + col) =
            pack_bf16(dka[n][i], dka[n][i + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + col) =
            pack_bf16(dva[n][i], dva[n][i + 1]);
      }
  }
}

// Tensor maps over q, k, v, dO ([B, S|Sk, H, HD] bf16).
inline bool bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                     const void* v, const void* dout, int B, int S, int Sk,
                     int H, int HD) {
  return tensor_map(&m[0], q, B, S, H, HD) &&
         tensor_map(&m[1], k, B, Sk, H, HD) &&
         tensor_map(&m[2], v, B, Sk, H, HD) &&
         tensor_map(&m[3], dout, B, S, H, HD);
}

// seg_q/seg_k: int32 [B, S] and [B, Sk] under SEG, unread (null) dense.
template <int HD, bool SEG>
cudaError_t run_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* seg_q, const void* seg_k, void* dq, int B,
                       int S, int Sk, int H, int causal, float scale,
                       cudaStream_t stream) {
  using C = BwdCfg<HD, false, SEG>;
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, B, S, Sk, H, HD))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_wgmma<HD, SEG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + C::kM - 1) / C::kM);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<__nv_bfloat16*>(dq), S, Sk,
      H, causal, scale);
  return cudaGetLastError();
}

template <int HD, bool SEG>
cudaError_t run_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* seg_q, const void* seg_k, void* dk,
                        void* dv, int B, int S, int Sk, int H, int causal,
                        float scale, cudaStream_t stream) {
  using C = BwdCfg<HD, true, SEG>;
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, B, S, Sk, H, HD))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_wgmma<HD, SEG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sk + C::kM - 1) / C::kM);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Sk, H, causal, scale);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace ptt
