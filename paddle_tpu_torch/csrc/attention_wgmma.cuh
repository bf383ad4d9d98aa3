// The bf16 attention forward on Hopper's tensor cores: a block of one
// producer warp and kWG consumer warpgroups (two, one for D = 256), each
// warpgroup owning 64 query rows.  Included by flash_attention.cu only; the
// f32 kernels keep the CUDA-core body of attention_tile.cuh.  Tiles,
// operand descriptors and fragment layouts: hopper.cuh.
//
// Data movement (TMA).  Q, K and V are read in place through three 4-d
// tensor maps over the strided [B, L, H, D] layout (box: 64 columns x 1
// head x 64 positions), with zero fill past L, so a ragged last tile needs
// no bounds checks in the copy.  The producer warp loads the block's Q once
// (one mbarrier), then feeds a ring of kStages K/V stages: it waits for a
// stage's `empty` barrier, writes the tile's index beside it and issues the
// copies against its `full` barrier (expect_tx); after the last tile it
// sends index -1.  Consumers wait `full`, compute, and each warp arrives on
// `empty` when its warpgroup's products have retired.
//
// Products.  S = Q K^T with both operands K-major in shared memory; O += P V
// with P from registers (the S accumulator packed to bf16 in place) and V
// MN-major, one instruction per 64 output columns.
//
// Softmax on the fragments.  Scores are scaled to base 2 (scale * log2 e);
// the row max takes two quad shuffles, the row sum l stays per thread until
// the end.  p = exp2(s - m) in f32 enters l unrounded and is rounded to
// bf16 for the PV product, where the TPU kernel rounds `p.astype(v.dtype)`.
// A masked score is -1e30; under the segment mask (SEG) a masked p is
// zeroed after the exp, so a row that sees no key keeps l = 0, O = 0 and
// gets lse = -1e30 + log(1e-30).
#pragma once

#include <climits>

#include "hopper.cuh"

namespace ptt {
namespace wg {

// D = 256 runs one consumer warpgroup: at 288 threads ptxas caps a thread
// at 168 registers, below its 128 accumulators of O plus 32 of S.
template <int HD> struct Cfg {
  static constexpr int kWG = HD == 256 ? 1 : 2;          // consumer warpgroups
  static constexpr int kM = 64 * kWG;                    // query rows a block
  static constexpr int kNC = HD / 64;                    // 64-column blocks
  static constexpr int kStages = HD == 256 ? 2 : (HD == 128 ? 3 : 4);
  static constexpr int kThreads = kWG * 128 + 32;        // + producer warp
  static constexpr int kTileBytes = 64 * HD * 2;         // one K or V tile
  static constexpr int kQBytes = kM * HD * 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 256;   // align, barriers
};

// Forward over one (batch-head, kM query rows) per block.  Dense causal
// means row + (Sk - S) >= col; SEG adds seg_q[b, row] == seg_k[b, col] and
// skips, in the producer, every key tile whose [min, max] of seg_k misses
// the block's [min, max] of seg_q (disjoint ranges hold no equal pair, so
// this is exact for unsorted ids).
template <int HD, bool SEG>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int S, int Sk, int H, int causal, float scale) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::kQBytes;
  uint8_t* vs = ks + C::kStages * C::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kTileBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  int* tile_of = reinterpret_cast<int*>(qbar + 1);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * C::kM;   // longest first
  const int shift = Sk - S;
  const int kv_end =
      causal ? min(min(r0 + C::kM, S) - 1 + shift, Sk - 1) + 1 : Sk;
  const int n_tiles = (kv_end + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kWG);       // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::kWG) {
    // ---- producer warp: Q once, then the K/V ring ----
    if (lane == 0) {
      mbar_expect_tx(qbar, C::kQBytes);
      for (int g = 0; g < C::kWG; ++g)
        for (int c = 0; c < C::kNC; ++c)
          tma_load(qs + (g * C::kNC + c) * kBlockBytes, &tq, qbar, 64 * c, h,
                   r0 + 64 * g, b);
    }
    int qmin = 0, qmax = 0;
    if constexpr (SEG) {
      qmin = INT_MAX;
      qmax = INT_MIN;
      for (int r = r0 + lane; r < min(r0 + C::kM, S); r += 32) {
        const int x = seg_q[(size_t)b * S + r];
        qmin = min(qmin, x);
        qmax = max(qmax, x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
        qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;              // each lane judges one tile
      bool keep = t < n_tiles;
      if constexpr (SEG) {
        if (keep) {
          const int* sk = seg_k + (size_t)b * Sk;
          int lo = INT_MAX, hi = INT_MIN;
          const int e = min(64 * t + 64, kv_end);
          for (int c = 64 * t; c < e; ++c) {
            const int x = sk[c];
            lo = min(lo, x);
            hi = max(hi, x);
          }
          keep = hi >= qmin && lo <= qmax;
        }
      }
      unsigned todo = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) {
        while (todo) {
          const int tile = t0 + __ffs(todo) - 1;
          todo &= todo - 1;
          mbar_wait(&empty[stage], phase ^ 1);
          tile_of[stage] = tile;
          mbar_expect_tx(&full[stage], 2 * C::kTileBytes);
          uint8_t* kst = ks + stage * C::kTileBytes;
          uint8_t* vst = vs + stage * C::kTileBytes;
          for (int c = 0; c < C::kNC; ++c) {
            tma_load(kst + c * kBlockBytes, &tk, &full[stage], 64 * c, h,
                     64 * tile, b);
            tma_load(vst + c * kBlockBytes, &tv, &full[stage], 64 * c, h,
                     64 * tile, b);
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      __syncwarp();
    }
    if (lane == 0) {                          // end of the walk
      mbar_wait(&empty[stage], phase ^ 1);
      tile_of[stage] = -1;
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int g = warp / 4, w = warp % 4;
  const int g_row0 = r0 + 64 * g;
  const int row0 = g_row0 + 16 * w + lane / 4, row1 = row0 + 8;
  // keys this warpgroup's rows can see end before g_end
  const int g_end =
      g_row0 >= S ? 0
                  : (causal ? min(min(g_row0 + 64, S) - 1 + shift, Sk - 1) + 1
                            : Sk);
  const float sl2 = scale * kLog2e;
  int sq0 = 0, sq1 = 0;
  if constexpr (SEG) {
    sq0 = row0 < S ? seg_q[(size_t)b * S + row0] : 0;
    sq1 = row1 < S ? seg_q[(size_t)b * S + row1] : 0;
  }
  const int* skb = SEG ? seg_k + (size_t)b * Sk : nullptr;

  float o[C::kNC][32];
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int n = 0; n < C::kNC; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qaddr = smem_u32(qs + g * C::kNC * kBlockBytes);

  mbar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int t = tile_of[stage];
    if (t < 0) break;
    const int k0 = 64 * t;
    if (k0 < g_end) {
      const uint32_t kaddr = smem_u32(ks + stage * C::kTileBytes);
      const uint32_t vaddr = smem_u32(vs + stage * C::kTileBytes);
      // S = Q K^T
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wgmma_ss(s, desc_k(qaddr, kk), desc_k(kaddr, kk), kk > 0);
      }
      wgmma_commit();
      int skc[SEG ? 16 : 1];                // this thread's columns' seg ids
      if constexpr (SEG) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * j + 2 * (lane & 3) + e;
            skc[2 * j + e] = c < Sk ? skb[c] : 0;
          }
      }
      wgmma_wait();
      fence_regs(s);

      // mask (diagonal and ragged tiles; every tile under SEG), scale
      const bool masked =
          SEG || k0 + 64 > Sk || (causal && k0 + 63 > g_row0 + shift);
      if (masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = (i & 2) ? row1 : row0;
          bool vis = col < Sk && (!causal || col <= row + shift);
          if constexpr (SEG)
            vis = vis && skc[2 * (i >> 2) + (i & 1)] == ((i & 2) ? sq1 : sq0);
          s[i] = vis ? s[i] * sl2 : kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= sl2;
      }

      // online softmax: row max over the quad, rescale, exp
      float mx[2] = {kNegInf, kNegInf}, corr[2];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(s[i] - m[r]);
        if constexpr (SEG) p = s[i] == kNegInf ? 0.f : p;
        l[r] += p;
        s[i] = p;
      }
#pragma unroll
      for (int n = 0; n < C::kNC; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i >> 1) & 1];

      // P (bf16, registers) -> O += P V
      uint32_t pa[4][4];
      to_frags(s, pa);
#pragma unroll
      for (int n = 0; n < C::kNC; ++n) fence_regs(o[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < C::kNC; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(o[n], pa[kk], desc_mn(vaddr, n, kk));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int n = 0; n < C::kNC; ++n) fence_regs(o[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // finalize: out = O / l in bf16, lse = m + log(l) in natural units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  __nv_bfloat16* o0 = out + (((size_t)b * S + row0) * H + h) * HD;
  __nv_bfloat16* o1 = out + (((size_t)b * S + row1) * H + h) * HD;
#pragma unroll
  for (int n = 0; n < C::kNC; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * n + 8 * j + 2 * (lane & 3);
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(o[n][4 * j] * inv0, o[n][4 * j + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(o[n][4 * j + 2] * inv1, o[n][4 * j + 3] * inv1);
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (row < S)
        lse[(size_t)bh * S + row] =
            (m[r] == kNegInf ? kNegInf : m[r] * 0.6931471805599453f) +
            logf(l[r]);
    }
  }
}

template <int HD, bool SEG>
cudaError_t run(const void* q, const void* k, const void* v, const void* seg_q,
                const void* seg_k, void* out, void* lse, int B, int S, int Sk,
                int H, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, HD) || !tensor_map(&tk, k, B, Sk, H, HD) ||
      !tensor_map(&tv, v, B, Sk, H, HD))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<HD, SEG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + C::kM - 1) / C::kM);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, Sk, H, causal, scale);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace ptt
