// The CUDA-core body of the attention backward (dK/dV and dQ, dense or
// segment-masked): f32 math on tiles staged by ordinary loads.  The f32
// kernels and D = 256 in bf16 run it; the bf16 pair at D = 64 and 128,
// dense and SEG, runs the tensor-core body of attention_bwd_wgmma.cuh.
// Included by flash_attention_bwd.cu (dense) and flash_attention_seg_bwd.cu
// (SEG), so nvcc builds the two in parallel.
//
// q, k, v, dO are [B, S, H, D] read in place (no transpose to [B*H, S, D]);
// lse and delta = rowsum(dO * O) are [B*H, S] float32; dq, dk, dv come out
// [B, S, H, D] in the input dtype.  Causal is row >= col and needs S == Sk
// (the wrapper checks).  Any S works: ragged query and key tiles are masked.
// The SEG instantiations also take seg_q [B, S] and seg_k [B, Sk] int32 and
// AND seg_q[row] == seg_k[col] into the same per-element mask, staged per
// tile beside lse and delta.  Within the causal tile ranges of the dense
// kernels they skip each walked tile whose segment-id range is disjoint
// from the owned tile's (no equal pair there, so this is exact for
// unsorted ids), as the tensor-core body does.
//
// Order of rounding, as in the TPU kernels: s = (q . k) * scale and
// p = exp(s - lse) in f32; p is rounded to dO's dtype before dV += p^T dO;
// dS = p * (dP - delta) * scale is rounded to q's dtype before dK += dS^T Q
// and dQ += dS K; every product accumulates in f32.
//
// dkv: grid (B*H, ceil(Sk / BK)).  A block owns BK keys and their dK, dV
// accumulators (registers, f32) and walks the query tiles from the first
// one that can see its keys under the causal mask.  Each key tile has one
// owner, so there are no atomics and the sums are deterministic.
// dq: grid (B*H, ceil(S / BQ)).  A block owns BQ query rows and walks the
// key tiles up to the diagonal.  In both, the tiles with the most work
// (first keys, last query rows) take the lowest blockIdx.y, so they start
// first.
//
// Work split: 256 threads as a 16 x 16 grid (ty, tx).  In the score-shaped
// products (S = Q K^T and dP = dO V^T) thread (ty, tx) owns query rows
// ty*RQ + i and keys tx + 16*j; in the D-wide ones (dV, dK, dQ) it owns
// rows ty*R + i and columns tx*4 + 64*c + e.  Tiles sit in shared memory as
// f32 rows padded to D + 4 floats (16-byte aligned, neighbouring rows four
// banks apart) and are read as float4; the score tiles are padded so the
// two ty of a warp read 16 banks apart.
//
// Bound on the H100: these kernels compute in f32 on the CUDA cores
// (67 TFLOP/s) and recompute S and dP in both kernels (7 matmuls, not 5);
// nothing S x Sk touches device memory, and each thread's register tile
// (4x4 scores, 4x8 outputs at D=128) gives several FMAs per shared-memory
// load.
#pragma once

#include <climits>

#include "attention_tile.cuh"

namespace ptt {


constexpr int kBwdThreads = 256;

template <int HD> struct Bwd {
  static constexpr int BQ = HD == 256 ? 32 : 64;   // query rows per tile
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys per tile
  static constexpr int RQ = BQ / 16;  // query rows per thread (scores, dQ)
  static constexpr int RK = BK / 16;  // keys per thread (scores, dK/dV)
  static constexpr int CD = HD / 64;  // float4 column groups per thread
  static constexpr int RS = HD + 4;   // padded Q/dO/K/V row, floats
  static constexpr int PS = BK + 16 / RQ;   // padded P/dS row, floats
};

// Stage ROWS rows of a [*, HD] tensor into dst[ROWS][HD + 4] as f32;
// row_off(r) is row r's element offset, or -1 past the end (zeros).
template <typename T, int HD, int ROWS, typename RowOff>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      RowOff row_off) {
  constexpr int VN = Vec<T>::N, CH = HD / VN, RS = HD + 4;
  for (int c = threadIdx.x; c < ROWS * CH; c += kBwdThreads) {
    const int r = c / CH, d = (c % CH) * VN;
    const long long o = row_off(r);
    float buf[VN];
    if (o >= 0) {
      load16(src + o + d, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) buf[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * RS + d);
#pragma unroll
    for (int i = 0; i < VN / 4; ++i)
      out[i] = make_float4(buf[4 * i], buf[4 * i + 1], buf[4 * i + 2],
                           buf[4 * i + 3]);
  }
}

// lse and delta of query rows q0.. into smem (zeros past S).
template <int BQ>
__device__ __forceinline__ void stage_stats(float* lse_s, float* dl_s,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            int bh, int q0, int S) {
  for (int r = threadIdx.x; r < BQ; r += kBwdThreads) {
    const int row = q0 + r;
    const bool in = row < S;
    lse_s[r] = in ? lse[(size_t)bh * S + row] : 0.f;
    dl_s[r] = in ? delta[(size_t)bh * S + row] : 0.f;
  }
}

// Segment ids of the ROWS positions p0.. of one batch row into smem (0
// past n, where the row/col bound masks them anyway).
template <int ROWS>
__device__ __forceinline__ void stage_seg(int* dst, const int* __restrict__ seg,
                                          int p0, int n) {
  for (int r = threadIdx.x; r < ROWS; r += kBwdThreads)
    dst[r] = p0 + r < n ? seg[p0 + r] : 0;
}

// [min, max] of ids[p0 .. p1 - 1], computed by every thread (the owned
// tile's range, once a block).
__device__ __forceinline__ int2 owned_range(const int* __restrict__ ids,
                                            int p0, int p1) {
  int2 r = make_int2(INT_MAX, INT_MIN);
  for (int p = p0; p < p1; ++p) {
    r.x = min(r.x, ids[p]);
    r.y = max(r.y, ids[p]);
  }
  return r;
}

// Does the walked tile ids[p0 .. min(p0 + ROWS, n) - 1] hold an id <=
// own.y and one >= own.x, i.e. does its range meet own?  A barrier: the
// answer is the same on every thread of the block.
template <int ROWS>
__device__ __forceinline__ bool tile_meets(const int* __restrict__ ids,
                                           int p0, int n, int2 own) {
  const int p = p0 + threadIdx.x;
  const bool in = threadIdx.x < ROWS && p < n;
  const int x = in ? ids[p] : 0;
  const bool below = __syncthreads_or(in && x <= own.y);
  return __syncthreads_or(in && x >= own.x) && below;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&r)[N]) {
  static_assert(N == 2 || N == 4, "row of 2 or 4 floats");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  }
}

// The score-shaped products of the staged tiles (query rows q0.., keys
// k0..): S = Q K^T and dP = dO V^T, then p = exp(S * scale - lse) and
// dS = p * (dP - delta) * scale, zero where masked or past the end.
// Writes dS rounded to T into dss[BQ][PS] and, for kWantP, p rounded to T
// into ps[BQ][PS].  SEG also masks where sq_s[row] != sk_s[key] (the
// tiles' staged segment ids).
template <typename T, int HD, bool kWantP, bool SEG>
__device__ __forceinline__ void score_tiles(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* dl_s, const int* sq_s, const int* sk_s,
    float* ps, float* dss, int q0, int k0, int S, int Sk, int causal,
    float scale) {
  using G = Bwd<HD>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[G::RQ][G::RK], dp[G::RQ][G::RK];
#pragma unroll
  for (int i = 0; i < G::RQ; ++i)
#pragma unroll
    for (int j = 0; j < G::RK; ++j) s[i][j] = dp[i][j] = 0.f;

#pragma unroll 1
  for (int d = 0; d < HD; d += 4) {
    float4 a[G::RQ], o[G::RQ], kb[G::RK], vb[G::RK];
#pragma unroll
    for (int i = 0; i < G::RQ; ++i) {
      a[i] = *reinterpret_cast<const float4*>(qs + (ty * G::RQ + i) * G::RS + d);
      o[i] = *reinterpret_cast<const float4*>(dos + (ty * G::RQ + i) * G::RS + d);
    }
#pragma unroll
    for (int j = 0; j < G::RK; ++j) {
      kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * G::RS + d);
      vb[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * G::RS + d);
    }
#pragma unroll
    for (int i = 0; i < G::RQ; ++i)
#pragma unroll
      for (int j = 0; j < G::RK; ++j) {
        s[i][j] = fmaf(a[i].x, kb[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, kb[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, kb[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, kb[j].w, s[i][j]);
        dp[i][j] = fmaf(o[i].x, vb[j].x, dp[i][j]);
        dp[i][j] = fmaf(o[i].y, vb[j].y, dp[i][j]);
        dp[i][j] = fmaf(o[i].z, vb[j].z, dp[i][j]);
        dp[i][j] = fmaf(o[i].w, vb[j].w, dp[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < G::RQ; ++i) {
    const int r = ty * G::RQ + i, row = q0 + r;
    const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int j = 0; j < G::RK; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool ok = row < S && col < Sk && (!causal || row >= col) &&
                      (!SEG || sq_s[r] == sk_s[tx + 16 * j]);
      const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
      dss[r * G::PS + tx + 16 * j] =
          ok ? round_to<T>(p * (dp[i][j] - dl) * scale) : 0.f;
      if constexpr (kWantP) ps[r * G::PS + tx + 16 * j] = round_to<T>(p);
    }
  }
}

template <typename T, int HD, bool SEG>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int H, int causal,
                     float scale) {
  using G = Bwd<HD>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + G::BK * G::RS;
  float* qs = vs + G::BK * G::RS;
  float* dos = qs + G::BQ * G::RS;
  float* ps = dos + G::BQ * G::RS;
  float* dss = ps + G::BQ * G::PS;
  float* lse_s = dss + G::BQ * G::PS;
  float* dl_s = lse_s + G::BQ;
  int* sq_s = reinterpret_cast<int*>(dl_s + G::BQ);
  int* sk_s = sq_s + G::BQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * G::BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  auto key_row = [&](int r) -> long long {
    const int pos = k0 + r;
    return pos < Sk ? (((long long)b * Sk + pos) * H + h) * HD : -1;
  };
  stage<T, HD, G::BK>(ks, k, key_row);
  stage<T, HD, G::BK>(vs, v, key_row);
  if constexpr (SEG) stage_seg<G::BK>(sk_s, seg_k + (size_t)b * Sk, k0, Sk);

  float dk_acc[G::RK][4 * G::CD], dv_acc[G::RK][4 * G::CD];
#pragma unroll
  for (int i = 0; i < G::RK; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G::CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int2 own = make_int2(0, 0);
  if constexpr (SEG)
    own = owned_range(seg_k + (size_t)b * Sk, k0, min(k0 + G::BK, Sk));
  const int q_first = causal ? (k0 / G::BQ) * G::BQ : 0;
  for (int q0 = q_first; q0 < S; q0 += G::BQ) {
    if constexpr (SEG)
      if (!tile_meets<G::BQ>(seg_q + (size_t)b * S, q0, S, own)) continue;
    __syncthreads();              // K/V staged, or the previous tile consumed
    auto query_row = [&](int r) -> long long {
      const int pos = q0 + r;
      return pos < S ? (((long long)b * S + pos) * H + h) * HD : -1;
    };
    stage<T, HD, G::BQ>(qs, q, query_row);
    stage<T, HD, G::BQ>(dos, dout, query_row);
    stage_stats<G::BQ>(lse_s, dl_s, lse, delta, bh, q0, S);
    if constexpr (SEG) stage_seg<G::BQ>(sq_s, seg_q + (size_t)b * S, q0, S);
    __syncthreads();
    score_tiles<T, HD, true, SEG>(qs, dos, ks, vs, lse_s, dl_s, sq_s, sk_s,
                                  ps, dss, q0, k0, S, Sk, causal, scale);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's query rows
#pragma unroll 2
    for (int r = 0; r < G::BQ; ++r) {
      float pa[G::RK], sa[G::RK];
      load_row<G::RK>(ps + r * G::PS + ty * G::RK, pa);
      load_row<G::RK>(dss + r * G::PS + ty * G::RK, sa);
#pragma unroll
      for (int c = 0; c < G::CD; ++c) {
        const float4 ob =
            *reinterpret_cast<const float4*>(dos + r * G::RS + tx * 4 + 64 * c);
        const float4 qb =
            *reinterpret_cast<const float4*>(qs + r * G::RS + tx * 4 + 64 * c);
#pragma unroll
        for (int i = 0; i < G::RK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv_acc[i][4 * c + e] = fmaf(pa[i], comp(ob, e), dv_acc[i][4 * c + e]);
            dk_acc[i][4 * c + e] = fmaf(sa[i], comp(qb, e), dk_acc[i][4 * c + e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < G::RK; ++i) {
    const long long o = key_row(ty * G::RK + i);
    if (o < 0) continue;
#pragma unroll
    for (int c = 0; c < G::CD; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * c + e;
        dk[o + col] = from_f<T>(dk_acc[i][4 * c + e]);
        dv[o + col] = from_f<T>(dv_acc[i][4 * c + e]);
      }
  }
}

template <typename T, int HD, bool SEG>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k, T* __restrict__ dq,
                    int S, int Sk, int H, int causal, float scale) {
  using G = Bwd<HD>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + G::BQ * G::RS;
  float* ks = dos + G::BQ * G::RS;
  float* vs = ks + G::BK * G::RS;
  float* dss = vs + G::BK * G::RS;
  float* lse_s = dss + G::BQ * G::PS;
  float* dl_s = lse_s + G::BQ;
  int* sq_s = reinterpret_cast<int*>(dl_s + G::BQ);
  int* sk_s = sq_s + G::BQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  auto query_row = [&](int r) -> long long {
    const int pos = q0 + r;
    return pos < S ? (((long long)b * S + pos) * H + h) * HD : -1;
  };
  stage<T, HD, G::BQ>(qs, q, query_row);
  stage<T, HD, G::BQ>(dos, dout, query_row);
  stage_stats<G::BQ>(lse_s, dl_s, lse, delta, bh, q0, S);
  if constexpr (SEG) stage_seg<G::BQ>(sq_s, seg_q + (size_t)b * S, q0, S);

  float acc[G::RQ][4 * G::CD];
#pragma unroll
  for (int i = 0; i < G::RQ; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G::CD; ++c) acc[i][c] = 0.f;

  int2 own = make_int2(0, 0);
  if constexpr (SEG)
    own = owned_range(seg_q + (size_t)b * S, q0, min(q0 + G::BQ, S));
  const int kv_end = causal ? min(q0 + G::BQ, S) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += G::BK) {
    if constexpr (SEG)
      if (!tile_meets<G::BK>(seg_k + (size_t)b * Sk, k0, kv_end, own))
        continue;
    __syncthreads();              // Q/dO staged, or the previous tile consumed
    auto key_row = [&](int r) -> long long {
      const int pos = k0 + r;
      return pos < Sk ? (((long long)b * Sk + pos) * H + h) * HD : -1;
    };
    stage<T, HD, G::BK>(ks, k, key_row);
    stage<T, HD, G::BK>(vs, v, key_row);
    if constexpr (SEG) stage_seg<G::BK>(sk_s, seg_k + (size_t)b * Sk, k0, Sk);
    __syncthreads();
    score_tiles<T, HD, false, SEG>(qs, dos, ks, vs, lse_s, dl_s, sq_s, sk_s,
                                   nullptr, dss, q0, k0, S, Sk, causal,
                                   scale);
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 1
    for (int kk = 0; kk < G::BK; kk += 4) {
      float4 a[G::RQ];
#pragma unroll
      for (int i = 0; i < G::RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(dss + (ty * G::RQ + i) * G::PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < G::CD; ++c) {
          const float4 kb = *reinterpret_cast<const float4*>(
              ks + (kk + e) * G::RS + tx * 4 + 64 * c);
#pragma unroll
          for (int i = 0; i < G::RQ; ++i) {
            const float ae = comp(a[i], e);
            acc[i][4 * c + 0] = fmaf(ae, kb.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(ae, kb.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(ae, kb.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(ae, kb.w, acc[i][4 * c + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < G::RQ; ++i) {
    const long long o = query_row(ty * G::RQ + i);
    if (o < 0) continue;
#pragma unroll
    for (int c = 0; c < G::CD; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[o + tx * 4 + 64 * c + e] = from_f<T>(acc[i][4 * c + e]);
  }
}

template <int HD> constexpr size_t dkv_smem() {
  using G = Bwd<HD>;
  return ((2 * G::BK + 2 * G::BQ) * G::RS + 2 * G::BQ * G::PS + 2 * G::BQ) *
             sizeof(float) +
         (G::BQ + G::BK) * sizeof(int);
}

template <int HD> constexpr size_t dq_smem() {
  using G = Bwd<HD>;
  return ((2 * G::BK + 2 * G::BQ) * G::RS + G::BQ * G::PS + 2 * G::BQ) *
             sizeof(float) +
         (G::BQ + G::BK) * sizeof(int);
}

template <typename T, int HD, bool SEG>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* seg_q, const void* seg_k, void* dk, void* dv,
                    int B, int S, int Sk, int H, int causal, float scale,
                    cudaStream_t stream) {
  dim3 grid(B * H, (Sk + Bwd<HD>::BK - 1) / Bwd<HD>::BK);
  return launch(flash_bwd_dkv_kernel<T, HD, SEG>, kBwdThreads,
                dkv_smem<HD>(), grid, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta),
                static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
                static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, causal,
                scale);
}

template <typename T, int HD, bool SEG>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seg_q, const void* seg_k, void* dq, int B,
                   int S, int Sk, int H, int causal, float scale,
                   cudaStream_t stream) {
  dim3 grid(B * H, (S + Bwd<HD>::BQ - 1) / Bwd<HD>::BQ);
  return launch(flash_bwd_dq_kernel<T, HD, SEG>, kBwdThreads, dq_smem<HD>(),
                grid, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta),
                static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
                static_cast<T*>(dq), S, Sk, H, causal, scale);
}

}  // namespace ptt
