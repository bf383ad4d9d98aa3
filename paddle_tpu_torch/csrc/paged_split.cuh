// Key-split paged attention: the pieces that the fused step's kernel
// (paged_attention.cu) and the unfused decode step's kernel (paged_decode.cu)
// share.  Both grids are (nsplit, row tiles, B*KVH): block s walks keys
// [s*ck, (s+1)*ck) of its slot for one tile of query rows of one kv head.
// A tile whose keys span n > 1 splits stores each split's f32 (m, l, acc) in
// a workspace; the last of its n blocks to finish merges them in split order
// (merge_when_last), so two calls give the same bits.  A tile of one split
// normalises and writes out directly and touches no workspace.
//
// - Blk: one block's place in the call (its rows, its split, its partials).
// - stream_lane: up to GC rows in registers over NW*32/LPK key streams of
//   LPK lanes each (16-byte loads; 8-byte ones of an int8 pool, so it keeps
//   the bf16 pool's lanes and streams), every stream with two keys in flight
//   and its own online softmax; the streams merge once through shared
//   memory.  An int8 pool's rows dequantize by their f32 scales as they
//   load (load_key), each lane reading its key row's two scales once.
// - merge_splits / merge_when_last: the cross-block merge.
//
// Under a split a row may see no key of its range, so masked probabilities
// are zeroed after the exp: such a row's partial is (-1e30, 0, 0) and the
// merge weighs it exp(-1e30 - M) = 0.  Split 0 holds position 0, which every
// real row sees, so M is finite.
#pragma once

#include "attention_tile.cuh"

namespace ptt {

// The stream lane's geometry over a pool of KV at NW warps a block.
template <typename KV, int HD, int NW = kWarps> struct Strm {
  static constexpr int VN = KVec<KV>::N;                  // elements a load
  static constexpr int LPK = HD / VN < 32 ? HD / VN : 32; // lanes a key row
  static constexpr int EPL = HD / LPK;                    // elements a lane
  static constexpr int KPW = 32 / LPK;                    // key rows a warp
  static constexpr int NS = NW * KPW;                     // key streams
};

template <typename KV, int HD, int GC, int NW = kWarps>
constexpr size_t strm_smem_bytes() {
  return (2 + HD) * Strm<KV, HD, NW>::NS * GC * sizeof(float);
}

// One block's place in the call.  Local row rr of the tile is query row
// r0 + rr of (slot b, kv head kh), rows stacked t-major, g-minor.  When the
// tile's keys span several splits (not direct), acc, m and l are the tile's
// partials: acc [nsplit][kBlockRows][HD], m and l [kBlockRows][nsplit].
template <typename T> struct Blk {
  const T* q;
  T* out;
  int b, kh, G, Tq, H, r0;
  float* acc;
  float* m;
  float* l;
  int split, nsplit;
  bool direct;    // one split: normalise and write out here

  __device__ __forceinline__ size_t row_off(int rr) const {
    const int row = r0 + rr;
    return ((size_t)b * Tq + row / G) * H + kh * G + row % G;
  }

  // Point acc, m and l at tile `tile`'s partials in the workspace
  // [tiles][nsplit][kBlockRows][HD] acc, then [tiles][kBlockRows][nsplit]
  // m and the same for l.
  __device__ __forceinline__ void bind(float* ws, size_t tile, size_t tiles,
                                       int hd, int s, bool one_split) {
    acc = ws + tile * nsplit * kBlockRows * hd;
    m = ws + tiles * nsplit * kBlockRows * hd + tile * kBlockRows * nsplit;
    l = m + tiles * kBlockRows * nsplit;
    split = s;
    direct = one_split;
  }
};

template <typename T, int HD>
__device__ __forceinline__ T* out_row(const Blk<T>& k, int rr) {
  return k.out + k.row_off(rr) * HD;
}

template <typename T, int HD, int NW = kWarps>
__device__ __forceinline__ void zero_rows(const Blk<T>& k, int lo, int hi) {
  for (int i = threadIdx.x; i < (hi - lo) * HD; i += NW * 32)
    out_row<T, HD>(k, lo + i / HD)[i % HD] = from_f<T>(0.f);
}

// Store one row's split result: normalised into out, or as a partial.
template <typename T, int HD>
__device__ __forceinline__ void put(const Blk<T>& k, int rr, int d, float m,
                                    float l, float a) {
  if (k.direct) {
    out_row<T, HD>(k, rr)[d] = from_f<T>(a / fmaxf(l, 1e-30f));
  } else {
    k.acc[((size_t)k.split * kBlockRows + rr) * HD + d] = a;
    if (d == 0) {
      k.m[rr * k.nsplit + k.split] = m;
      k.l[rr * k.nsplit + k.split] = l;
    }
  }
}

// Key `pos` of the slot's table row `trow`: this lane's EPL dims of its K
// and V rows, in f32 (an int8 row times its scale in ksc / vsc).
template <typename KV, int HD, int NW>
__device__ __forceinline__ void load_key(const KV* __restrict__ kp,
                                         const KV* __restrict__ vp,
                                         const float* __restrict__ ksc,
                                         const float* __restrict__ vsc,
                                         const int* __restrict__ trow,
                                         int page, int KVH, int kh, int d0,
                                         int pos, bool in, float* kr,
                                         float* vr) {
  using D = Strm<KV, HD, NW>;
  if (in) {
    const size_t row =
        ((size_t)trow[pos / page] * page + pos % page) * KVH + kh;
    const size_t o = row * HD + d0;
    float sk = 1.f, sv = 1.f;
    if constexpr (kQuantized<KV>) {
      sk = ksc[row];
      sv = vsc[row];
    }
#pragma unroll
    for (int c = 0; c < D::EPL / D::VN; ++c) {
      load_kv<KV>(kp + o + c * D::VN, sk, kr + c * D::VN);
      load_kv<KV>(vp + o + c * D::VN, sv, vr + c * D::VN);
    }
  } else {
#pragma unroll
    for (int e = 0; e < D::EPL; ++e) kr[e] = vr[e] = 0.f;
  }
}

// The stream lane: the tile's nrows <= GC rows over keys [kv_begin,
// kv_stop); row rr's horizon is min(qoff + rr / G, last_q).  q is T, the
// pool KV (T, or int8 with scales ksc / vsc).  smem holds
// strm_smem_bytes<KV, HD, GC, NW>().
template <typename T, typename KV, int HD, int GC, int NW = kWarps>
__device__ __forceinline__ void stream_lane(
    const Blk<T>& k, float* smem, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ trow, int page,
    int KVH, int nrows, int qoff, int last_q, int kv_begin, int kv_stop,
    float scale) {
  using D = Strm<KV, HD, NW>;
  constexpr int QV = Vec<T>::N;                 // q elements a load
  static_assert(D::EPL % QV == 0, "a lane's q dims are whole loads");
  float* ms = smem;                          // [NS][GC] running max
  float* ls = ms + D::NS * GC;               // [NS][GC] running sum
  float* accs = ls + D::NS * GC;             // [NS][GC][HD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / D::LPK;                 // key row of the warp
  const int d0 = (lane % D::LPK) * D::EPL;       // first dim of this lane
  const int stream = warp * D::KPW + grp;

  float qr[GC][D::EPL], m[GC], l[GC], acc[GC][D::EPL];
  int hz[GC];
#pragma unroll
  for (int r = 0; r < GC; ++r) {
    hz[r] = min(qoff + r / k.G, last_q);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < D::EPL; ++e) acc[r][e] = qr[r][e] = 0.f;
    if (r < nrows) {
      const T* src = k.q + k.row_off(r) * HD + d0;
#pragma unroll
      for (int c = 0; c < D::EPL / QV; ++c)
        load16(src + c * QV, qr[r] + c * QV);
    }
  }

  // stream `stream` takes keys kv_begin + stream + j * NS, two a pass (both
  // loads issued before the math); every lane of a warp runs the same
  // passes (the shuffles need the whole warp)
  for (int base = kv_begin + warp * D::KPW; base < kv_stop;
       base += 2 * D::NS) {
    const int p0 = base + grp, p1 = p0 + D::NS;
    const bool in0 = p0 < kv_stop, in1 = p1 < kv_stop;
    float k0[D::EPL], v0[D::EPL], k1[D::EPL], v1[D::EPL];
    load_key<KV, HD, NW>(kp, vp, ksc, vsc, trow, page, KVH, k.kh, d0, p0,
                         in0, k0, v0);
    load_key<KV, HD, NW>(kp, vp, ksc, vsc, trow, page, KVH, k.kh, d0, p1,
                         in1, k1, v1);
#pragma unroll
    for (int r = 0; r < GC; ++r) {
      if (r >= nrows) continue;           // block-uniform
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int e = 0; e < D::EPL; ++e) {
        s0 = fmaf(qr[r][e], k0[e], s0);
        s1 = fmaf(qr[r][e], k1[e], s1);
      }
#pragma unroll
      for (int off = D::LPK / 2; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      const bool vis0 = in0 && p0 <= hz[r], vis1 = in1 && p1 <= hz[r];
      const float x0 = vis0 ? s0 * scale : kNegInf;
      const float x1 = vis1 ? s1 * scale : kNegInf;
      const float mn = fmaxf(m[r], fmaxf(x0, x1));
      const float corr = expf(m[r] - mn);
      const float e0 = expf(x0 - mn), e1 = expf(x1 - mn);
      const float pr0 = vis0 ? e0 : 0.f, pr1 = vis1 ? e1 : 0.f;
      l[r] = l[r] * corr + pr0 + pr1;
      m[r] = mn;
      const float pv0 = round_p<KV>(pr0), pv1 = round_p<KV>(pr1);
#pragma unroll
      for (int e = 0; e < D::EPL; ++e)
        acc[r][e] = fmaf(pv1, v1[e], fmaf(pv0, v0[e], acc[r][e] * corr));
    }
  }

#pragma unroll
  for (int r = 0; r < GC; ++r) {
    if (r >= nrows) continue;
    if (lane % D::LPK == 0) {
      ms[stream * GC + r] = m[r];
      ls[stream * GC + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < D::EPL; ++e)
      accs[(stream * GC + r) * HD + d0 + e] = acc[r][e];
  }
  __syncthreads();

  // merge the streams: thread per (row, dim)
  for (int i = threadIdx.x; i < nrows * HD; i += NW * 32) {
    const int r = i / HD, d = i % HD;
    float mx = kNegInf;
    for (int s = 0; s < D::NS; ++s) mx = fmaxf(mx, ms[s * GC + r]);
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < D::NS; ++s) {
      const float w = expf(ms[s * GC + r] - mx);
      lsum = fmaf(ls[s * GC + r], w, lsum);
      a = fmaf(accs[(s * GC + r) * HD + d], w, a);
    }
    put<T, HD>(k, r, d, mx, lsum, a);
  }
}

// The last block of a tile: merge its n partials in split order into out,
// a warp per real row, lane over dims.
template <typename T, int HD, int NW = kWarps>
__device__ __forceinline__ void merge_splits(const Blk<T>& k, int n,
                                             int real) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < real; rr += NW) {
    const float* mr = k.m + rr * k.nsplit;
    const float* lr = k.l + rr * k.nsplit;
    float M = kNegInf;
    for (int s = lane; s < n; s += 32) M = fmaxf(M, __ldcg(mr + s));
    M = warp_max(M);
    float L = 0.f, a[HD / 32];
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) a[i] = 0.f;
    for (int s0 = 0; s0 < n; s0 += 32) {
      const int s = s0 + lane;
      const float w = s < n ? expf(__ldcg(mr + s) - M) : 0.f;
      const float lw = s < n ? __ldcg(lr + s) * w : 0.f;
      const int cnt = min(32, n - s0);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        L += __shfl_sync(0xffffffffu, lw, j);
        const float* src =
            k.acc + ((size_t)(s0 + j) * kBlockRows + rr) * HD + lane;
#pragma unroll
        for (int i = 0; i < HD / 32; ++i)
          a[i] = fmaf(wj, __ldcg(src + 32 * i), a[i]);
      }
    }
    T* o = out_row<T, HD>(k, rr);
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      o[lane + 32 * i] = from_f<T>(a[i] / fmaxf(L, 1e-30f));
  }
}

// After a block of a tile over n > 1 splits has stored its partials:
// publish them (fence, then one atomicAdd on the tile's counter); the last
// of the n blocks to arrive merges them in split order and resets the
// counter to 0, so the next call on the stream starts from 0.  Returns
// whether this block merged.
template <typename T, int HD, int NW = kWarps>
__device__ __forceinline__ bool merge_when_last(const Blk<T>& k,
                                                int* __restrict__ count,
                                                size_t tile, int n,
                                                int real) {
  __shared__ int last_block;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(count + tile, 1) == n - 1;
  __syncthreads();
  if (!last_block) return false;
  __threadfence();
  merge_splits<T, HD, NW>(k, n, real);
  if (threadIdx.x == 0) count[tile] = 0;
  return true;
}

}  // namespace ptt
