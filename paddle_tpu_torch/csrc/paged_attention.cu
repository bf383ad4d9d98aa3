// Causal-at-offset attention through a page table, for the fused serving step.
//
// Replaces the TPU kernel paddle_tpu/incubate/kernels/paged_attention.py::
// _paged_prefill_kernel (launched by paged_prefill_attention_pallas).  Query
// t of slot b sits at position q_offset[b] + t and sees kv positions <= it;
// rows t >= valid[b] are padding and get 0.  GQA: kv head kh serves query
// heads kh*G .. kh*G+G-1, and a slot's G*T query rows of one kv head are
// stacked t-major, g-minor as the TPU kernel stacks them.  Each key row is
// found through the slot's own table row, so any page size works and the
// pool is never gathered into a dense copy.  A null-table slot (valid 1,
// q_offset 0) attends to position 0 of the null page only.
//
// Bound on the H100: bytes.  A decode slot reads its K/V once for G query
// rows per kv head (~2 flops per byte), far below the ~295 flops per byte
// where the tensor cores would bind.  What the design does about the three
// things that held the first version back:
//
// 1. One block walked a slot's whole key range, so the call lasted as long
//    as the longest slot's walk, on B*KVH blocks.  Now the grid is (nsplit,
//    row tiles, B*KVH): block s walks keys [s*ck, (s+1)*ck) of its slot, up
//    to one past the last real query of its rows (kv_end).  The plan
//    (`_prefill_split_plan` in incubate/kernels/paged_attention.py) is built
//    from host-known shapes only; each block reads its slot's q_offset and
//    valid and returns at once when its key range is empty.  A tile whose
//    kv_end spans n > 1 splits writes each split's (m, l, acc) in f32 to a
//    workspace; the last of its n blocks to finish (one atomic counter per
//    tile, reset by that block) merges the n partials in split order, so two
//    calls give the same bits, and one launch does the whole call.
// 2. 16-row tiles held 4 real rows at decode's G = 4, and K/V were staged as
//    f32 in shared memory.  Now a slot whose G*valid rows fit the stream
//    lane's capacity GC (the smallest of 1, 2, 4, 8 that holds min(G*T, 8))
//    takes paged_decode.cu's key streams: LPK lanes own one key row (16-byte
//    loads), each stream walks two keys a pass with both loads in flight and
//    keeps its own (m, l, acc) for the slot's rows in registers, and the
//    streams merge once through shared memory.  Rows past G*valid are
//    skipped, not computed.  Other slots (prefill chunks, long verify) keep
//    attention_tile.cuh's 16-row tiles over their split.
// 3. Padding rows walked the keys under a clamped horizon.  Now a row tile
//    with no real row writes zeros and walks nothing.
//
// Under a split a row's horizon may lie below the split's first key, so
// masked probabilities are zeroed after the exp in both lanes: such a row
// ends the split with m = -1e30, l = 0, acc = 0, and the merge weights each
// partial by exp(m_s - M).  Split 0 holds position 0, which every real row
// sees, so M is finite.
//
// Not yet done: the tile lane on the tensor cores (wgmma) for chunk slots,
// and TMA or cp.async rings for the page gathers of both lanes.
#include "attention_tile.cuh"

using namespace ptt;

namespace {

// The stream lane's geometry: paged_decode.cu's, at this kernel's kWarps.
template <typename T, int HD> struct Strm {
  static constexpr int VN = Vec<T>::N;                    // elements a load
  static constexpr int LPK = HD / VN < 32 ? HD / VN : 32; // lanes a key row
  static constexpr int EPL = HD / LPK;                    // elements a lane
  static constexpr int KPW = 32 / LPK;                    // key rows a warp
  static constexpr int NS = kWarps * KPW;                 // key streams
};

template <typename T, int HD, int GC> constexpr size_t smem_bytes() {
  constexpr size_t strm = (2 + HD) * Strm<T, HD>::NS * GC * sizeof(float);
  return strm > Smem<HD>::kBytes ? strm : Smem<HD>::kBytes;
}

// Horizon under a key split: a row may see no key of the block's range.
struct SplitHorizon : Horizon {
  static constexpr bool kZeroMasked = true;
};

// One block's place in the call.  Local row rr of the tile is query row
// r0 + rr of (slot b, kv head kh).  When the tile's keys span several
// splits (not direct), acc, m and l are the tile's partials: acc
// [nsplit][kBlockRows][HD], m and l [kBlockRows][nsplit].
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
};

template <typename T, int HD>
__device__ __forceinline__ T* out_row(const Blk<T>& k, int rr) {
  return k.out + k.row_off(rr) * HD;
}

template <typename T, int HD>
__device__ __forceinline__ void zero_rows(const Blk<T>& k, int lo, int hi) {
  for (int i = threadIdx.x; i < (hi - lo) * HD; i += kThreads)
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

template <typename T, int HD>
__device__ __forceinline__ void load_key(const T* __restrict__ kp,
                                         const T* __restrict__ vp,
                                         const int* __restrict__ trow,
                                         int page, int KVH, int kh, int d0,
                                         int pos, bool in, float* kr,
                                         float* vr) {
  using D = Strm<T, HD>;
  if (in) {
    const size_t o =
        (((size_t)trow[pos / page] * page + pos % page) * KVH + kh) * HD + d0;
#pragma unroll
    for (int c = 0; c < D::EPL / D::VN; ++c) {
      load16(kp + o + c * D::VN, kr + c * D::VN);
      load16(vp + o + c * D::VN, vr + c * D::VN);
    }
  } else {
#pragma unroll
    for (int e = 0; e < D::EPL; ++e) kr[e] = vr[e] = 0.f;
  }
}

// The stream lane: the slot's nrows <= GC rows (all in tile 0) over keys
// [kv_begin, kv_stop); row rr's horizon is min(qoff + rr / G, last_q).
template <typename T, int HD, int GC>
__device__ __forceinline__ void stream_lane(
    const Blk<T>& k, float* smem, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ trow, int page,
    int KVH, int nrows, int qoff, int last_q, int kv_begin, int kv_stop,
    float scale) {
  using D = Strm<T, HD>;
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
      for (int c = 0; c < D::EPL / D::VN; ++c)
        load16(src + c * D::VN, qr[r] + c * D::VN);
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
    load_key<T, HD>(kp, vp, trow, page, KVH, k.kh, d0, p0, in0, k0, v0);
    load_key<T, HD>(kp, vp, trow, page, KVH, k.kh, d0, p1, in1, k1, v1);
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
      const float pv0 = round_to<T>(pr0), pv1 = round_to<T>(pr1);
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
  for (int i = threadIdx.x; i < nrows * HD; i += kThreads) {
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

// The tile lane: attention_tile.cuh's 16 rows (real rows < `real`) over
// keys [kv_begin, kv_stop); padding rows take the last real row's horizon.
template <typename T, int HD>
__device__ __forceinline__ void tile_lane(
    const Blk<T>& k, float* smem, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ trow, int page,
    int KVH, int rows, int real, int qoff, int valid, int last_q,
    int kv_begin, int kv_stop, float scale) {
  float* qs = smem;
  float* ks = qs + kBlockRows * HD;
  float* vs = ks + kKeys * Smem<HD>::kStride;
  stage_rows<T, HD>(qs, [&](int rr) -> const T* {
    return rr < rows ? k.q + k.row_off(rr) * HD : nullptr;
  });
  SplitHorizon mask;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = min((k.r0 + local_row(r)) / k.G, valid - 1);
    mask.limit[r] = min(qoff + t, last_q);
  }
  RowState<HD> st;
  st.init();
  const int kh = k.kh;
  attend<T, HD>(qs, ks, vs, kp, vp,
                [&](int pos) -> size_t {
                  const int p = trow[pos / page];
                  return (((size_t)p * page + pos % page) * KVH + kh) * HD;
                },
                kv_stop, mask, scale, st, kv_begin);

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = local_row(r);
    if (rr >= real) continue;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      put<T, HD>(k, rr, lane + 32 * i, st.m[r], st.l[r], st.acc[r][i]);
  }
}

// The last block of a tile: merge its n partials in split order into out,
// a warp per real row, lane over dims.
template <typename T, int HD>
__device__ __forceinline__ void merge_splits(const Blk<T>& k, int n,
                                             int real) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < real; rr += kWarps) {
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

// Grid (nsplit, ceil(Tq*G / 16), B*KVH): block (s, x, b*KVH + kh) owns
// query rows x*16 .. x*16+15 of (b, kh) and keys [s*ck, (s+1)*ck).
// ws: [tiles][nsplit][16][HD] acc, then [tiles][16][nsplit] m and l (f32);
// count: [tiles] int32, 0 between calls.
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ valid_, T* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ count, int Tq,
                     int H, int KVH, int page, int max_pages, int ck,
                     float scale) {
  extern __shared__ float smem[];
  __shared__ int last_block;
  const int s = blockIdx.x, x = blockIdx.y, nsplit = gridDim.x;
  const int b = blockIdx.z / KVH, kh = blockIdx.z % KVH;
  const int G = H / KVH, R = Tq * G, r0 = x * kBlockRows;
  const int rows = min(kBlockRows, R - r0);
  const int qoff = q_offset[b], valid = valid_[b];
  const int real = min(max(G * valid - r0, 0), rows);   // rows t < valid

  Blk<T> k;
  k.q = q;
  k.out = out;
  k.b = b;
  k.kh = kh;
  k.G = G;
  k.Tq = Tq;
  k.H = H;
  k.r0 = r0;
  k.nsplit = nsplit;
  if (real == 0) {                // padding rows only: zeros, no key walked
    if (s == 0) zero_rows<T, HD>(k, 0, rows);
    return;
  }
  const int last_q = min(qoff + valid - 1, max_pages * page - 1);
  const int kv_end = min(qoff + (r0 + real - 1) / G, last_q) + 1;
  const int n = (kv_end + ck - 1) / ck;             // splits of this tile
  if (s >= n) return;
  const int kv_begin = s * ck, kv_stop = min(kv_begin + ck, kv_end);

  const size_t tile = (size_t)blockIdx.z * gridDim.y + x;
  const size_t tiles = (size_t)gridDim.z * gridDim.y;
  k.acc = ws + tile * nsplit * kBlockRows * HD;
  k.m = ws + tiles * nsplit * kBlockRows * HD + tile * kBlockRows * nsplit;
  k.l = k.m + tiles * kBlockRows * nsplit;
  k.split = s;
  k.direct = n == 1;

  const int* trow = table + (size_t)b * max_pages;
  if (G * valid <= GC)            // decode and short verify: all in tile 0
    stream_lane<T, HD, GC>(k, smem, kp, vp, trow, page, KVH, real, qoff,
                           last_q, kv_begin, kv_stop, scale);
  else
    tile_lane<T, HD>(k, smem, kp, vp, trow, page, KVH, rows, real, qoff,
                     valid, last_q, kv_begin, kv_stop, scale);

  if (n > 1) {
    // publish this split's partials; the tile's last block merges them
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last_block = atomicAdd(count + tile, 1) == n - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    merge_splits<T, HD>(k, n, real);
    if (threadIdx.x == 0) count[tile] = 0;
  }
  zero_rows<T, HD>(k, real, rows);
}

template <typename T, int HD, int GC>
cudaError_t run_gc(const void* q, const void* k, const void* v,
                   const void* table, const void* q_offset,
                   const void* valid, void* out, void* ws, void* count,
                   int B, int Tq, int H, int KVH, int page, int max_pages,
                   int ck, int nsplit, float scale, cudaStream_t stream) {
  const int rows = Tq * (H / KVH);
  dim3 grid(nsplit, (rows + kBlockRows - 1) / kBlockRows, B * KVH);
  return launch(paged_prefill_kernel<T, HD, GC>, kThreads,
                smem_bytes<T, HD, GC>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const int*>(table),
                static_cast<const int*>(q_offset),
                static_cast<const int*>(valid), static_cast<T*>(out),
                static_cast<float*>(ws), static_cast<int*>(count), Tq, H,
                KVH, page, max_pages, ck, scale);
}

template <typename T, int HD>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* table, const void* q_offset, const void* valid,
                void* out, void* ws, void* count, int B, int Tq, int H,
                int KVH, int page, int max_pages, int ck, int nsplit, int gc,
                float scale, cudaStream_t stream) {
#define PTT_GC(GC_)                                                          \
  if (gc == GC_)                                                             \
    return run_gc<T, HD, GC_>(q, k, v, table, q_offset, valid, out, ws,      \
                              count, B, Tq, H, KVH, page, max_pages, ck,     \
                              nsplit, scale, stream);
  PTT_GC(1)
  PTT_GC(2)
  PTT_GC(4)
  PTT_GC(8)
#undef PTT_GC
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  The split plan (ck keys a block, nsplit
// blocks a tile's key range, stream-lane capacity gc) comes from the caller,
// which sizes ws and count by it.  Returns cudaGetLastError() after launch.
extern "C" int paged_prefill_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* q_offset, const void* valid, void* out, void* ws,
    void* count, int B, int Tq, int H, int KVH, int hd, int page,
    int max_pages, int ck, int nsplit, int gc, float scale, int dtype,
    void* stream) {
  if (ck <= 0 || (long long)ck * nsplit < (long long)max_pages * page)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_CASE(TY, HD_)                                                     \
  if (hd == HD_)                                                            \
    return (int)run<TY, HD_>(q, k, v, table, q_offset, valid, out, ws,      \
                             count, B, Tq, H, KVH, page, max_pages, ck,     \
                             nsplit, gc, scale, s);
  if (dtype == 0) {
    PTT_CASE(float, 64)
    PTT_CASE(float, 128)
    PTT_CASE(float, 256)
  } else if (dtype == 1) {
    PTT_CASE(__nv_bfloat16, 64)
    PTT_CASE(__nv_bfloat16, 128)
    PTT_CASE(__nv_bfloat16, 256)
  }
#undef PTT_CASE
  return (int)cudaErrorInvalidValue;
}
