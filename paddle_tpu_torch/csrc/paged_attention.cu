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
//    takes the key streams of paged_split.cuh (shared with paged_decode.cu):
//    LPK lanes own one key row (16-byte loads), each stream walks two keys a
//    pass with both loads in flight and keeps its own (m, l, acc) for the
//    slot's rows in registers, and the streams merge once through shared
//    memory.  Rows past G*valid are
//    skipped, not computed.  Other slots (prefill chunks, long verify) keep
//    attention_tile.cuh's 16-row tiles over their split.
// 3. Padding rows walked the keys under a clamped horizon.  Now a row tile
//    with no real row writes zeros and walks nothing.
//
// Under a split a row's horizon may lie below the split's first key, so
// masked probabilities are zeroed after the exp in both lanes (the tile
// lane through SplitHorizon), as paged_split.cuh sets out.
//
// The int8 lane (the TPU kernel's `quantized` lane, an int8 pool with
// per-token, per-kv-head f32 scales [P, page, KVH]) is the same kernel over
// a pool of KV = int8: each key row dequantizes to f32 as it is read, by one
// multiply with its scale (the stream lane in registers, the tile lane while
// staging the f32 shared-memory tiles), and p enters the PV product in f32,
// as the reference's lane keeps it.  Its key rows are half a bf16 row's
// bytes; the split plan is the fp lane's (PERF.md holds its ck sweep).
//
// Not yet done: the tile lane on the tensor cores (wgmma) for chunk slots,
// and TMA or cp.async rings for the page gathers of both lanes.
#include "paged_split.cuh"

using namespace ptt;

namespace {

template <typename KV, int HD, int GC> constexpr size_t smem_bytes() {
  constexpr size_t strm = strm_smem_bytes<KV, HD, GC>();
  return strm > Smem<HD>::kBytes ? strm : Smem<HD>::kBytes;
}

// Horizon under a key split: a row may see no key of the block's range.
struct SplitHorizon : Horizon {
  static constexpr bool kZeroMasked = true;
};

// The tile lane: attention_tile.cuh's 16 rows (real rows < `real`) over
// keys [kv_begin, kv_stop); padding rows take the last real row's horizon.
template <typename T, typename KV, int HD>
__device__ __forceinline__ void tile_lane(
    const Blk<T>& k, float* smem, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ trow, int page,
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
                kv_stop, mask, scale, st, kv_begin, ksc, vsc);

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

// Grid (nsplit, ceil(Tq*G / 16), B*KVH): block (s, x, b*KVH + kh) owns
// query rows x*16 .. x*16+15 of (b, kh) and keys [s*ck, (s+1)*ck).
// ws: [tiles][nsplit][16][HD] acc, then [tiles][16][nsplit] m and l (f32);
// count: [tiles] int32, 0 between calls.  ksc / vsc: the int8 pool's
// scales [P, page, KVH] (unread for a float pool).
template <typename T, typename KV, int HD, int GC>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp,
                     const float* __restrict__ ksc,
                     const float* __restrict__ vsc,
                     const int* __restrict__ table,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ valid_, T* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ count, int Tq,
                     int H, int KVH, int page, int max_pages, int ck,
                     float scale) {
  extern __shared__ float smem[];
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
  k.bind(ws, tile, tiles, HD, s, n == 1);

  const int* trow = table + (size_t)b * max_pages;
  if (G * valid <= GC)            // decode and short verify: all in tile 0
    stream_lane<T, KV, HD, GC>(k, smem, kp, vp, ksc, vsc, trow, page, KVH,
                               real, qoff, last_q, kv_begin, kv_stop, scale);
  else
    tile_lane<T, KV, HD>(k, smem, kp, vp, ksc, vsc, trow, page, KVH, rows,
                         real, qoff, valid, last_q, kv_begin, kv_stop,
                         scale);

  // a tile over several splits: its last block merges, the others are done
  if (n > 1 && !merge_when_last<T, HD>(k, count, tile, n, real)) return;
  zero_rows<T, HD>(k, real, rows);
}

template <typename T, typename KV, int HD, int GC>
cudaError_t run_gc(const void* q, const void* k, const void* v,
                   const void* ksc, const void* vsc,
                   const void* table, const void* q_offset,
                   const void* valid, void* out, void* ws, void* count,
                   int B, int Tq, int H, int KVH, int page, int max_pages,
                   int ck, int nsplit, float scale, cudaStream_t stream) {
  const int rows = Tq * (H / KVH);
  dim3 grid(nsplit, (rows + kBlockRows - 1) / kBlockRows, B * KVH);
  return launch(paged_prefill_kernel<T, KV, HD, GC>, kThreads,
                smem_bytes<KV, HD, GC>(), grid, stream,
                static_cast<const T*>(q), static_cast<const KV*>(k),
                static_cast<const KV*>(v), static_cast<const float*>(ksc),
                static_cast<const float*>(vsc),
                static_cast<const int*>(table),
                static_cast<const int*>(q_offset),
                static_cast<const int*>(valid), static_cast<T*>(out),
                static_cast<float*>(ws), static_cast<int*>(count), Tq, H,
                KVH, page, max_pages, ck, scale);
}

template <typename T, typename KV, int HD>
cudaError_t run(const void* q, const void* k, const void* v, const void* ksc,
                const void* vsc, const void* table, const void* q_offset,
                const void* valid, void* out, void* ws, void* count, int B,
                int Tq, int H, int KVH, int page, int max_pages, int ck,
                int nsplit, int gc, float scale, cudaStream_t stream) {
#define PTT_GC(GC_)                                                          \
  if (gc == GC_)                                                             \
    return run_gc<T, KV, HD, GC_>(q, k, v, ksc, vsc, table, q_offset,     \
                                  valid, out, ws, count, B, Tq, H, KVH,     \
                                  page, max_pages, ck, nsplit, scale,       \
                                  stream);
  PTT_GC(1)
  PTT_GC(2)
  PTT_GC(4)
  PTT_GC(8)
#undef PTT_GC
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: q's, 0 float32 or 1 bfloat16; kv_dtype: the pool's, q's code or
// 2 for int8, whose f32 scales k_scale / v_scale [P, page, KVH] the int8
// lane reads (null for a float pool).  The split plan (ck keys a block,
// nsplit blocks a tile's key range, stream-lane capacity gc) comes from the
// caller, which sizes ws and count by it.  Returns cudaGetLastError() after
// launch, or -1 for a combination of dtypes and head dim it does not
// instantiate.
extern "C" int paged_prefill_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* q_offset,
    const void* valid, void* out, void* ws, void* count, int B, int Tq,
    int H, int KVH, int hd, int page, int max_pages, int ck, int nsplit,
    int gc, float scale, int dtype, int kv_dtype, void* stream) {
  if (ck <= 0 || (long long)ck * nsplit < (long long)max_pages * page)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_CASE(TY, KV, HD_)                                                 \
  if (hd == HD_)                                                            \
    return (int)run<TY, KV, HD_>(q, k, v, k_scale, v_scale, table,          \
                                 q_offset, valid, out, ws, count, B, Tq, H, \
                                 KVH, page, max_pages, ck, nsplit, gc,      \
                                 scale, s);
#define PTT_HDS(TY, KV)                                                       \
  PTT_CASE(TY, KV, 64)                                                      \
  PTT_CASE(TY, KV, 128)                                                     \
  PTT_CASE(TY, KV, 256)
  if (dtype == 0 && kv_dtype == 0) {
    PTT_HDS(float, float)
  } else if (dtype == 1 && kv_dtype == 1) {
    PTT_HDS(__nv_bfloat16, __nv_bfloat16)
  } else if (dtype == 0 && kv_dtype == 2) {
    PTT_HDS(float, int8_t)
  } else if (dtype == 1 && kv_dtype == 2) {
    PTT_HDS(__nv_bfloat16, int8_t)
  }
#undef PTT_HDS
#undef PTT_CASE
  return -1;
}
