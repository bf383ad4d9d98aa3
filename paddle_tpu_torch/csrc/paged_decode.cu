// One-query paged attention for the unfused decode step.
//
// Replaces the TPU kernel paddle_tpu/incubate/kernels/paged_attention.py::
// _paged_attn_kernel (launched by paged_attention_pallas).  q [B, H, hd];
// one layer's pool [P, page, KVH, hd] with page 0 as the null page; table
// [B, max_pages] int32; lengths [B] int32.  Slot b's query attends to the kv
// positions [0, lengths[b]) of its own table row (capped at the row's
// max_pages * page positions); pages past the length are never read.  GQA:
// kv head kh serves query heads kh*G .. kh*G+G-1.  A slot with length 0
// gets out = 0, as the TPU kernel's finalize gives.
//
// Bound on the H100: bytes.  The step reads each slot's K and V once,
// sum_b lengths[b] * KVH * hd * 2 * sizeof(T), for ~2 * G flops per
// element, far below the ~295 flops per byte where the tensor cores would
// bind.
//
// The first version gave one block to each (slot, kv head, chunk of GC query
// heads), which walked the slot's whole length with one key in flight per
// stream: 64 blocks at Llama-3-8B's B 8, KVH 8 on 132 SMs, and the longest
// slot set the time.  Now the grid is (nsplit, ceil(G / GC), B*KVH) from the
// host plan `_decode_split_plan` (incubate/kernels/paged_attention.py,
// shapes only): block s walks keys [s*ck, min((s+1)*ck, length)) of its slot
// and returns at once when that range is empty.  GC, the block's query heads,
// is the smallest of 1, 2, 4, 8 that holds G (8, and several chunks, past
// G = 8), so each K/V row is read once per chunk.  The walk is the stream
// lane of paged_split.cuh (NW warps, LPK lanes a key row with 16-byte loads,
// two keys in flight a stream, the streams merged once through shared
// memory).  A slot whose length fits one split writes out directly; over
// n > 1 splits each block stores f32 (m, l, acc) partials and the last to
// finish merges them in split order (merge_when_last), so two calls give
// the same bits.  The workspace layout and the merge counters are the
// prefill kernel's (paged_attention.cu), which runs on the same stream.
//
// The int8 lane (the TPU kernel's `quantized` lane: int8 pages with
// per-token, per-kv-head f32 scales [P, page, KVH]) is the same kernel over
// a pool of KV = int8: the key streams load 8 int8 a lane (the bf16 lane's
// geometry), dequantize each row by one f32 multiply with its scale, and
// weigh the values by p in f32, as the reference's lane does.
#include "paged_split.cuh"

using namespace ptt;

namespace {

// Grid (nsplit, ceil(G / GC), B*KVH): block (s, c, b*KVH + kh) owns query
// heads kh*G + c*GC .. + GC - 1 of slot b and keys [s*ck, (s+1)*ck).
// ws: [tiles][nsplit][16][HD] acc, then [tiles][16][nsplit] m and l (f32);
// count: [tiles] int32, 0 between calls (tiles = B * KVH * chunks).
// ksc / vsc: the int8 pool's scales [P, page, KVH] (unread for a float
// pool).
template <typename T, typename KV, int HD, int GC, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ count, int H,
                    int KVH, int page, int max_pages, int ck, float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, c = blockIdx.y, nsplit = gridDim.x;
  const int b = blockIdx.z / KVH, kh = blockIdx.z % KVH;
  const int G = H / KVH, g0 = c * GC;
  const int nrows = min(GC, G - g0);
  const int len = min(lengths[b], max_pages * page);

  Blk<T> k;
  k.q = q;
  k.out = out;
  k.b = b;
  k.kh = kh;
  k.G = G;
  k.Tq = 1;
  k.H = H;
  k.r0 = g0;
  k.nsplit = nsplit;
  const int n = (len + ck - 1) / ck;                // splits of this slot
  if (n == 0) {                   // length 0: out 0, no key walked
    if (s == 0) zero_rows<T, HD, NW>(k, 0, nrows);
    return;
  }
  if (s >= n) return;
  const size_t tile = (size_t)blockIdx.z * gridDim.y + c;
  const size_t tiles = (size_t)gridDim.z * gridDim.y;
  k.bind(ws, tile, tiles, HD, s, n == 1);

  // every row sees keys < len: horizon len - 1
  stream_lane<T, KV, HD, GC, NW>(k, smem, kp, vp, ksc, vsc,
                                 table + (size_t)b * max_pages, page, KVH,
                                 nrows, len - 1, len - 1, s * ck,
                                 min(s * ck + ck, len), scale);
  if (n > 1) merge_when_last<T, HD, NW>(k, count, tile, n, nrows);
}

template <typename T, typename KV, int HD, int GC, int NW>
cudaError_t run_nw(const void* q, const void* k, const void* v,
                   const void* ksc, const void* vsc,
                   const void* table, const void* lengths, void* out,
                   void* ws, void* count, int B, int H, int KVH, int page,
                   int max_pages, int ck, int nsplit, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(nsplit, (G + GC - 1) / GC, B * KVH);
  return launch(paged_decode_kernel<T, KV, HD, GC, NW>, NW * 32,
                strm_smem_bytes<KV, HD, GC, NW>(), grid, stream,
                static_cast<const T*>(q), static_cast<const KV*>(k),
                static_cast<const KV*>(v), static_cast<const float*>(ksc),
                static_cast<const float*>(vsc),
                static_cast<const int*>(table),
                static_cast<const int*>(lengths), static_cast<T*>(out),
                static_cast<float*>(ws), static_cast<int*>(count), H, KVH,
                page, max_pages, ck, scale);
}

template <typename T, typename KV, int HD>
cudaError_t run(const void* q, const void* k, const void* v, const void* ksc,
                const void* vsc, const void* table, const void* lengths,
                void* out, void* ws, void* count, int B, int H, int KVH,
                int page, int max_pages, int ck, int nsplit, int warps,
                float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const int gc = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
#define PTT_GC(GC_, NW_)                                                     \
  if (gc == GC_ && warps == NW_)                                             \
    return run_nw<T, KV, HD, GC_, NW_>(q, k, v, ksc, vsc, table, lengths,  \
                                       out, ws, count, B, H, KVH, page,      \
                                       max_pages, ck, nsplit, scale,         \
                                       stream);
  PTT_GC(1, 4)
  PTT_GC(2, 4)
  PTT_GC(4, 4)
  PTT_GC(8, 4)
  PTT_GC(1, 8)
  PTT_GC(2, 8)
  PTT_GC(4, 8)
  PTT_GC(8, 8)
#undef PTT_GC
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: q's, 0 float32 or 1 bfloat16; kv_dtype: the pool's, q's code or
// 2 for int8, whose f32 scales k_scale / v_scale [P, page, KVH] the int8
// lane reads (null for a float pool).  The split plan (ck keys a block,
// nsplit blocks over a slot's max_pages * page positions) comes from the
// caller, which sizes ws and count by it; warps: 4 or 8 a block.  Returns
// cudaGetLastError() after launch, or -1 for a combination of dtypes and
// head dim it does not instantiate.
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* table,
                                      const void* lengths, void* out,
                                      void* ws, void* count, int B, int H,
                                      int KVH, int hd, int page,
                                      int max_pages, int ck, int nsplit,
                                      int warps, float scale, int dtype,
                                      int kv_dtype, void* stream) {
  if (ck <= 0 || (long long)ck * nsplit < (long long)max_pages * page)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_CASE(TY, KV, HD_)                                                \
  if (hd == HD_)                                                           \
    return (int)run<TY, KV, HD_>(q, k, v, k_scale, v_scale, table, lengths, \
                                 out, ws, count, B, H, KVH, page, max_pages,\
                                 ck, nsplit, warps, scale, s);
#define PTT_HDS(TY, KV)                                                      \
  PTT_CASE(TY, KV, 64)                                                     \
  PTT_CASE(TY, KV, 128)                                                    \
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
