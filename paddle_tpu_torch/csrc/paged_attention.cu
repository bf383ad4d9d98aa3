// Causal-at-offset attention through a page table, for the fused serving step.
//
// Replaces the TPU kernel paddle_tpu/incubate/kernels/paged_attention.py::
// _paged_prefill_kernel (launched by paged_prefill_attention_pallas).  Query
// t of slot b sits at position q_offset[b] + t and sees kv positions <= it;
// rows t >= valid[b] are padding (their output is unspecified, as in the
// TPU kernel).  GQA: kv head kh serves query heads kh*G .. kh*G+G-1, and the
// block stacks its G*T query rows t-major, g-minor as the TPU kernel does.
//
// Grid (ceil(T*G / 16), KVH, B): one block per (slot, kv head, tile of 16
// query rows).  The TPU grid's sequential page axis becomes the key loop
// inside the block (attention_tile.cuh), bounded by the last REAL query
// position q_offset + valid - 1 (pages past it are never read).  Each key
// row is found through the block's own table row, so any page size works
// and the pool is never gathered into a dense copy.  A null-table slot
// (valid 1, q_offset 0) attends to position 0 of the null page only.
//
// Bound on the H100: bytes.  Decode moves each slot's K/V once for G query
// rows per kv head (~2 flops per byte), far below the ~295 flops per byte
// where the tensor cores would bind.  The design reads every K/V row once
// per block with 16-byte loads, keeps scores and probabilities in registers
// and writes the output once in [B, T, H, hd].  Not yet done: splitting the
// key loop across blocks at small B*KVH (flash-decoding), and a
// wgmma/TMA pipeline for the chunk lanes.
#include "attention_tile.cuh"

using namespace ptt;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ valid_, T* __restrict__ out,
                     int Tq, int H, int KVH, int page, int max_pages,
                     float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockRows * HD;
  float* vs = ks + kKeys * Smem<HD>::kStride;

  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * kBlockRows;
  const int G = H / KVH, R = Tq * G;
  const int qoff = q_offset[b], valid = valid_[b];
  const int last_q = min(qoff + valid - 1, max_pages * page - 1);
  const int* trow = table + (size_t)b * max_pages;

  stage_rows<T, HD>(qs, [&](int rr) -> const T* {
    const int row = r0 + rr;
    if (row >= R) return nullptr;
    return q + (((size_t)b * Tq + row / G) * H + kh * G + row % G) * HD;
  });

  // padding rows are clamped to the last real row's horizon, so nothing
  // past last_q is ever read
  Horizon mask;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = min((r0 + local_row(r)) / G, valid - 1);
    mask.limit[r] = min(qoff + t, last_q);
  }
  const int t_hi = min((min(r0 + kBlockRows, R) - 1) / G, valid - 1);
  const int kv_end = min(qoff + t_hi, last_q) + 1;

  RowState<HD> st;
  st.init();
  attend<T, HD>(qs, ks, vs, kp, vp,
                [&](int pos) -> size_t {
                  const int p = trow[pos / page];
                  return (((size_t)p * page + pos % page) * KVH + kh) * HD;
                },
                kv_end, mask, scale, st);

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = r0 + local_row(r);
    if (row >= R) continue;
    const float l = fmaxf(st.l[r], 1e-30f);
    T* o = out + (((size_t)b * Tq + row / G) * H + kh * G + row % G) * HD;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) o[lane + 32 * i] = from_f<T>(st.acc[r][i] / l);
  }
}

template <typename T, int HD>
static cudaError_t run(const void* q, const void* k, const void* v,
                       const void* table, const void* q_offset,
                       const void* valid, void* out, int B, int Tq, int H,
                       int KVH, int page, int max_pages, float scale,
                       cudaStream_t stream) {
  const int rows = Tq * (H / KVH);
  dim3 grid((rows + kBlockRows - 1) / kBlockRows, KVH, B);
  return launch(paged_prefill_kernel<T, HD>, kThreads, Smem<HD>::kBytes,
                grid, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const int*>(table),
                static_cast<const int*>(q_offset),
                static_cast<const int*>(valid), static_cast<T*>(out), Tq, H,
                KVH, page, max_pages, scale);
}

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int paged_prefill_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* q_offset, const void* valid, void* out, int B, int Tq, int H,
    int KVH, int hd, int page, int max_pages, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_CASE(TY, HD_)                                                     \
  if (hd == HD_)                                                            \
    return (int)run<TY, HD_>(q, k, v, table, q_offset, valid, out, B, Tq, H, \
                             KVH, page, max_pages, scale, s);
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
