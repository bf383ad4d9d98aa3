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
// Grid (KVH * ceil(G / GC), B): one block per (slot, kv head, chunk of GC
// query heads), where GC is the smallest of 1, 2, 4, 8 that holds G (8, and
// several chunks, past G = 8).  At Llama-3-8B's G = 4 a block serves exactly
// the 4 query heads of its kv head, so each K/V row is read once per kv
// head; the 16-row tiles of the prefill kernel (paged_attention.cu) would
// waste 3/4 of their QK work there.  The TPU grid's sequential page axis
// becomes NS independent key streams inside the block: a group of LPK lanes
// owns one key row at a time (16-byte loads, HD / LPK elements a lane, a
// warp's groups on consecutive positions), stream s takes keys s, s + NS,
// ..., and keeps its own f32 online softmax (m, l, acc) for its GC query
// rows in registers; the streams merge once through shared memory at the
// end.  No block-wide barrier sits in the key loop.
//
// Bound on the H100: bytes.  The step reads each slot's K and V once,
// sum_b lengths[b] * KVH * hd * 2 * sizeof(T), for ~2 * G flops per
// element, far below the ~295 flops per byte where the tensor cores would
// bind.  Not yet done: at B * KVH = 64 blocks the card's 132 SMs are not
// all busy and each stream walks its keys with one load in flight, so the
// next step is splitting the key range across blocks (flash-decoding) with
// a second combine pass.
#include "attention_tile.cuh"

using namespace ptt;

namespace {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;

template <typename T, int HD> struct Dec {
  static constexpr int VN = Vec<T>::N;                    // elements a load
  static constexpr int LPK = HD / VN < 32 ? HD / VN : 32; // lanes a key row
  static constexpr int EPL = HD / LPK;                    // elements a lane
  static constexpr int KPW = 32 / LPK;                    // key rows a warp
  static constexpr int NS = kDecWarps * KPW;              // key streams
};

template <typename T, int HD, int GC> constexpr size_t dec_smem() {
  return (2 + HD) * Dec<T, HD>::NS * GC * sizeof(float);
}

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int KVH, int page, int max_pages, float scale) {
  using D = Dec<T, HD>;
  extern __shared__ float smem[];
  float* ms = smem;                          // [NS][GC] running max
  float* ls = ms + D::NS * GC;               // [NS][GC] running sum
  float* accs = ls + D::NS * GC;             // [NS][GC][HD]

  const int G = H / KVH, chunks = (G + GC - 1) / GC;
  const int b = blockIdx.y, kh = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * GC;     // first head of the chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / D::LPK;                 // key row of the warp
  const int d0 = (lane % D::LPK) * D::EPL;       // first dim of this lane
  const int stream = warp * D::KPW + grp;
  const int len = min(lengths[b], max_pages * page);
  const int* trow = table + (size_t)b * max_pages;

  float qr[GC][D::EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g0 + g < G) {
      const T* src = q + ((size_t)b * H + kh * G + g0 + g) * HD + d0;
#pragma unroll
      for (int c = 0; c < D::EPL / D::VN; ++c)
        load16(src + c * D::VN, qr[g] + c * D::VN);
    } else {
#pragma unroll
      for (int e = 0; e < D::EPL; ++e) qr[g][e] = 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][D::EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < D::EPL; ++e) acc[g][e] = 0.f;
  }

  // every lane of a warp runs the same iterations (the shuffles need the
  // whole warp); a group past the length computes nothing
  for (int base = warp * D::KPW; base < len; base += D::NS) {
    const int pos = base + grp;
    const bool in = pos < len;
    float kr[D::EPL], vr[D::EPL];
    if (in) {
      const size_t o =
          (((size_t)trow[pos / page] * page + pos % page) * KVH + kh) * HD +
          d0;
#pragma unroll
      for (int c = 0; c < D::EPL / D::VN; ++c) {
        load16(kp + o + c * D::VN, kr + c * D::VN);
        load16(vp + o + c * D::VN, vr + c * D::VN);
      }
    } else {
#pragma unroll
      for (int e = 0; e < D::EPL; ++e) kr[e] = vr[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < D::EPL; ++e) s = fmaf(qr[g][e], kr[e], s);
#pragma unroll
      for (int off = D::LPK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const float x = in ? s * scale : kNegInf;
      const float mn = fmaxf(m[g], x);
      const float corr = expf(m[g] - mn);
      const float e = expf(x - mn);
      const float p = in ? e : 0.f;
      l[g] = l[g] * corr + p;
      m[g] = mn;
      const float pv = round_to<T>(p);      // p enters PV in v's dtype
#pragma unroll
      for (int e = 0; e < D::EPL; ++e)
        acc[g][e] = fmaf(pv, vr[e], acc[g][e] * corr);
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane % D::LPK == 0) {
      ms[stream * GC + g] = m[g];
      ls[stream * GC + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < D::EPL; ++e)
      accs[(stream * GC + g) * HD + d0 + e] = acc[g][e];
  }
  __syncthreads();

  // merge the streams: thread per (head, dim)
  for (int i = threadIdx.x; i < GC * HD; i += kDecThreads) {
    const int g = i / HD, d = i % HD;
    if (g0 + g >= G) continue;
    float mx = kNegInf;
    for (int s = 0; s < D::NS; ++s) mx = fmaxf(mx, ms[s * GC + g]);
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < D::NS; ++s) {
      const float w = expf(ms[s * GC + g] - mx);
      lsum = fmaf(ls[s * GC + g], w, lsum);
      a = fmaf(accs[(s * GC + g) * HD + d], w, a);
    }
    out[((size_t)b * H + kh * G + g0 + g) * HD + d] =
        from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int GC>
cudaError_t run_gc(const void* q, const void* k, const void* v,
                   const void* table, const void* lengths, void* out, int B,
                   int H, int KVH, int page, int max_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(KVH * ((G + GC - 1) / GC), B);
  return launch(paged_decode_kernel<T, HD, GC>, kDecThreads,
                dec_smem<T, HD, GC>(), grid, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const int*>(table),
                static_cast<const int*>(lengths), static_cast<T*>(out), H,
                KVH, page, max_pages, scale);
}

template <typename T, int HD>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* table, const void* lengths, void* out, int B,
                int H, int KVH, int page, int max_pages, float scale,
                cudaStream_t stream) {
  const int G = H / KVH;
#define PTT_GC(GC_)                                                          \
  return run_gc<T, HD, GC_>(q, k, v, table, lengths, out, B, H, KVH, page,   \
                            max_pages, scale, stream)
  if (G <= 1) PTT_GC(1);
  if (G <= 2) PTT_GC(2);
  if (G <= 4) PTT_GC(4);
  PTT_GC(8);
#undef PTT_GC
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lengths, void* out, int B,
                                      int H, int KVH, int hd, int page,
                                      int max_pages, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_CASE(TY, HD_)                                                    \
  if (hd == HD_)                                                           \
    return (int)run<TY, HD_>(q, k, v, table, lengths, out, B, H, KVH, page, \
                             max_pages, scale, s);
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
