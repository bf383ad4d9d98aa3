// Dense attention forward with per-row logsumexp.
//
// Replaces the TPU kernel paddle_tpu/incubate/kernels/flash_attention.py::
// _flash_fwd_kernel (launched by _flash_fwd_impl).  q, k, v are [B, S, H, D]
// read in place (no transpose to [B*H, S, D]); out is [B, S, H, D] and
// lse is [B*H, S] float32.  Causal means row + (Sk - S) >= col, which is the
// TPU kernel's row >= col on equal lengths.
//
// Grid (ceil(S / 16), B*H): one block per (batch-head, tile of 16 query
// rows); the TPU grid's sequential K axis becomes the key loop inside the
// block (attention_tile.cuh), which stops at the tile's last visible key, so
// whole tiles above the diagonal are skipped.  Any S >= 1 works: the last
// query tile and the last key tile are masked, there is no S >= 128 gate.
//
// Bound on the H100: at the prefill shapes (S up to 2048, D = 128) the
// causal forward does ~S/2 * 4 flops per byte of q/k/v, so an ideal kernel
// is bound by operations on the tensor cores.  This first kernel computes in
// f32 on the CUDA cores (FMA, 67 TFLOP/s peak, not 989), which is the main
// gap to its bound; the design's answer so far is to keep every
// intermediate on chip (scores and probabilities in registers, one K/V tile
// in shared memory, nothing S x S in device memory).  wgmma with TMA-fed
// tiles is the later step.
#include "attention_tile.cuh"

using namespace ptt;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Sk, int H, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockRows * HD;
  float* vs = ks + kKeys * Smem<HD>::kStride;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = blockIdx.x * kBlockRows;
  const int shift = Sk - S;

  stage_rows<T, HD>(qs, [&](int rr) -> const T* {
    const int row = r0 + rr;
    if (row >= S) return nullptr;
    return q + (((size_t)b * S + row) * H + h) * HD;
  });

  int limit[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    limit[r] = causal ? min(r0 + local_row(r) + shift, Sk - 1) : Sk - 1;
  const int kv_end =
      causal ? min(min(r0 + kBlockRows, S) - 1 + shift, Sk - 1) + 1 : Sk;

  RowState<HD> st;
  st.init();
  attend<T, HD>(qs, ks, vs, k, v,
                [&](int pos) -> size_t {
                  return (((size_t)b * Sk + pos) * H + h) * HD;
                },
                kv_end, limit, scale, st);

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = r0 + local_row(r);
    if (row >= S) continue;
    const float l = fmaxf(st.l[r], 1e-30f);
    T* o = out + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) o[lane + 32 * i] = from_f<T>(st.acc[r][i] / l);
    if (lane == 0) lse[(size_t)bh * S + row] = st.m[r] + logf(l);
  }
}

template <typename T, int HD>
static cudaError_t run(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int S, int Sk, int H, int causal,
                       float scale, cudaStream_t stream) {
  dim3 grid((S + kBlockRows - 1) / kBlockRows, B * H);
  return launch(flash_fwd_kernel<T, HD>, Smem<HD>::kBytes, grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out),
                static_cast<float*>(lse), S, Sk, H, causal, scale);
}

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int S, int Sk, int H, int D, int causal,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_CASE(TY, HD_)                                                    \
  if (D == HD_)                                                            \
    return (int)run<TY, HD_>(q, k, v, out, lse, B, S, Sk, H, causal, scale, \
                             s);
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
