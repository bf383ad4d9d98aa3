// Attention forward with per-row logsumexp, dense or segment-masked.
//
// Replaces the TPU kernels paddle_tpu/incubate/kernels/flash_attention.py::
// _flash_fwd_kernel (launched by _flash_fwd_impl) and _flash_fwd_seg_kernel
// (launched by _flash_seg_fwd_impl).  q, k, v are [B, S, H, D] read in place
// (no transpose to [B*H, S, D]); out is [B, S, H, D] and lse is [B*H, S]
// float32.  Dense causal means row + (Sk - S) >= col, which is the TPU
// kernel's row >= col on equal lengths.  The segment-masked instantiation
// (SEG) takes seg_q [B, S] and seg_k [B, Sk] int32 and lets row i see key j
// only where seg_q[b, i] == seg_k[b, j] (and i >= j when causal, which needs
// S == Sk): the TPU's _seg_mask.  Masked probabilities are zeroed after the
// exp, so a row that sees no key gives out = 0 and lse = -1e30 + log(1e-30),
// the TPU kernel's finalize.  Any S >= 1 works: ragged query and key tiles
// are masked.
//
// Bound on the H100: in bf16 the causal forward does ~S/4 flops per byte
// of q, k, v and out, against the card's ~295 (989 TFLOP/s on the tensor
// cores over 3.35 TB/s): at the training S = 2048 it is bound by operations
// on the tensor cores, at the prefill S = 1024 the two bounds nearly meet.
// Either way the work must run on the tensor cores.  Two bodies:
//
// - bf16: attention_wgmma.cuh.  Both products on the tensor cores (wgmma
//   m64n64k16, bf16 operands, f32 accumulators in registers: the TPU
//   kernel's jnp.dot(..., preferred_element_type=f32) with p rounded to bf16
//   before PV), K/V tiles of 64 keys fed by TMA into a ring of 2-4 shared
//   stages by a producer warp while two consumer warpgroups (one for
//   D = 256) of 64 query rows each compute, softmax on the accumulator
//   fragments.  Grid (B*H, ceil(S / rows a block)), the longest causal query
//   tiles first; a block walks key tiles only up to its last visible key,
//   and under SEG skips every tile whose segment-id range misses the
//   block's (exact for unsorted ids).
// - f32: the CUDA-core body of attention_tile.cuh (tensor cores in f32
//   would mean TF32, outside the f32 tolerance).  Grid (ceil(S / 16), B*H):
//   one block per (batch-head, tile of 16 query rows); the TPU grid's
//   sequential K axis becomes the key loop inside the block, which stops at
//   the tile's last visible key.  No tile is skipped across segments.
#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

using namespace ptt;

// The segment kernels' mask: segment equality, AND row >= col when causal;
// keys at or past Sk (the last tile's tail) are masked.
struct SegMask {
  static constexpr bool kZeroMasked = true;
  const int* seg_k;                  // this batch row's key segment ids
  int Sk;
  int seg[kRowsPerWarp];             // each of the warp's rows' segment id
  int row[kRowsPerWarp];
  int causal;
  __device__ __forceinline__ int tag(int pos) const {
    return pos < Sk ? seg_k[pos] : 0;
  }
  __device__ __forceinline__ bool operator()(int r, int pos, int t) const {
    return pos < Sk && t == seg[r] && (!causal || row[r] >= pos);
  }
};

template <typename T, int HD, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, T* __restrict__ out,
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

  const int kv_end =
      causal ? min(min(r0 + kBlockRows, S) - 1 + shift, Sk - 1) + 1 : Sk;
  auto key_off = [&](int pos) -> size_t {
    return (((size_t)b * Sk + pos) * H + h) * HD;
  };
  RowState<HD> st;
  st.init();
  if constexpr (SEG) {
    SegMask mask;
    mask.seg_k = seg_k + (size_t)b * Sk;
    mask.Sk = Sk;
    mask.causal = causal;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = r0 + local_row(r);
      mask.row[r] = row;
      mask.seg[r] = row < S ? seg_q[(size_t)b * S + row] : 0;
    }
    attend<T, HD>(qs, ks, vs, k, v, key_off, kv_end, mask, scale, st);
  } else {
    Horizon mask;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      mask.limit[r] =
          causal ? min(r0 + local_row(r) + shift, Sk - 1) : Sk - 1;
    attend<T, HD>(qs, ks, vs, k, v, key_off, kv_end, mask, scale, st);
  }

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

template <typename T, int HD, bool SEG>
static cudaError_t run(const void* q, const void* k, const void* v,
                       const void* seg_q, const void* seg_k, void* out,
                       void* lse, int B, int S, int Sk, int H, int causal,
                       float scale, cudaStream_t stream) {
  dim3 grid((S + kBlockRows - 1) / kBlockRows, B * H);
  return launch(flash_fwd_kernel<T, HD, SEG>, kThreads, Smem<HD>::kBytes,
                grid, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
                static_cast<T*>(out), static_cast<float*>(lse), S, Sk, H,
                causal, scale);
}

#define PTT_DISPATCH(SEG_)                                                   \
  if (dtype == 0) {                                                          \
    if (D == 64) return (int)PTT_RUN(float, 64, SEG_);                       \
    if (D == 128) return (int)PTT_RUN(float, 128, SEG_);                     \
    if (D == 256) return (int)PTT_RUN(float, 256, SEG_);                     \
  } else if (dtype == 1) {                                                   \
    if (D == 64) return (int)PTT_RUN_WG(64, SEG_);                           \
    if (D == 128) return (int)PTT_RUN_WG(128, SEG_);                         \
    if (D == 256) return (int)PTT_RUN_WG(256, SEG_);                         \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

#define PTT_RUN(TY, HD_, SEG_)                                               \
  run<TY, HD_, SEG_>(q, k, v, seg_q, seg_k, out, lse, B, S, Sk, H, causal,   \
                     scale, static_cast<cudaStream_t>(stream))
#define PTT_RUN_WG(HD_, SEG_)                                                \
  wg::run<HD_, SEG_>(q, k, v, seg_q, seg_k, out, lse, B, S, Sk, H, causal,   \
                     scale, static_cast<cudaStream_t>(stream))

// dtype: 0 float32, 1 bfloat16.  Each returns cudaGetLastError() after its
// launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int S, int Sk, int H, int D, int causal,
                                   float scale, int dtype, void* stream) {
  const void* seg_q = nullptr;
  const void* seg_k = nullptr;
  PTT_DISPATCH(false)
}

// seg_q [B, S], seg_k [B, Sk] int32.
extern "C" int flash_attention_seg_fwd(const void* q, const void* k,
                                       const void* v, const void* seg_q,
                                       const void* seg_k, void* out,
                                       void* lse, int B, int S, int Sk, int H,
                                       int D, int causal, float scale,
                                       int dtype, void* stream) {
  PTT_DISPATCH(true)
}
#undef PTT_RUN
#undef PTT_RUN_WG
#undef PTT_DISPATCH
