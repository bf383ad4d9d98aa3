// Attention backward under the segment mask: dK/dV and dQ.
//
// Replaces the TPU kernels paddle_tpu/incubate/kernels/flash_attention.py::
// _flash_bwd_seg_dkv_kernel and _flash_bwd_seg_dq_kernel (launched by
// _flash_seg_bwd_impl): the SEG instantiations of the dense pair's two
// bodies, chosen as flash_attention_bwd.cu chooses them (BWD_BODY in
// incubate/kernels/flash_attention.py):
//
// - bf16 at D = 64 and 128: the tensor-core body of attention_bwd_wgmma.cuh,
//   whose producer warp skips the walked tiles by segment-id range.
// - float32, and bf16 at D = 256: the CUDA-core body of
//   attention_bwd_tile.cuh, which skips the same way, a tile at a time.
//
// Its own compilation unit, so nvcc builds it in parallel with the dense
// kernels of flash_attention_bwd.cu.
#include "attention_bwd_tile.cuh"
#include "attention_bwd_wgmma.cuh"

using namespace ptt;

#define PTT_DISPATCH(CALL, WG)                                               \
  if (dtype == 0) {                                                          \
    if (D == 64) return (int)CALL(float, 64);                                \
    if (D == 128) return (int)CALL(float, 128);                              \
    if (D == 256) return (int)CALL(float, 256);                              \
  } else if (dtype == 1) {                                                   \
    if (D == 64) return (int)WG(64);                                         \
    if (D == 128) return (int)WG(128);                                       \
    if (D == 256) return (int)CALL(__nv_bfloat16, 256);                      \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

#define PTT_DKV(TY, HD_)                                                     \
  run_dkv<TY, HD_, true>(q, k, v, dout, lse, delta, seg_q, seg_k, dk, dv, B, \
                         S, Sk, H, causal, scale,                            \
                         static_cast<cudaStream_t>(stream))
#define PTT_DQ(TY, HD_)                                                      \
  run_dq<TY, HD_, true>(q, k, v, dout, lse, delta, seg_q, seg_k, dq, B, S,   \
                        Sk, H, causal, scale,                                \
                        static_cast<cudaStream_t>(stream))
#define PTT_WG_DKV(HD_)                                                      \
  wg::run_bwd_dkv<HD_, true>(q, k, v, dout, lse, delta, seg_q, seg_k, dk,    \
                             dv, B, S, Sk, H, causal, scale,                 \
                             static_cast<cudaStream_t>(stream))
#define PTT_WG_DQ(HD_)                                                       \
  wg::run_bwd_dq<HD_, true>(q, k, v, dout, lse, delta, seg_q, seg_k, dq, B,  \
                            S, Sk, H, causal, scale,                         \
                            static_cast<cudaStream_t>(stream))

// seg_q [B, S], seg_k [B, Sk] int32; dtype: 0 float32, 1 bfloat16.  Each
// returns cudaGetLastError() after its launch.
extern "C" int flash_attention_seg_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    void* dk, void* dv, int B, int S, int Sk, int H, int D, int causal,
    float scale, int dtype, void* stream) {
  PTT_DISPATCH(PTT_DKV, PTT_WG_DKV)
}

extern "C" int flash_attention_seg_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    void* dq, int B, int S, int Sk, int H, int D, int causal, float scale,
    int dtype, void* stream) {
  PTT_DISPATCH(PTT_DQ, PTT_WG_DQ)
}
#undef PTT_WG_DQ
#undef PTT_WG_DKV
#undef PTT_DQ
#undef PTT_DKV
#undef PTT_DISPATCH
