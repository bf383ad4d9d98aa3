// Attention backward, dense: dK/dV and dQ, with p recomputed from lse.
//
// Replaces the TPU kernels paddle_tpu/incubate/kernels/flash_attention.py::
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel (launched by
// _flash_bwd_impl).  Two bodies, chosen by the dispatch below from dtype
// and D alone (BWD_BODY in incubate/kernels/flash_attention.py):
//
// - bf16 at D = 64 and 128: the tensor-core body of attention_bwd_wgmma.cuh
//   (wgmma products, TMA-fed rings, one producer warp and consumer
//   warpgroups, f32 accumulators in registers).
// - float32, and bf16 at D = 256: the CUDA-core body of
//   attention_bwd_tile.cuh (tensor cores in f32 would mean TF32, outside
//   the f32 tolerance; at D = 256 the dkv kernel's dK and dV accumulators
//   alone fill a thread's 255 registers).
//
// The segment-masked twins are flash_attention_seg_bwd.cu's (the same two
// bodies, chosen the same way), built in parallel with this file.
#include "attention_bwd_tile.cuh"
#include "attention_bwd_wgmma.cuh"

using namespace ptt;

#define PTT_DKV(TY, HD_)                                                     \
  run_dkv<TY, HD_, false>(q, k, v, dout, lse, delta, nullptr, nullptr, dk,   \
                          dv, B, S, Sk, H, causal, scale,                    \
                          static_cast<cudaStream_t>(stream))
#define PTT_DQ(TY, HD_)                                                      \
  run_dq<TY, HD_, false>(q, k, v, dout, lse, delta, nullptr, nullptr, dq, B, \
                         S, Sk, H, causal, scale,                            \
                         static_cast<cudaStream_t>(stream))

// dtype: 0 float32, 1 bfloat16.  Each returns cudaGetLastError() after its
// launch.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int Sk, int H, int D, int causal,
                                       float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 64) return (int)PTT_DKV(float, 64);
    if (D == 128) return (int)PTT_DKV(float, 128);
    if (D == 256) return (int)PTT_DKV(float, 256);
  } else if (dtype == 1) {
    if (D == 64)
      return (int)wg::run_bwd_dkv<64, false>(q, k, v, dout, lse, delta,
                                             nullptr, nullptr, dk, dv, B, S,
                                             Sk, H, causal, scale, st);
    if (D == 128)
      return (int)wg::run_bwd_dkv<128, false>(q, k, v, dout, lse, delta,
                                              nullptr, nullptr, dk, dv, B, S,
                                              Sk, H, causal, scale, st);
    if (D == 256) return (int)PTT_DKV(__nv_bfloat16, 256);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int S, int Sk, int H,
                                      int D, int causal, float scale,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 64) return (int)PTT_DQ(float, 64);
    if (D == 128) return (int)PTT_DQ(float, 128);
    if (D == 256) return (int)PTT_DQ(float, 256);
  } else if (dtype == 1) {
    if (D == 64)
      return (int)wg::run_bwd_dq<64, false>(q, k, v, dout, lse, delta,
                                            nullptr, nullptr, dq, B, S, Sk, H,
                                            causal, scale, st);
    if (D == 128)
      return (int)wg::run_bwd_dq<128, false>(q, k, v, dout, lse, delta,
                                             nullptr, nullptr, dq, B, S, Sk,
                                             H, causal, scale, st);
    if (D == 256) return (int)PTT_DQ(__nv_bfloat16, 256);
  }
  return (int)cudaErrorInvalidValue;
}
#undef PTT_DQ
#undef PTT_DKV
