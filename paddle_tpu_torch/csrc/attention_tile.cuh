// Shared body of the port's two attention kernels (paged_attention.cu,
// flash_attention.cu): a block stages up to kBlockRows query rows in shared
// memory, then walks the keys in tiles of kKeys with an f32 online softmax.
//
// Work split: 4 warps x 4 rows each.  Within a key tile lane j owns key j:
// it computes the 4 scores of its warp's rows against key j (q rows are
// broadcast reads, K rows are padded to HD+1 floats so the 32 lanes hit 32
// banks), the warp reduces max and sum with shuffles, and the PV product
// runs lane-over-head-dim (lane owns dims lane, lane+32, ...) with the
// probabilities broadcast by shuffle.  The key tile is loaded with 16-byte
// vector loads, neighbouring threads on neighbouring addresses of one key
// row, through a caller-supplied key -> element-offset map (a dense row for
// flash attention, the page table for paged attention).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ptt {

constexpr float kNegInf = -1e30f;      // NEG_INF of the reference kernels
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;                           // keys per tile: one per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The probabilities enter the PV product in the value dtype, as in the TPU
// kernels (`p.astype(v.dtype)`) and the plain versions.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// One 16-byte load of Vec<T>::N elements, widened to float.  The wrappers
// check that every row start is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_f(e[i]);
}

template <int HD> struct Smem {
  static constexpr int kStride = HD + 1;     // padded K row
  static constexpr size_t kFloats =
      kBlockRows * HD + kKeys * kStride + kKeys * HD;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Online-softmax state of one warp's rows, as in the TPU kernels' (acc, m, l)
// scratch; lane holds acc dims lane + 32 * i.
template <int HD> struct RowState {
  float acc[kRowsPerWarp][HD / 32];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) acc[r][i] = 0.f;
    }
  }
};

// Local row rr of the block is handled by warp rr % kWarps, slot rr / kWarps,
// so a block with few rows (decode: G rows) still spreads them over warps.
__device__ __forceinline__ int local_row(int r) {
  return r * kWarps + (threadIdx.x >> 5);
}

// Stage the block's query rows into qs[kBlockRows][HD] as float;
// row_ptr(rr) is the row's first element, or nullptr past the last row.
template <typename T, int HD, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* qs, RowPtr row_ptr) {
  constexpr int VN = Vec<T>::N, CH = HD / VN;
  for (int c = threadIdx.x; c < kBlockRows * CH; c += kThreads) {
    const int rr = c / CH, d = (c % CH) * VN;
    float buf[VN];
    const T* src = row_ptr(rr);
    if (src != nullptr) {
      load16(src + d, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) buf[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) qs[rr * HD + d + i] = buf[i];
  }
}

// Attend the warp's rows over keys [0, kv_end): limit[r] is the last key
// position row r may see (scores past it are masked to kNegInf).  Key 0 is
// visible to every row, so the running max is finite after the first tile
// and a later fully masked tile contributes exp(-1e30 - m) = 0.
template <typename T, int HD, typename KeyOff>
__device__ __forceinline__ void attend(const float* qs, float* ks, float* vs,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v, KeyOff key_off,
                                       int kv_end,
                                       const int (&limit)[kRowsPerWarp],
                                       float scale, RowState<HD>& st) {
  constexpr int VN = Vec<T>::N, CH = HD / VN, KS = Smem<HD>::kStride;
  constexpr int DPL = HD / 32;
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();                    // q staged / previous tile consumed
    for (int c = threadIdx.x; c < kKeys * CH; c += kThreads) {
      const int j = c / CH, d = (c % CH) * VN, pos = k0 + j;
      float kb[VN], vb[VN];
      if (pos < kv_end) {
        const size_t o = key_off(pos);
        load16(k + o + d, kb);
        load16(v + o + d, vb);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kb[i] = vb[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        ks[j * KS + d + i] = kb[i];
        vs[j * HD + d + i] = vb[i];
      }
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * KS;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[local_row(r) * HD + d], kd, s[r]);
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float x = (k0 + lane <= limit[r]) ? s[r] * scale : kNegInf;
      const float mn = fmaxf(st.m[r], warp_max(x));
      const float corr = expf(st.m[r] - mn);
      const float pr = expf(x - mn);
      st.l[r] = st.l[r] * corr + warp_sum(pr);
      st.m[r] = mn;
      p[r] = round_to<T>(pr);
#pragma unroll
      for (int i = 0; i < DPL; ++i) st.acc[r][i] *= corr;
    }

    for (int j = 0; j < kKeys; ++j) {
      float vd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vd[i] = vs[j * HD + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) st.acc[r][i] = fmaf(pj, vd[i], st.acc[r][i]);
      }
    }
  }
}

// Raise the dynamic shared-memory cap of `kern` (above 48 KB it must be
// requested explicitly), then launch on `stream`.
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ptt
