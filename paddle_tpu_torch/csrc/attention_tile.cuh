// Shared body of the port's two tiled attention forward kernels
// (paged_attention.cu, flash_attention.cu), whose helpers the backward
// kernels (flash_attention_bwd.cu) and the decode kernel (paged_decode.cu)
// reuse: a block stages up to kBlockRows query rows in shared memory, then
// walks the keys in tiles of kKeys with an f32 online softmax.
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
#include <stdint.h>

#include <type_traits>

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

// The pool rows of the paged kernels: float32 or bfloat16 like q, or int8
// with one f32 scale a row (key or value of one token and kv head), as the
// reference's quantized lane.  A vector load takes 16 bytes of a float
// type and 8 of int8, so an int8 row keeps the bf16 row's loads a lane.
template <typename KV> struct KVec { static constexpr int N = 16 / sizeof(KV); };
template <> struct KVec<int8_t> { static constexpr int N = 8; };

template <typename KV>
constexpr bool kQuantized = std::is_same<KV, int8_t>::value;

// One vector load of a pool row, widened to float: a float type as it is,
// int8 values times their row's scale `s` (the reference's dequant on
// read, `k.astype(f32) * k_scale`: one f32 multiply each).
template <typename KV>
__device__ __forceinline__ void load_kv(const KV* src, float, float* dst) {
  load16(src, dst);
}
template <>
__device__ __forceinline__ void load_kv<int8_t>(const int8_t* src, float s,
                                                float* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = static_cast<float>(e[i]) * s;
}

// p enters the PV product in the dtype of the values it weighs: the
// pool's for a float pool; float32 for int8, whose values dequantize to
// f32 (the reference's `p.astype(v.dtype)` with v in f32 keeps p whole).
template <typename KV> __device__ __forceinline__ float round_p(float x) {
  return round_to<KV>(x);
}
template <> __device__ __forceinline__ float round_p<int8_t>(float x) {
  return x;
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

// The dense kernels' mask: row r sees the keys up to position limit[r]
// (< kv_end).  Key 0 is visible to every row, so the running max is finite
// after the first tile and a later masked score adds exp(-1e30 - m) = 0:
// no zeroing needed (kZeroMasked false).
struct Horizon {
  static constexpr bool kZeroMasked = false;
  int limit[kRowsPerWarp];
  __device__ __forceinline__ int tag(int) const { return 0; }
  __device__ __forceinline__ bool operator()(int r, int pos, int) const {
    return pos <= limit[r];
  }
};

// Attend the warp's rows over keys [kv_begin, kv_end) (the paged kernel
// walks one split of a slot's keys; every other caller starts at 0).  The
// mask says which keys a row sees: mask.tag(pos) is read once per key, for
// every lane of the last
// tile too (what the mask needs to know of it, e.g. its segment id), and
// mask(r, pos, tag) decides for row r.  A masked score enters the running
// max as kNegInf.  A mask under which a row may see no key of a tile (or at
// all) sets kZeroMasked: its masked probabilities are zeroed after the exp,
// as in the TPU's segment kernels, so such a row gains no mass from them,
// ends with acc = l = 0 if it sees nothing, and the first key it does see
// resets m.
//
// k and v are q's dtype, or int8 (the paged kernels' quantized lane) with
// their rows' f32 scales k_scale / v_scale at key_off(pos) / HD: each key
// row dequantizes as it is staged into the f32 tiles.
template <typename T, int HD, typename KeyOff, typename Mask, typename KV>
__device__ __forceinline__ void attend(const float* qs, float* ks, float* vs,
                                       const KV* __restrict__ k,
                                       const KV* __restrict__ v, KeyOff key_off,
                                       int kv_end, Mask mask,
                                       float scale, RowState<HD>& st,
                                       int kv_begin = 0,
                                       const float* __restrict__ k_scale =
                                           nullptr,
                                       const float* __restrict__ v_scale =
                                           nullptr) {
  constexpr int VN = KVec<KV>::N, CH = HD / VN, KS = Smem<HD>::kStride;
  constexpr int DPL = HD / 32;
  const int lane = threadIdx.x & 31;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kKeys) {
    __syncthreads();                    // q staged / previous tile consumed
    for (int c = threadIdx.x; c < kKeys * CH; c += kThreads) {
      const int j = c / CH, d = (c % CH) * VN, pos = k0 + j;
      float kb[VN], vb[VN];
      if (pos < kv_end) {
        const size_t o = key_off(pos);
        float sk = 1.f, sv = 1.f;
        if constexpr (kQuantized<KV>) {
          sk = k_scale[o / HD];
          sv = v_scale[o / HD];
        }
        load_kv<KV>(k + o + d, sk, kb);
        load_kv<KV>(v + o + d, sv, vb);
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

    const int pos = k0 + lane;
    const int tag = mask.tag(pos);
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool vis = mask(r, pos, tag);
      const float x = vis ? s[r] * scale : kNegInf;
      const float mn = fmaxf(st.m[r], warp_max(x));
      const float corr = expf(st.m[r] - mn);
      const float e = expf(x - mn);     // unconditional: a select, no branch
      const float pr = (Mask::kZeroMasked && !vis) ? 0.f : e;
      st.l[r] = st.l[r] * corr + warp_sum(pr);
      st.m[r] = mn;
      p[r] = round_p<KV>(pr);
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
// requested explicitly), then launch `threads` threads a block on `stream`.
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, int threads, size_t smem, dim3 grid,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ptt
