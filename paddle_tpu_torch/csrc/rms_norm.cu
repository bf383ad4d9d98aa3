// RMSNorm over the last dim: out[n] = cast_x(x[n] * rsqrt(mean(x[n]^2) +
// eps)) * w, the product in promote(x, w).
//
// Replaces the TPU kernel paddle_tpu/incubate/kernels/rms_norm.py::
// _rms_kernel (launched by _rms_fwd_impl): the sum of squares in f32, the
// normalised row cast to x's dtype BEFORE the multiply by w, as the TPU
// kernel and the plain `_rms_ref` do.
//
// Bound on the H100: bytes.  ~4 flops an element against 4 bytes moved a
// bf16 element (x read, out written), far below the card's ~295 flops per
// byte, so the floor is (N * D * (sizeof x + sizeof out) + D * sizeof w) /
// 3.35 TB/s.  Both kernels read x once and w once a block, keep the row's
// f32 sum out of device memory, and take the sum through warp shuffles,
// then (rows wider than a warp) one shared-memory step: two buffers, one
// barrier a row.  Each block walks rows over a grid of what the card holds
// at once (the occupancy API's count), or fewer where N needs fewer.  The
// host plan `_rms_launch` (incubate/kernels/rms_norm.py) picks the kernel
// and its shape.
//
// rms_tma_kernel, wide rows (D > 1024) with 16-byte rows of x and w: in a
// register-fed kernel every byte in flight holds a register (x, and the
// next row's x, a thread), which caps the rows in flight a block.  Here one
// thread feeds a ring of `stages` rows of x in shared memory with 1-d bulk
// copies (TMA), each completing on its stage's mbarrier, so a block keeps
// up to `stages` rows in flight at no register cost; w comes in once a
// block the same way.  Threads read their 16-byte pieces from the stage
// twice (sum, then output); the stage of the previous row is refilled once
// every thread has passed this row's barrier.
//
// rms_kernel, the rest (narrow rows; D not a multiple of the 16-byte piece
// or pointers not 16-byte aligned, pieces of 1 element; rows too wide for
// the ring): a thread owns the pieces j, j + TPR, ... of its row (at most NV
// of them, kept in registers between the sum and the write, and NV 0: the
// row read twice), loads its pieces of the block's next row before this
// row's sum, and holds w's pieces in registers for every row of its block.
// Narrow rows take one warp a row and several rows a block.
#include "attention_tile.cuh"
#include "hopper.cuh"

#include <stdint.h>

using namespace ptt;

namespace {

// What the entry refuses before any launch, as negative codes beside the
// runtime's cudaError_t values.
constexpr int kBadArgs = -1;     // N, D, threads, rows or stages
constexpr int kBadRing = -2;     // a ring launch the ring kernel cannot take
constexpr int kBadPiece = -3;    // a piece width that is neither 1 nor 16 B
constexpr int kBadDepth = -4;    // nv not 0, 1, 2, 4 or 8
constexpr int kBadThreads = -5;  // more threads than the launch bounds

// Threads a block may have when each holds E = NV * VEC elements of w, of
// x and of the next row's x in registers (the launch bounds; the host plan
// keeps to them).
__host__ __device__ constexpr int max_threads(int e) {
  return e <= 4 ? 1024 : e <= 16 ? 512 : 256;
}

// N consecutive elements as float: 16-byte pieces where N elements fill
// them, else 8-byte, else one element at a time.
template <typename T, int N>
__device__ __forceinline__ void ld(const T* __restrict__ src, float* dst) {
  constexpr int kB = N * (int)sizeof(T);
  if constexpr (kB % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kB / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) dst[c * E + i] = to_f(e[i]);
    }
  } else if constexpr (kB % 8 == 0) {
    constexpr int E = 8 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kB / 8; ++c) {
      const uint2 raw = reinterpret_cast<const uint2*>(src)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) dst[c * E + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f(src[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void st(T* __restrict__ dst, const float* src) {
  constexpr int kB = N * (int)sizeof(T);
  if constexpr (kB % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kB / 16; ++c) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) e[i] = from_f<T>(src[c * E + i]);
      reinterpret_cast<uint4*>(dst)[c] = raw;
    }
  } else if constexpr (kB % 8 == 0) {
    constexpr int E = 8 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kB / 8; ++c) {
      uint2 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) e[i] = from_f<T>(src[c * E + i]);
      reinterpret_cast<uint2*>(dst)[c] = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = from_f<T>(src[i]);
  }
}

// out = cast_x(x * r) * w for one piece, in TO.
template <typename TX, typename TO, int VEC>
__device__ __forceinline__ void write_piece(TO* __restrict__ dst,
                                            const float* xv, const float* wv,
                                            float r) {
  float o[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = round_to<TX>(xv[i] * r) * wv[i];
  st<TO, VEC>(dst, o);
}

// The row's sum of squares from each thread's part: warp shuffles, then
// (rows wider than a warp) one shared-memory step; buf alternates between
// the two halves of `part` from one row to the next, so one barrier a row
// keeps a fast warp from overwriting what a slow one still reads.
__device__ __forceinline__ float row_sum(float ss, int tpr, int ri,
                                         float (*part)[32], int buf) {
  ss = warp_sum(ss);
  if (tpr == 32) return ss;
  const int wpr = tpr >> 5, warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[buf][warp] = ss;
  __syncthreads();
  float sum = 0.f;
  for (int i = 0; i < wpr; ++i) sum += part[buf][ri * wpr + i];
  return sum;
}

// blockDim.x = tpr * R: thread j of row ri of the block.  Rows base + ri for
// base = blockIdx.x * R, + gridDim.x * R, ...: every thread runs the same
// iterations (the barrier in row_sum), a thread past N stores nothing.
template <typename TX, typename TW, typename TO, int VEC, int NV>
__global__ void __launch_bounds__(max_threads(NV * VEC), 1)
rms_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
           TO* __restrict__ out, int N, int D, int tpr, float eps) {
  __shared__ float part[2][32];
  const int R = blockDim.x / tpr;
  const int ri = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const int pieces = D / VEC;
  int buf = 0;
  if constexpr (NV > 0) {
    // this thread's pieces of row `row` into dst (0 past N or past D)
    auto load_row = [&](int row, float (*dst)[VEC]) {
      const TX* xr = x + (size_t)row * D;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int p = j + v * tpr;
        if (row < N && p < pieces) {
          ld<TX, VEC>(xr + (size_t)p * VEC, dst[v]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) dst[v][i] = 0.f;
        }
      }
    };
    float wr[NV][VEC], xv[NV][VEC], xn[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int p = j + v * tpr;
      if (p < pieces) ld<TW, VEC>(w + (size_t)p * VEC, wr[v]);
    }
    load_row(blockIdx.x * R + ri, xv);
    for (int base = blockIdx.x * R; base < N; base += gridDim.x * R) {
      const int row = base + ri;
      // the next row's loads go out before this row's reduction
      load_row(row + gridDim.x * R, xn);
      float ss = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = fmaf(xv[v][i], xv[v][i], ss);
      const float r = rsqrtf(row_sum(ss, tpr, ri, part, buf) / D + eps);
      buf ^= 1;
      if (row < N) {
        TO* orow = out + (size_t)row * D;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int p = j + v * tpr;
          if (p < pieces)
            write_piece<TX, TO, VEC>(orow + (size_t)p * VEC, xv[v], wr[v],
                                     r);
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[v][i] = xn[v][i];
    }
  } else {
    // a row too wide for the registers: sum, then read x (and w) again
    for (int base = blockIdx.x * R; base < N; base += gridDim.x * R) {
      const int row = base + ri;
      const bool live = row < N;
      const TX* xr = x + (size_t)row * D;
      float ss = 0.f;
      for (int p = j; live && p < pieces; p += tpr) {
        float xv[VEC];
        ld<TX, VEC>(xr + (size_t)p * VEC, xv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = fmaf(xv[i], xv[i], ss);
      }
      const float r = rsqrtf(row_sum(ss, tpr, ri, part, buf) / D + eps);
      buf ^= 1;
      if (!live) continue;
      TO* orow = out + (size_t)row * D;
      for (int p = j; p < pieces; p += tpr) {
        float xv[VEC], wv[VEC];
        ld<TX, VEC>(xr + (size_t)p * VEC, xv);
        ld<TW, VEC>(w + (size_t)p * VEC, wv);
        write_piece<TX, TO, VEC>(orow + (size_t)p * VEC, xv, wv, r);
      }
    }
  }
}

constexpr int kMaxStages = 8;

// Bytes of a shared-memory buffer of `bytes`, rounded up to 128.
__host__ __device__ constexpr uint32_t padded(uint32_t bytes) {
  return (bytes + 127u) & ~127u;
}

// One row a block of tpr = blockDim.x threads.  Shared memory: w
// (padded(D * sizeof(TW))), then `stages` rows of x (padded(D * sizeof(TX))
// each); bar[s] completes when stage s lands, bar[stages] when w does.
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(1024, 1)
rms_tma_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TO* __restrict__ out, int N, int D, int stages, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ uint64_t bar[kMaxStages + 1];
  __shared__ float part[2][32];
  const int tpr = blockDim.x, j = threadIdx.x, pieces = D / VEC;
  const uint32_t xbytes = D * sizeof(TX), wbytes = D * sizeof(TW);
  const TW* ws = reinterpret_cast<const TW*>(sm);
  unsigned char* ring = sm + padded(wbytes);
  auto stage = [&](int s) {
    return reinterpret_cast<TX*>(ring + (size_t)s * padded(xbytes));
  };
  auto fetch = [&](int s, int row) {       // row -> stage s, on bar[s]
    wg::mbar_expect_tx(&bar[s], xbytes);
    wg::bulk_load(stage(s), x + (size_t)row * D, xbytes, &bar[s]);
  };
  if (j == 0) {
    for (int s = 0; s <= stages; ++s) wg::mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (j == 0) {
    wg::mbar_expect_tx(&bar[stages], wbytes);
    wg::bulk_load(sm, w, wbytes, &bar[stages]);
    for (int s = 0; s < stages && blockIdx.x + s * gridDim.x < N; ++s)
      fetch(s, blockIdx.x + s * gridDim.x);
  }
  wg::mbar_wait(&bar[stages], 0);
  int buf = 0;
  for (int it = 0, row = blockIdx.x; row < N; ++it, row += gridDim.x) {
    const int s = it % stages;
    wg::mbar_wait(&bar[s], (it / stages) & 1);
    const TX* xs = stage(s);
    float ss = 0.f;
    for (int p = j; p < pieces; p += tpr) {
      float xv[VEC];
      ld<TX, VEC>(xs + (size_t)p * VEC, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(xv[i], xv[i], ss);
    }
    const float r = rsqrtf(row_sum(ss, tpr, 0, part, buf) / D + eps);
    buf ^= 1;
    // every thread is done with the previous row: its stage takes the row
    // `stages` rows further on
    const int next = row + (stages - 1) * gridDim.x;
    if (j == 0 && it > 0 && next < N) {
      wg::fence_proxy_async();
      fetch((it - 1) % stages, next);
    }
    TO* orow = out + (size_t)row * D;
    for (int p = j; p < pieces; p += tpr) {
      float xv[VEC], wv[VEC];
      ld<TX, VEC>(xs + (size_t)p * VEC, xv);
      ld<TW, VEC>(ws + (size_t)p * VEC, wv);
      write_piece<TX, TO, VEC>(orow + (size_t)p * VEC, xv, wv, r);
    }
  }
}

// Blocks of `kern` at `threads` threads a block and `smem` bytes of
// dynamic shared memory that the card holds at once (occupancy times SMs)
// into *blocks, asked once per kernel, block shape and device.
template <typename Kern>
cudaError_t resident_blocks(Kern kern, int threads, int smem, int* blocks) {
  struct Entry { int dev, threads, smem, blocks; };
  static Entry cache[16];
  static int used = 0;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  for (int i = 0; e == cudaSuccess && i < used; ++i)
    if (cache[i].dev == dev && cache[i].threads == threads &&
        cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (used < 16) cache[used++] = Entry{dev, threads, smem, *blocks};
  return cudaSuccess;
}

// The grid: what the card holds at once, or a block for every group of
// `rows` rows where that is fewer.
inline int grid_of(int N, int rows, int resident) {
  const int groups = (N + rows - 1) / rows;
  return resident < groups ? resident : groups;
}

template <typename TX, typename TW, typename TO, int VEC>
int run_vec(const void* x, const void* w, void* out, int N, int D, int nv,
            int tpr, int rows, float eps, cudaStream_t s) {
#define PTT_NV(NV_)                                                          \
  if (nv == NV_) {                                                           \
    if (tpr * rows > max_threads(NV_ * VEC))                                 \
      return kBadThreads;                                                    \
    auto kern = rms_kernel<TX, TW, TO, VEC, NV_>;                            \
    int resident = 0;                                                        \
    const cudaError_t e = resident_blocks(kern, tpr * rows, 0, &resident);   \
    if (e != cudaSuccess) return (int)e;                                     \
    const int grid = grid_of(N, rows, resident);                             \
    kern<<<grid, tpr * rows, 0, s>>>(                                        \
        static_cast<const TX*>(x), static_cast<const TW*>(w),                \
        static_cast<TO*>(out), N, D, tpr, eps);                              \
    return (int)cudaGetLastError();                                          \
  }
  PTT_NV(0)
  PTT_NV(1)
  PTT_NV(2)
  PTT_NV(4)
  PTT_NV(8)
#undef PTT_NV
  return kBadDepth;
}

// The ring kernel: one row a block, `stages` rows of x in flight.
template <typename TX, typename TW, typename TO>
int run_tma(const void* x, const void* w, void* out, int N, int D, int tpr,
            int stages, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(TX);
  if (D % V || (D * sizeof(TW)) % 16 || tpr < 64 || stages < 2 ||
      stages > kMaxStages)
    return kBadRing;
  auto kern = rms_tma_kernel<TX, TW, TO>;
  const int smem = (int)(padded(D * sizeof(TW)) +
                         (size_t)stages * padded(D * sizeof(TX)));
  // the dynamic shared memory allowed so far; the default 48 KB counts the
  // kernel's static shared memory too, so every size is asked for
  static int raised = 0;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  int resident = 0;
  const cudaError_t e = resident_blocks(kern, tpr, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid_of(N, 1, resident), tpr, smem, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), N, D, stages, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
int run(const void* x, const void* w, void* out, int N, int D, int vec,
        int nv, int tpr, int rows, int stages, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(TX);
  if (stages > 0)
    return vec == V && rows == 1
               ? run_tma<TX, TW, TO>(x, w, out, N, D, tpr, stages, eps, s)
               : kBadRing;
  if (vec == V && D % V == 0)
    return run_vec<TX, TW, TO, V>(x, w, out, N, D, nv, tpr, rows, eps, s);
  if (vec == 1)
    return run_vec<TX, TW, TO, 1>(x, w, out, N, D, nv, tpr, rows, eps, s);
  return kBadPiece;
}

}  // namespace

// x [N, D] and out [N, D] contiguous, w [D]; x_dtype / w_dtype: 0 float32,
// 1 bfloat16; out is bfloat16 when both are, float32 otherwise.  The launch
// comes from the caller's plan: stages > 0 takes the ring kernel (tpr
// threads, `stages` rows in flight), else the register kernel (vec elements
// a piece, nv pieces a thread held in registers or 0, tpr threads a row,
// rows a block); the grid is what the card holds at once, or fewer where N
// needs fewer.  Returns cudaGetLastError() after launch, or a negative code
// (kBad*) for a launch refused before it.
extern "C" int rms_norm(const void* x, const void* w, void* out, int N,
                        int D, int vec, int nv, int tpr, int rows,
                        int stages, float eps, int x_dtype, int w_dtype,
                        void* stream) {
  if (N < 1 || D < 1 || tpr < 32 || tpr % 32 || rows < 1 ||
      tpr * rows > 1024 || stages < 0)
    return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define PTT_PAIR(TX, TW, TO)                                                 \
  return run<TX, TW, TO>(x, w, out, N, D, vec, nv, tpr, rows, stages, eps, s);
  if (x_dtype == 0 && w_dtype == 0) PTT_PAIR(float, float, float)
  if (x_dtype == 1 && w_dtype == 1) PTT_PAIR(bf16, bf16, bf16)
  if (x_dtype == 1 && w_dtype == 0) PTT_PAIR(bf16, float, float)
  if (x_dtype == 0 && w_dtype == 1) PTT_PAIR(float, bf16, float)
#undef PTT_PAIR
  return kBadArgs;
}
