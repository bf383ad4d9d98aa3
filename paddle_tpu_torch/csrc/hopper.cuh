// Hopper primitives shared by the tensor-core attention bodies (the forward
// in attention_wgmma.cuh, the backward pair in attention_bwd_wgmma.cuh) and
// RMSNorm's wide-row kernel (rms_norm.cu): mbarriers, TMA tile loads
// through 4-d tensor maps, 1-d bulk loads, shared-memory matrix
// descriptors, and the two wgmma shapes both attention bodies use.
//
// Tiles.  A [64 x D] bf16 tile sits in shared memory as D/64 blocks of
// [64 rows x 128 bytes] (8 KB each, 1024-byte aligned), written by TMA with
// the 128-byte swizzle that wgmma reads.
//
// Operands of m64n64k16 (bf16 in, f32 accumulators in registers).
//   K-major (both operands of wgmma_ss): a tile whose rows are the M or N
//   axis and whose 128-byte rows hold the K axis.  Descriptor: LBO 16,
//   SBO 1024 bytes between 8-row groups; the address steps 32 bytes per
//   k16 inside a 128-byte row and 8 KB per 64 columns of K.
//   MN-major (B of wgmma_rs, through the transpose bit): a tile whose rows
//   are the K axis and whose 128-byte rows hold N.  Descriptor: LBO 8 KB,
//   SBO 1024 bytes between 8-row groups, 2 KB per k16 step, 8 KB per 64
//   columns of N (one instruction each).
//   Accumulator layout: thread t of the warpgroup holds rows 16*(t/32) +
//   (t%32)/4 and +8, columns 8*j + 2*(t%4) + {0, 1}: value 4*j + 2*h + e is
//   (row + 8*h, column 8*j + 2*(t%4) + e).  It is the register A layout of
//   the next product, so an accumulator becomes A fragments in place: A
//   register r of k16 step kk packs values 8*kk + 2*r and 8*kk + 2*r + 1.
#pragma once

#include <cuda.h>          // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {
namespace wg {

constexpr float kNegInf = -1e30f;
constexpr int kBlockBytes = 64 * 64 * 2;     // one [64 rows x 64 bf16] block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One [64 x 64] bf16 box of a 4-d tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 1-d bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's earlier shared-memory accesses before later copies
// of the async proxy (a bulk load into a buffer that threads just read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin register values in place around the asynchronous products, so the
// compiler neither reads an accumulator before the wait nor moves a write
// of one past the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define PTT_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define PTT_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A B, A [64 x 16] and B [16 x 64] from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PTT_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A [64 x 16] from registers, B [16 x 64] from shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef PTT_ACC32
#undef PTT_D32

// K-major descriptor of k16 step kk of a [64 x D] tile at addr.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return desc(addr + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major descriptor of k16 step kk (16 rows) and 64 columns n of a tile.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int n, int kk) {
  return desc(addr + n * kBlockBytes + kk * 2048, kBlockBytes, 1024);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An accumulator as the A fragments of the next product (bf16, in place).
__device__ __forceinline__ void to_frags(const float (&acc)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over a [B, L, H, HD] bf16 tensor: 64 x 1 x 64 x 1 boxes,
// 128-byte swizzle, zero fill out of bounds.
inline bool tensor_map(CUtensorMap* map, const void* base, int B, int L, int H,
                       int HD) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2,
                                 (cuuint64_t)L * H * HD * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace ptt
