// Hopper (sm_90a) building blocks of the flash kernels and of the GroupNorm
// kernels: mbarriers, TMA and bulk loads, cluster barriers and distributed
// shared memory, warpgroup matrix multiplies (wgmma) and their
// shared-memory descriptors, the host-side TMA tensor maps, and small
// helpers (bf16 packing, quad reductions, the shared-memory limit).
//
// Shared-memory tiles: a bf16 tile of R rows and 64 columns (128 bytes a
// row) is one TMA box loaded with CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk
// j of row r lands at chunk j ^ (r % 8).  A tile of width 128 is two such
// boxes ("regions"), columns [0, 64) then [64, 128), each R x 128 bytes.
// Every region starts on a 1024-byte boundary, the period of the swizzle.
//
// wgmma operands in such tiles (descriptor layout type B128):
//   * K-major (the contracted dimension runs along the 128-byte row, as K
//     of Q·Kᵀ): stride between 8-row groups (SBO) 1024 bytes; the 16-wide
//     K step k inside a region is +32·k bytes on the start address;
//   * MN-major (the contracted dimension runs down the rows, as the keys of
//     P·V): SBO 1024 bytes between 8-row groups of K, LBO the byte stride
//     from one 64-column region to the next; the 16-row K step is +2048
//     bytes.  Read with the transpose bit of B set.
// Accumulator fragment of m64nNk16, thread t of the warpgroup (warp w =
// t / 32, g = (t % 32) / 4, c = t % 4): element 4j + e sits at row
// 16w + g + 8·(e / 2), column 8j + 2c + e % 2 — the C fragment of the warp
// level m16n8k16 product repeated over N / 8 column blocks.  A from
// registers takes that product's A fragment layout, so an accumulator
// rounded to bf16 feeds the next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value

// Two fp32 values rounded to bf16 and packed; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max / sum over the four lanes that share a row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Raise the dynamic shared-memory limit of `kernel` (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive once and add `bytes` to the transfer count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Tries before a wait gives up.  No legitimate wait of these kernels lasts
// more than a kernel's run (under a millisecond); a wait that never ends
// (a broken ring) then finishes the kernel with wrong numbers instead of
// hanging the card.
constexpr uint32_t kSpinLimit = 1u << 20;

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t i = 0; i < kSpinLimit; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// -- TMA ---------------------------------------------------------------------

// One box of `map` at (column col, row row) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into `dst`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into L2,
// without waiting and without a destination in shared memory.
__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// -- thread block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every block of the cluster arrives, then waits: the
// writes to shared memory before the arrival (release) are visible to the
// reads after the wait (acquire), in this block and its peers.  All threads
// of a warp execute it together.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The two floats (8-byte aligned) at the same shared-memory offset as `p`, in
// the block of cluster rank `rank` (distributed shared memory).
__device__ __forceinline__ float2 ld_cluster2(const float* p, uint32_t rank) {
  uint32_t remote;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote));
  return v;
}

// -- wgmma -------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand starting at `p`.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// Descriptor offsets are in 16-byte units.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (issue, then wait).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// -- warp specialisation -----------------------------------------------------

// Registers move from the producer warpgroup to the consumer warpgroups.
// A block is launched at the register count ptxas gives 3 warpgroups (168
// a thread); the producer drops to kProducerRegs and each consumer rises
// to kConsumerRegs: 128 · 40 + 256 · 232 = 384 · 168.  The two roles must
// branch once and never meet again, or ptxas ignores the instructions.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

#define EDL_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define EDL_ACC32(d) EDL_ACC8(d, 0), EDL_ACC8(d, 8), EDL_ACC8(d, 16), EDL_ACC8(d, 24)
#define EDL_ACC64(d) \
  EDL_ACC32(d), EDL_ACC8(d, 32), EDL_ACC8(d, 40), EDL_ACC8(d, 48), EDL_ACC8(d, 56)
#define EDL_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define EDL_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x N] (+)= A[64 x 16] · B[16 x N], A and B K-major in shared memory;
// `accumulate` 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : EDL_ACC32(d)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " EDL_REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : EDL_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d[64 x N] += A[64 x 16] · B[16 x N], A from registers (the m16n8k16 A
// fragment layout, bf16 pairs), B MN-major in shared memory (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : EDL_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " EDL_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : EDL_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef EDL_ACC8
#undef EDL_ACC32
#undef EDL_ACC64
#undef EDL_REGS32
#undef EDL_REGS64

// Columns [16k, 16k + 16) of an accumulator as the A operand of the next
// product, rounded to bf16 (the Pallas kernels' cast before the second dot).
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[R],
                                         int k) {
  a[0] = pack_bf16(c[8 * k + 0], c[8 * k + 1]);
  a[1] = pack_bf16(c[8 * k + 2], c[8 * k + 3]);
  a[2] = pack_bf16(c[8 * k + 4], c[8 * k + 5]);
  a[3] = pack_bf16(c[8 * k + 6], c[8 * k + 7]);
}

// -- host: TMA tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Map of the row-major bf16 matrix [rows, d] at `base`, in boxes of
// `box_rows` rows x 64 columns, 128-byte swizzled.
inline cudaError_t tile_map(CUtensorMap* map, const void* base, uint64_t rows,
                            int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace edl
