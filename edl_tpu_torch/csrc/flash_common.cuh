// Shared pieces of the hand-written flash-attention kernels for Hopper
// (sm_90a): the mma.sync m16n8k16 tile helpers of the dQ kernel, and the
// small helpers (bf16 packing, quad reductions, the shared-memory limit)
// that the wgmma kernels (hopper_common.cuh) use too.
//
// Layout conventions of the dQ kernel:
//   * a block has 4 warps (128 threads) and owns one 64-row tile; each warp
//     owns 16 of those rows;
//   * a 64 x D bf16 tile sits in shared memory row-major with a row stride
//     of D + 8 elements, so the 32-bit fragment loads of one warp land in 32
//     distinct banks;
//   * products use mma.sync.m16n8k16 with bf16 operands and fp32
//     accumulators (lane = 4 * group + tid_in_group; an fp32 C fragment holds
//     rows group and group + 8, columns 2 * tid_in_group + {0, 1}).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kWarps = 4;           // 16 rows of the tile per warp
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;   // the Pallas kernels' mask value

// c += a (16x16, row-major) * b (16x8, col-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to bf16 and packed; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float unpack_bf16(uint32_t v, int hi) {
  uint16_t bits = hi ? (uint16_t)(v >> 16) : (uint16_t)(v & 0xffffu);
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) |
         ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// Copy rows [0, 64) of a row-major [*, D] bf16 matrix starting at `g` into
// the padded shared tile `sm`, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    *reinterpret_cast<uint4*>(sm + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * D + c);
  }
}

// A fragment: rows [row0, row0 + 16), columns [k0, k0 + 16) of the
// row-major shared matrix `sm` (row stride LD).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* sm,
                                       int row0, int k0, int lane) {
  const bf16* p = sm + (row0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment with B(k, n) = sm[n0 + n][k0 + k]: the product contracts the
// shared matrix's columns (Q Kᵀ, dO Vᵀ, ...).  Pairs are contiguous.
template <int LD>
__device__ __forceinline__ void load_b_t(uint32_t b[2], const bf16* sm,
                                         int n0, int k0, int lane) {
  const bf16* p = sm + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment with B(k, n) = sm[k0 + k][n0 + n]: the product contracts the
// shared matrix's rows (P V, dS K, ...).  Pairs straddle two rows.
template <int LD>
__device__ __forceinline__ void load_b_n(uint32_t b[2], const bf16* sm,
                                         int k0, int n0, int lane) {
  const bf16* p = sm + (k0 + (lane & 3) * 2) * LD + n0 + (lane >> 2);
  b[0] = pack2(p, p + LD);
  b[1] = pack2(p + 8 * LD, p + 9 * LD);
}

// The 16 x 64 fp32 C fragments of one warp (8 n-tiles) as the A operand of
// the next product, contracting over those 64 columns: chunk kk covers
// n-tiles 2kk and 2kk + 1.  Rounds to bf16 here — the Pallas kernels'
// `.astype(bf16)` before the second dot.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c[8][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Max / sum over the four lanes that share a row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a 16 x D fp32 accumulator (rows row0 + group, row0 + group + 8 of
// the row-major [*, D] bf16 matrix `g`), each row scaled by `mul`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, const float acc[D / 8][4],
                                           int row0, float mul0, float mul1,
                                           int lane) {
  bf16* p = g + (size_t)(row0 + (lane >> 2)) * D + (lane & 3) * 2;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(p + dn * 8) =
        pack_bf16(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<uint32_t*>(p + 8 * D + dn * 8) =
        pack_bf16(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

// Raise the dynamic shared-memory limit of `kernel` (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace edl
