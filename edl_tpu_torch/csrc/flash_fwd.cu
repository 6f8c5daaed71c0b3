// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: edl_tpu/ops/flash_attention.py::_flash_kernel (launched by
// _flash_forward) — causal or non-causal online-softmax attention over
// heads folded into the batch, GQA read through the kv-head index map,
// writing the output and the per-row logsumexp the backward needs.
//
// Bound on an H100 SXM: tensor-core operations.  Two products over the
// visible (b·h, s, s) score pairs at d 128 against ~84 MB of q/k/v/out/lse
// traffic: ~35 µs of bf16 tensor work versus ~25 µs of memory at FLAGSHIP
// (b 16, s 1024, h 8, hk 2, causal).
//
// Design, simple first:
//   * one block per (q tile of 64 rows, folded head); 4 warps, 16 rows each;
//   * the block loops over k tiles itself (a TPU grid carried the running
//     max / sum / accumulator across its sequential k axis in VMEM; Hopper's
//     blocks run in no order, so the loop moves inside the block) and stops
//     at the diagonal when causal;
//   * the score tile and the output accumulator stay in registers as
//     mma.sync fragments; P is rounded to bf16 before P·V, as the Pallas
//     kernel casts p to v's dtype; the row sum uses the fp32 p;
//   * 64-row tiles (the TPU's 512 x 1024 blocks would need ~384 KB of
//     shared memory; a block here holds three 64 x (d + 8) bf16 tiles, 52 KB
//     at d 128);
//   * plain 16-byte loads and no cp.async / TMA / wgmma yet: speed is later
//     work.
#include "flash_common.cuh"

namespace edl {

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int s, int h, int hk, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kTile * LD;
  bf16* sv = sk + kTile * LD;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int kvh = (bh / h) * hk + (bh % h) / (h / hk);  // _kv_head_map
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int row = qt * kTile + r0 + g;  // and row + 8
  const bf16* kg = k + (size_t)kvh * s * D;
  const bf16* vg = v + (size_t)kvh * s * D;

  load_tile<D>(sq, q + ((size_t)bh * s + qt * kTile) * D);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_kt = CAUSAL ? qt + 1 : s / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D>(sk, kg + (size_t)kt * kTile * D);
    load_tile<D>(sv, vg + (size_t)kt * kTile * D);
    __syncthreads();

    float sc[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, sq, r0, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b[2];
        load_b_t<LD>(b, sk, nt * 8, kk * 16, lane);
        mma16816(sc[nt], a, b);
      }
    }

    // scale, mask (_block_scores), and the online-softmax update
    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[nt][i] * scale;
        if (CAUSAL && kt * kTile + nt * 8 + t * 2 + (i & 1) > row + (i >> 1) * 8)
          x = kNegInf;
        sc[nt][i] = x;
        mcur[i >> 1] = fmaxf(mcur[i >> 1], x);
      }
    float mnew[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mnew[r] = fmaxf(m[r], quad_max(mcur[r]));
      alpha[r] = expf(m[r] - mnew[r]);
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(sc[nt][i] - mnew[i >> 1]);
        sc[nt][i] = p;
        rsum[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = alpha[r] * l[r] + quad_sum(rsum[r]);
      m[r] = mnew[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // acc += bf16(p) · V
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, sc, kk);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b[2];
        load_b_n<LD>(b, sv, kk * 16, dn * 8, lane);
        mma16816(acc[dn], a, b);
      }
    }
  }

  store_rows<D>(o + (size_t)bh * s * D, acc, qt * kTile + r0, 1.f / l[0],
                1.f / l[1], lane);
  if (t == 0) {
    lse[(size_t)bh * s + row] = m[0] + logf(l[0]);
    lse[(size_t)bh * s + row + 8] = m[1] + logf(l[1]);
  }
}

template <int D, bool CAUSAL>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int s, int h,
                              int hk, float scale, cudaStream_t stream) {
  const size_t smem = 3 * kTile * (D + 8) * sizeof(bf16);
  cudaError_t err = allow_smem(flash_fwd_kernel<D, CAUSAL>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D, CAUSAL><<<dim3(s / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, h, hk, scale);
  return cudaGetLastError();
}

}  // namespace edl

// q [bh, s, d], k/v [bh / h * hk, s, d] bf16 -> o [bh, s, d] bf16,
// lse [bh, s] fp32.  The caller guarantees s % 64 == 0, d in {64, 128},
// h % hk == 0 and contiguous 16-byte-aligned buffers.  Returns a cudaError_t.
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int s, int d, int h,
                             int hk, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return causal ? edl::launch_fwd<64, true>(q, k, v, o, lse, bh, s, h, hk, scale, st)
                  : edl::launch_fwd<64, false>(q, k, v, o, lse, bh, s, h, hk, scale, st);
  if (d == 128)
    return causal ? edl::launch_fwd<128, true>(q, k, v, o, lse, bh, s, h, hk, scale, st)
                  : edl::launch_fwd<128, false>(q, k, v, o, lse, bh, s, h, hk, scale, st);
  return (int)cudaErrorInvalidValue;
}
