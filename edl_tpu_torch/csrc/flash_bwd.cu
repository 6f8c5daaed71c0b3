// Flash-attention backward for Hopper (sm_90a), written by hand: the dQ
// kernel and the dK/dV kernel.
//
// Replace: edl_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (both launched by _flash_backward).  With
// p = exp(s·scale − lse) rebuilt from the forward's logsumexp and
// delta = rowsum(dO ∘ O) (computed outside the kernels, as in JAX):
//   dp = dO Vᵀ;  ds = p ∘ (dp − delta) · scale;  dQ = ds K;
//   dV = pᵀ dO;  dK = dsᵀ Q.
//
// Bound on an H100 SXM: tensor-core operations.  At FLAGSHIP (b 16, s 1024,
// h 8, hk 2, d 128, causal) the dQ kernel does three products over the
// visible score pairs (~52 µs of bf16 tensor work) and the dK/dV kernel four
// (~69 µs); each reads and writes well under 100 MB (~30 µs of memory).
//
// Design, simple first:
//   * dQ: one block per (q tile of 64 rows, folded q head), looping over the
//     k tiles up to the diagonal; dQ stays in registers.
//   * dK/dV: one block per (k tile of 64 keys, folded kv head), looping over
//     (group member, q tile) in that fixed order, exactly the Pallas inner
//     grid axis g · n_q_blocks + qi; the GQA group's sum is formed in
//     registers with no atomics, so it is the same on every run.  The block
//     computes the transposed tiles (keys as rows) so that dK and dV
//     accumulate as mma C fragments.
//   * bf16 rounding at the Pallas kernels' points: ds goes to k's dtype in
//     the dQ kernel (from the fp32 p); in the dK/dV kernel p goes to bf16
//     first, and ds is formed from that rounded p.
//   * 64-row tiles; four 64 x (d + 8) bf16 tiles in shared memory (68 KB at
//     d 128); plain loads, no cp.async / TMA / wgmma yet.
#include "flash_common.cuh"

namespace edl {

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int s, int h, int hk, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * LD;
  bf16* sk = sdo + kTile * LD;
  bf16* sv = sk + kTile * LD;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int kvh = (bh / h) * hk + (bh % h) / (h / hk);
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int row = qt * kTile + r0 + g;  // and row + 8
  const bf16* kg = k + (size_t)kvh * s * D;
  const bf16* vg = v + (size_t)kvh * s * D;
  const float lse_r[2] = {lse[(size_t)bh * s + row],
                          lse[(size_t)bh * s + row + 8]};
  const float delta_r[2] = {delta[(size_t)bh * s + row],
                            delta[(size_t)bh * s + row + 8]};

  load_tile<D>(sq, q + ((size_t)bh * s + qt * kTile) * D);
  load_tile<D>(sdo, dout + ((size_t)bh * s + qt * kTile) * D);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n_kt = CAUSAL ? qt + 1 : s / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sk, kg + (size_t)kt * kTile * D);
    load_tile<D>(sv, vg + (size_t)kt * kTile * D);
    __syncthreads();

    float sc[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, sq, r0, kk * 16, lane);
      load_a<LD>(ado, sdo, r0, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b[2];
        load_b_t<LD>(b, sk, nt * 8, kk * 16, lane);
        mma16816(sc[nt], aq, b);
        load_b_t<LD>(b, sv, nt * 8, kk * 16, lane);
        mma16816(dp[nt], ado, b);
      }
    }

    // ds = p ∘ (dp − delta) · scale, p from the saved lse (fp32)
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[nt][i] * scale;
        if (CAUSAL && kt * kTile + nt * 8 + t * 2 + (i & 1) > row + (i >> 1) * 8)
          x = kNegInf;
        const float p = expf(x - lse_r[i >> 1]);
        sc[nt][i] = p * (dp[nt][i] - delta_r[i >> 1]) * scale;
      }

    // dQ += bf16(ds) · K
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, sc, kk);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b[2];
        load_b_n<LD>(b, sk, kk * 16, dn * 8, lane);
        mma16816(acc[dn], a, b);
      }
    }
  }
  store_rows<D>(dq + (size_t)bh * s * D, acc, qt * kTile + r0, 1.f, 1.f,
                lane);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int s, int h, int hk,
                     float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * LD;
  bf16* sq = sv + kTile * LD;
  bf16* sdo = sq + kTile * LD;
  float* slse = reinterpret_cast<float*>(sdo + kTile * LD);
  float* sdelta = slse + kTile;

  const int kt = blockIdx.x, bkh = blockIdx.y;
  const int rep = h / hk;
  // first folded q head of this kv head's group (qrow at member 0)
  const int qhead0 = (bkh / hk) * h + (bkh % hk) * rep;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int key = kt * kTile + r0 + g;  // and key + 8

  load_tile<D>(sk, k + ((size_t)bkh * s + kt * kTile) * D);
  load_tile<D>(sv, v + ((size_t)bkh * s + kt * kTile) * D);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dn][i] = dv_acc[dn][i] = 0.f;

  const int n_qt = s / kTile;
  for (int member = 0; member < rep; ++member) {
    const size_t qbase = (size_t)(qhead0 + member) * s;
    for (int qt = CAUSAL ? kt : 0; qt < n_qt; ++qt) {
      __syncthreads();
      load_tile<D>(sq, q + (qbase + qt * kTile) * D);
      load_tile<D>(sdo, dout + (qbase + qt * kTile) * D);
      if (threadIdx.x < kTile) {
        slse[threadIdx.x] = lse[qbase + qt * kTile + threadIdx.x];
        sdelta[threadIdx.x] = delta[qbase + qt * kTile + threadIdx.x];
      }
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: rows are this warp's 16 keys, columns
      // the tile's 64 queries
      float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<LD>(ak, sk, r0, kk * 16, lane);
        load_a<LD>(av, sv, r0, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          uint32_t b[2];
          load_b_t<LD>(b, sq, nt * 8, kk * 16, lane);
          mma16816(st[nt], ak, b);
          load_b_t<LD>(b, sdo, nt * 8, kk * 16, lane);
          mma16816(dpt[nt], av, b);
        }
      }

      // pᵀ = bf16(exp(s·scale − lse)); dsᵀ = pᵀ ∘ (dpᵀ − delta) · scale
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + t * 2 + (i & 1);  // query within tile
          float x = st[nt][i] * scale;
          if (CAUSAL && key + (i >> 1) * 8 > qt * kTile + col) x = kNegInf;
          const float p = __bfloat162float(__float2bfloat16_rn(
              expf(x - slse[col])));
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - sdelta[col]) * scale;
        }

      // dV += pᵀ dO;  dK += bf16(dsᵀ) Q
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, st, kk);
        c_to_a(ads, dpt, kk);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t b[2];
          load_b_n<LD>(b, sdo, kk * 16, dn * 8, lane);
          mma16816(dv_acc[dn], ap, b);
          load_b_n<LD>(b, sq, kk * 16, dn * 8, lane);
          mma16816(dk_acc[dn], ads, b);
        }
      }
    }
  }
  store_rows<D>(dk + (size_t)bkh * s * D, dk_acc, kt * kTile + r0, 1.f, 1.f,
                lane);
  store_rows<D>(dv + (size_t)bkh * s * D, dv_acc, kt * kTile + r0, 1.f, 1.f,
                lane);
}

template <int D, bool CAUSAL>
static cudaError_t launch_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int s,
                             int h, int hk, float scale, cudaStream_t stream) {
  const size_t smem = 4 * kTile * (D + 8) * sizeof(bf16);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, CAUSAL>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, CAUSAL>
      <<<dim3(s / kTile, bh), kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dq), s, h, hk, scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
static cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bkh,
                              int s, int h, int hk, float scale,
                              cudaStream_t stream) {
  const size_t smem =
      4 * kTile * (D + 8) * sizeof(bf16) + 2 * kTile * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, CAUSAL>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, CAUSAL>
      <<<dim3(s / kTile, bkh), kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, h, hk, scale);
  return cudaGetLastError();
}

}  // namespace edl

// q, dout [bh, s, d]; k, v [bh / h * hk, s, d] bf16; lse, delta [bh, s]
// fp32 -> dq [bh, s, d] bf16.  Same preconditions as edl_flash_fwd.
extern "C" int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int s,
                                int d, int h, int hk, int causal, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return causal ? edl::launch_dq<64, true>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st)
                  : edl::launch_dq<64, false>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st);
  if (d == 128)
    return causal ? edl::launch_dq<128, true>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st)
                  : edl::launch_dq<128, false>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Same inputs -> dk, dv [bh / h * hk, s, d] bf16, each summed over the
// h / hk query heads of its GQA group.
extern "C" int edl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int s, int d, int h, int hk,
                                 int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bkh = bh / h * hk;
  if (d == 64)
    return causal ? edl::launch_dkv<64, true>(q, k, v, dout, lse, delta, dk, dv, bkh, s, h, hk, scale, st)
                  : edl::launch_dkv<64, false>(q, k, v, dout, lse, delta, dk, dv, bkh, s, h, hk, scale, st);
  if (d == 128)
    return causal ? edl::launch_dkv<128, true>(q, k, v, dout, lse, delta, dk, dv, bkh, s, h, hk, scale, st)
                  : edl::launch_dkv<128, false>(q, k, v, dout, lse, delta, dk, dv, bkh, s, h, hk, scale, st);
  return (int)cudaErrorInvalidValue;
}
