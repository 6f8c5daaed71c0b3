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
// dQ kernel, simple first: one block of 4 warps per (q tile of 64 rows,
// folded q head), looping over the k tiles up to the diagonal with
// mma.sync m16n8k16 and plain loads (flash_common.cuh); dQ stays in
// registers; ds goes to k's dtype from the fp32 p, as Pallas rounds.
//
// dK/dV kernel, Hopper's producer / consumer shape:
//   * one block per (k tile of 128 keys, folded kv head): two consumer
//     warpgroups of 64 keys each and a producer warpgroup whose registers
//     setmaxnreg hands to the consumers (the 64 x d fp32 dK and dV
//     accumulators alone take 128 registers a thread at d 128), 384
//     threads; the grid runs the heaviest key tiles (the first, when
//     causal) first;
//   * K and V stay resident in shared memory; a producer thread streams
//     Q, dO (TMA boxes of 64 queries) and lse, delta (bulk copies) through a
//     3-stage ring with full / empty mbarriers;
//   * the block walks (group member, q tile) in that fixed order, exactly
//     the Pallas inner grid axis g · n_q_blocks + qi, starting at the first
//     q tile that holds its first key when causal; the GQA group's sum is
//     formed in registers with no atomics, so two runs give the same bits;
//   * transposed tiles (keys as rows): Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are wgmma
//     from shared memory (both K-major), then dV += pᵀ dO and dK += dsᵀ Q
//     take pᵀ and dsᵀ from registers and dO, Q MN-major (transpose bit), so
//     dK and dV accumulate as wgmma accumulators;
//   * the four products run as three commit groups, so that pᵀ is formed
//     while dPᵀ is still in the tensor cores and dsᵀ while dV's product is;
//   * p goes to bf16 first and ds is formed from that rounded p, as the
//     Pallas kernel does;
//   * the GQA group is not split over blocks: at FLAGSHIP shapes the 256
//     blocks (the first walks 4 x 16 steps, the last 4 x 2) take 0.62 of
//     the non-causal time on an H100 (chip_smoke.py phase (b)), against
//     0.56 of the work, so fp32 partials summed by a second pass could win
//     at most about a tenth;
//   * no __syncthreads() after set-up: the roles meet only at mbarriers.
#include "flash_common.cuh"
#include "hopper_common.cuh"

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

namespace dkv {

using namespace hopper;

constexpr int kBK = 128;                   // keys of a block
constexpr int kBQ = 64;                    // queries of a streamed tile
constexpr int kConsumers = 256;            // two warpgroups, 64 keys each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kStages = 3;
constexpr int kKRegion = kBK * 128;        // bytes of a 64-column box
constexpr int kQRegion = kBQ * 128;

template <int D>
struct Layout {
  static constexpr int kRegions = D / 64;
  static constexpr int kKVTile = kBK * D * 2;  // K or V
  static constexpr int kQTile = kBQ * D * 2;   // Q or dO
  static constexpr int kRowBytes = kBQ * 4;    // lse or delta of a q tile
  // a stage: Q, dO, lse, delta (padded to keep the tiles 1 KB aligned)
  static constexpr int kStage = 2 * kQTile + 1024;
  static constexpr int kBarOffset = 2 * kKVTile + kStages * kStage;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int bkh_count, int s, int h,
                     int hk, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sv = sk + L::kKVTile;
  unsigned char* stages = sv + L::kKVTile;  // stage st: Q, dO, lse, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sk + L::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // heaviest key tile first: when causal, tile 0 sees every query
  const int kt = blockIdx.x / bkh_count, bkh = blockIdx.x % bkh_count;
  const int rep = h / hk;
  // first folded q head of this kv head's group (qrow at member 0)
  const int qhead0 = (bkh / hk) * h + (bkh % hk) * rep;
  // the first q tile holding a query that sees this block's first key
  const int qt0 = CAUSAL ? kt * kBK / kBQ : 0;
  const int per_member = s / kBQ - qt0;
  // (group member, q tile) in the Pallas inner order g · n_q_blocks + qi
  const int n_steps = rep * per_member;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    // producer: one thread of the last warpgroup loads K and V once, then
    // Q, dO, lse and delta for each step
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * L::kKVTile);
      for (int r = 0; r < L::kRegions; ++r) {
        tma_load_2d(sk + r * kKRegion, &tk, kv_full, 64 * r,
                    bkh * s + kt * kBK);
        tma_load_2d(sv + r * kKRegion, &tv, kv_full, 64 * r,
                    bkh * s + kt * kBK);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % kStages;
        const uint32_t round = i / kStages;
        const int qrow =
            (qhead0 + i / per_member) * s + (qt0 + i % per_member) * kBQ;
        unsigned char* dst = stages + st * L::kStage;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kQTile + 2 * L::kRowBytes);
        for (int r = 0; r < L::kRegions; ++r) {
          tma_load_2d(dst + r * kQRegion, &tq, &full[st], 64 * r, qrow);
          tma_load_2d(dst + L::kQTile + r * kQRegion, &tdo, &full[st], 64 * r,
                      qrow);
        }
        float* srow = reinterpret_cast<float*>(dst + 2 * L::kQTile);
        bulk_load(srow, lse + qrow, L::kRowBytes, &full[st]);
        bulk_load(srow + kBQ, delta + qrow, L::kRowBytes, &full[st]);
      }
    }
  } else {
    consumer_regs();
    // consumer warpgroup wg: keys [64 wg, 64 wg + 64) of the block, as
    // rows of the transposed tiles Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, so that dK and
    // dV accumulate as wgmma accumulators
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, c = lane % 4;
    const int key = kt * kBK + wg * 64 + (t / 32) * 16 + lane / 4;  // and +8
    const uint64_t dk0 = desc_sw128(sk + wg * 64 * 128, 16, 1024);
    const uint64_t dv0 = desc_sw128(sv + wg * 64 * 128, 16, 1024);

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % kStages;
      const uint32_t round = i / kStages;
      const int q0 = (qt0 + i % per_member) * kBQ;  // first query of the tile
      unsigned char* sq = stages + st * L::kStage;
      unsigned char* sdo = sq + L::kQTile;
      const float* slse = reinterpret_cast<const float*>(sq + 2 * L::kQTile);
      const float* sdelta = slse + kBQ;
      mbar_wait(&full[st], round & 1);

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 64 keys x 64 queries, over d; two
      // commit groups, so that pᵀ is formed while dPᵀ is still running
      float sct[kBQ / 2], dpt[kBQ / 2];
      const uint64_t dq_k = desc_sw128(sq, 16, 1024);
      const uint64_t ddo_k = desc_sw128(sdo, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBQ>(sct, desc_add(dk0, (kk / 4) * kKRegion + (kk % 4) * 32),
                      desc_add(dq_k, (kk / 4) * kQRegion + (kk % 4) * 32),
                      kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBQ>(dpt, desc_add(dv0, (kk / 4) * kKRegion + (kk % 4) * 32),
                      desc_add(ddo_k, (kk / 4) * kQRegion + (kk % 4) * 32),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sct);

      // pᵀ = bf16(exp(s·scale − lse)), then dV += pᵀ dO (A from
      // registers, dO MN-major) while dPᵀ finishes
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + (e & 1);  // query within the tile
          float x = sct[4 * j + e] * scale;
          if (CAUSAL && key + 8 * (e >> 1) > q0 + col) x = kNegInf;
          sct[4 * j + e] = __bfloat162float(
              __float2bfloat16_rn(exp2f((x - slse[col]) * kLog2e)));
        }
      uint32_t ap[kBQ / 16][4], ads[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) acc_to_a(ap[kk], sct, kk);
      const uint64_t ddo_mn = desc_sw128(sdo, kQRegion, 1024);
      const uint64_t dq_mn = desc_sw128(sq, kQRegion, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<D>(dv_acc, ap[kk], desc_add(ddo_mn, kk * 2048));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dpt);

      // dsᵀ = pᵀ ∘ (dpᵀ − delta) · scale from the rounded p, then
      // dK += bf16(dsᵀ) Q
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + (e & 1);
          dpt[4 * j + e] =
              sct[4 * j + e] * (dpt[4 * j + e] - sdelta[col]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) acc_to_a(ads[kk], dpt, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<D>(dk_acc, ads[kk], desc_add(dq_mn, kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
      // the register operands stay live until their products are done
      fence_regs(ap);
      fence_regs(ads);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      mbar_arrive(&empty[st]);
    }

    const size_t grow = (size_t)bkh * s + key;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = grow * D + 8 * j + 2 * c;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[4 * j], dk_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dk + at + 8 * D) =
          pack_bf16(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * D) =
          pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

template <int D, bool CAUSAL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int bh,
                          int s, int h, int hk, float scale,
                          cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const int bkh = bh / h * hk;
  cudaError_t err = tile_map(&tq, q, (uint64_t)bh * s, D, kBQ);
  if (err == cudaSuccess) err = tile_map(&tdo, dout, (uint64_t)bh * s, D, kBQ);
  if (err == cudaSuccess) err = tile_map(&tk, k, (uint64_t)bkh * s, D, kBK);
  if (err == cudaSuccess) err = tile_map(&tv, v, (uint64_t)bkh * s, D, kBK);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkv_kernel<D, CAUSAL>, Layout<D>::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, CAUSAL>
      <<<bkh * (s / kBK), kThreads, Layout<D>::kSmem, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), bkh, s, h, hk, scale);
  return cudaGetLastError();
}

}  // namespace dkv

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
// h / hk query heads of its GQA group.  Needs s % 128 == 0.
extern "C" int edl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int s, int d, int h, int hk,
                                 int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return causal ? edl::dkv::launch<64, true>(q, k, v, dout, lse, delta, dk, dv, bh, s, h, hk, scale, st)
                  : edl::dkv::launch<64, false>(q, k, v, dout, lse, delta, dk, dv, bh, s, h, hk, scale, st);
  if (d == 128)
    return causal ? edl::dkv::launch<128, true>(q, k, v, dout, lse, delta, dk, dv, bh, s, h, hk, scale, st)
                  : edl::dkv::launch<128, false>(q, k, v, dout, lse, delta, dk, dv, bh, s, h, hk, scale, st);
  return (int)cudaErrorInvalidValue;
}
