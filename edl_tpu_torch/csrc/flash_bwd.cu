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
// Both kernels take Hopper's producer / consumer shape: two consumer
// warpgroups and a producer warpgroup whose registers setmaxnreg hands to
// the consumers, 384 threads; one producer thread issues every TMA load;
// a ring of shared-memory stages with a full and an empty mbarrier each;
// products are wgmma on 128-byte-swizzled tiles (hopper_common.cuh); no
// __syncthreads() after set-up: the roles meet only at mbarriers.
//
// dQ kernel:
//   * one block per (q tile of 128 rows, folded q head), each consumer
//     warpgroup owning 64 of the rows; when causal the grid runs the
//     heaviest q tiles (the last) first;
//   * Q and dO are loaded once (TMA) and stay resident; each consumer
//     thread reads its two rows' lse and delta once, into registers;
//   * K and V tiles of 64 keys stream through a 4-stage ring (32 KB a stage
//     at d 128: 193 KB of shared memory with Q and dO); when causal, tiles
//     past the diagonal are never loaded and only the two tiles that cross
//     it are masked;
//   * S = Q Kᵀ and dP = dO Vᵀ are wgmma from shared memory (K and V are
//     K-major as they stand), two commit groups, so that p is formed while
//     dP is still in the tensor cores; ds = p ∘ (dp − delta) · scale goes
//     to bf16 from the fp32 p, as the Pallas kernel rounds, and dQ += ds K
//     takes ds from registers and K MN-major (transpose bit);
//   * the 64 x d fp32 dQ accumulator stays in registers over the whole key
//     loop (S 32, dP 32, dQ 64 and ds 16 registers a thread at d 128, under
//     the consumers' 232) and is written once as bf16; each row is summed by
//     one warpgroup in key order, with no atomics, so two runs give the
//     same bits.
//
// dK/dV kernel:
//   * one block per (k tile of 128 keys, folded kv head), two consumer
//     warpgroups of 64 keys each (the 64 x d fp32 dK and dV accumulators
//     alone take 128 registers a thread at d 128); the grid runs the
//     heaviest key tiles (the first, when causal) first;
//   * K and V stay resident in shared memory; the producer thread streams
//     Q, dO (TMA boxes of 64 queries) and lse, delta (bulk copies) through a
//     3-stage ring;
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
//     at most about a tenth.
#include "hopper_common.cuh"

namespace edl {

namespace dq {

using namespace hopper;

constexpr int kBQ = 128;                   // q rows of a block
constexpr int kBK = 64;                    // keys of a K/V tile
constexpr int kConsumers = 256;            // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kStages = 4;
constexpr int kQRegion = kBQ * 128;        // bytes of a 64-column box of Q
constexpr int kKRegion = kBK * 128;        // ... and of K

template <int D>
struct Layout {
  static constexpr int kRegions = D / 64;
  static constexpr int kQTile = kBQ * D * 2;   // Q or dO
  static constexpr int kKVTile = kBK * D * 2;  // K or V
  // Q, dO, then per stage K and V, then the barriers; 1 KB for alignment
  static constexpr int kBarOffset = 2 * kQTile + 2 * kStages * kKVTile;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int bh_count, int s, int h, int hk, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sdo = sq + L::kQTile;
  unsigned char* skv = sdo + L::kQTile;  // stage st: K, then V
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sq + L::kBarOffset);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = s / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int qt = CAUSAL ? n_qt - 1 - (int)blockIdx.x / bh_count
                        : (int)blockIdx.x / bh_count;
  const int kvh = (bh / h) * hk + (bh % h) / (h / hk);  // _kv_head_map
  // when causal, the last key of the block's last row ends the loop
  const int n_kt = CAUSAL ? (qt + 1) * (kBQ / kBK) : s / kBK;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    // producer: one thread of the last warpgroup loads Q and dO once, then
    // K and V for each key tile
    if (threadIdx.x == kConsumers) {
      const int qrow = bh * s + qt * kBQ;
      mbar_expect_tx(qdo_full, 2 * L::kQTile);
      for (int r = 0; r < L::kRegions; ++r) {
        tma_load_2d(sq + r * kQRegion, &tq, qdo_full, 64 * r, qrow);
        tma_load_2d(sdo + r * kQRegion, &tdo, qdo_full, 64 * r, qrow);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % kStages;
        const uint32_t round = i / kStages;
        unsigned char* dst = skv + 2 * st * L::kKVTile;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kKVTile);
        for (int r = 0; r < L::kRegions; ++r) {
          tma_load_2d(dst + r * kKRegion, &tk, &full[st], 64 * r,
                      kvh * s + i * kBK);
          tma_load_2d(dst + L::kKVTile + r * kKRegion, &tv, &full[st],
                      64 * r, kvh * s + i * kBK);
        }
      }
    }
  } else {
    consumer_regs();
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the q tile
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, c = lane % 4;
    const int row = qt * kBQ + wg * 64 + (t / 32) * 16 + lane / 4;  // and +8
    const size_t grow = (size_t)bh * s + row;
    // p = exp2(s·scale·log2(e) − lse·log2(e))
    const float scale_log2 = scale * kLog2e;
    const float lse_log2[2] = {lse[grow] * kLog2e, lse[grow + 8] * kLog2e};
    const float delta_r[2] = {delta[grow], delta[grow + 8]};
    const uint64_t dq0 = desc_sw128(sq + wg * 64 * 128, 16, 1024);
    const uint64_t ddo0 = desc_sw128(sdo + wg * 64 * 128, 16, 1024);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kStages;
      const uint32_t round = i / kStages;
      const int key0 = i * kBK;  // first key of the tile
      unsigned char* sk = skv + 2 * st * L::kKVTile;
      const uint64_t dk0 = desc_sw128(sk, 16, 1024);
      const uint64_t dv0 = desc_sw128(sk + L::kKVTile, 16, 1024);
      mbar_wait(&full[st], round & 1);

      // S = Q Kᵀ and dP = dO Vᵀ: 64 rows x 64 keys, over d in 16-wide
      // steps; two commit groups, so that p is formed while dP still runs
      float sc[kBK / 2], dp[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * kQRegion + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kKRegion + (kk % 4) * 32;
        wgmma_ss<kBK>(sc, desc_add(dq0, qoff), desc_add(dk0, koff), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * kQRegion + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kKRegion + (kk % 4) * 32;
        wgmma_ss<kBK>(dp, desc_add(ddo0, qoff), desc_add(dv0, koff), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // p = exp(s·scale − lse) in fp32; only the tiles that cross the
      // diagonal are masked (_block_scores)
      const bool diag = CAUSAL && key0 + kBK > qt * kBQ;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (diag && key0 + 8 * j + 2 * c + (e & 1) > row + 8 * (e >> 1))
            x = kNegInf;
          sc[4 * j + e] = exp2f(x - lse_log2[e >> 1]);
        }
      wgmma_wait<0>();
      fence_regs(dp);

      // ds = p ∘ (dp − delta) · scale from the fp32 p, then
      // dQ += bf16(ds) K, K read MN-major
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              sc[4 * j + e] * (dp[4 * j + e] - delta_r[e >> 1]) * scale;
      uint32_t ads[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(ads[kk], dp, kk);
      const uint64_t dk_mn = desc_sw128(sk, kKRegion, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<D>(acc, ads[kk], desc_add(dk_mn, kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
      // the register operands stay live until their product is done
      fence_regs(ads);
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }

    bf16* out = dq + grow * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(out + 8 * D + 8 * j) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int D, bool CAUSAL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int s, int h,
                          int hk, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t kv_rows = (uint64_t)(bh / h * hk) * s;
  cudaError_t err = tile_map(&tq, q, (uint64_t)bh * s, D, kBQ);
  if (err == cudaSuccess) err = tile_map(&tdo, dout, (uint64_t)bh * s, D, kBQ);
  if (err == cudaSuccess) err = tile_map(&tk, k, kv_rows, D, kBK);
  if (err == cudaSuccess) err = tile_map(&tv, v, kv_rows, D, kBK);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<D, CAUSAL>, Layout<D>::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, CAUSAL>
      <<<bh * (s / kBQ), kThreads, Layout<D>::kSmem, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dq), bh, s, h,
          hk, scale);
  return cudaGetLastError();
}

}  // namespace dq

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
    return causal ? edl::dq::launch<64, true>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st)
                  : edl::dq::launch<64, false>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st);
  if (d == 128)
    return causal ? edl::dq::launch<128, true>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st)
                  : edl::dq::launch<128, false>(q, k, v, dout, lse, delta, dq, bh, s, h, hk, scale, st);
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
