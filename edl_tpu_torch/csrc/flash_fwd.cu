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
// Design (Hopper's producer / consumer shape):
//   * one block per (q tile of 128 rows, folded head): two consumer
//     warpgroups of 64 rows each and a producer warpgroup, 384 threads; one
//     producer thread issues every load, and setmaxnreg hands the producer
//     warpgroup's registers to the consumers (a producer warp alone would
//     leave the block too small a register pool to hand over);
//   * the producer issues TMA loads: Q once, then K and V tiles of 128 keys
//     through a ring of shared-memory stages (2 at d 128, 3 at d 64) with a
//     full and an empty mbarrier per stage, so loads run ahead of compute;
//     tiles above the causal diagonal are never loaded;
//   * S = Q·Kᵀ is wgmma from shared memory (K is K-major as it stands);
//     the softmax runs on the accumulator in registers in base 2, log2(e)
//     folded into the scale; P is rounded to bf16 (the Pallas kernel casts
//     p to v's dtype) and feeds P·V as the register A operand, with V read
//     MN-major through the transpose bit; the row sum uses the fp32 p;
//   * the running max / sum / output accumulator stay in registers across
//     the key loop (a TPU grid carried them in VMEM along its sequential k
//     axis); only the diagonal tile is masked;
//   * blocks are numbered heaviest q tile first, so that the causal
//     imbalance leaves no tail on the 132 SMs;
//   * issuing the next tile's S before this tile's P·V (a software
//     pipeline) measured slower on an H100, so the loop is S, softmax, P·V;
//   * no __syncthreads() after set-up: the roles meet only at mbarriers.
#include "hopper_common.cuh"

namespace edl {
namespace fwd {

using namespace hopper;

constexpr int kBQ = 128;                   // q rows of a block
constexpr int kBK = 128;                   // keys of a K/V tile
constexpr int kConsumers = 256;            // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRegion = 128 * 128;         // bytes of a 128-row, 64-column box
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int kRegions = D / 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = kBQ * D * 2;  // a Q, K or V tile
  // Q, then per stage K and V, then the barriers; 1 KB for alignment
  static constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int bh_count,
                 int s, int h, int hk, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* skv = sq + L::kTileBytes;  // stage st: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sq + L::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  const int n_qt = s / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int qt = CAUSAL ? n_qt - 1 - (int)blockIdx.x / bh_count
                        : (int)blockIdx.x / bh_count;
  const int kvh = (bh / h) * hk + (bh % h) / (h / hk);  // _kv_head_map
  // kBQ == kBK: when causal, tile qt is the diagonal and the last one
  const int n_kt = CAUSAL ? qt + 1 : s / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    // producer: one thread of the last warpgroup issues every load
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kTileBytes);
      for (int r = 0; r < L::kRegions; ++r)
        tma_load_2d(sq + r * kRegion, &tq, q_full, 64 * r, bh * s + qt * kBQ);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % L::kStages;
        const uint32_t round = i / L::kStages;
        unsigned char* sk = skv + 2 * st * L::kTileBytes;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kTileBytes);
        for (int r = 0; r < L::kRegions; ++r) {
          tma_load_2d(sk + r * kRegion, &tk, &full[st], 64 * r,
                      kvh * s + i * kBK);
          tma_load_2d(sk + L::kTileBytes + r * kRegion, &tv, &full[st],
                      64 * r, kvh * s + i * kBK);
        }
      }
    }
  } else {
    consumer_regs();
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the q tile
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, c = lane % 4;
    const int row = wg * 64 + (t / 32) * 16 + lane / 4;  // and row + 8
    const float scale_log2 = scale * kLog2e;
    const uint64_t dq0 = desc_sw128(sq + wg * 64 * 128, 16, 1024);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's
                                                         // columns only
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % L::kStages;
      const uint32_t round = i / L::kStages;
      unsigned char* sk = skv + 2 * st * L::kTileBytes;
      const uint64_t dk0 = desc_sw128(sk, 16, 1024);
      const uint64_t dv0 = desc_sw128(sk + L::kTileBytes, kRegion, 1024);
      mbar_wait(&full[st], round & 1);

      // S = Q Kᵀ: 64 rows x 128 keys, contracted over d in 16-wide steps
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / 4) * kRegion + (kk % 4) * 32;
        wgmma_ss<kBK>(sc, desc_add(dq0, koff), desc_add(dk0, koff), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale (base 2), mask the diagonal tile (_block_scores), and the
      // online-softmax update
      const bool diag = CAUSAL && i == n_kt - 1;
      float mnew[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (diag && 8 * j + 2 * c + (e & 1) > row + 8 * (e >> 1))
            x = kNegInf;
          sc[4 * j + e] = x;
          mnew[e >> 1] = fmaxf(mnew[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mnew[r] = quad_max(mnew[r]);
        alpha[r] = exp2f(m[r] - mnew[r]);
        m[r] = mnew[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * j + e] - m[e >> 1]);
          sc[4 * j + e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];

      // acc += bf16(P) · V, P from registers, V MN-major
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc_add(dv0, kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    const size_t grow = (size_t)bh * s + qt * kBQ + row;
    bf16* out = o + grow * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j] / l[0], acc[4 * j + 1] / l[0]);
      *reinterpret_cast<uint32_t*>(out + 8 * D + 8 * j) =
          pack_bf16(acc[4 * j + 2] / l[1], acc[4 * j + 3] / l[1]);
    }
    if (c == 0) {
      lse[grow] = (m[0] + log2f(l[0])) * kLn2;
      lse[grow + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
}

template <int D, bool CAUSAL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int s, int h, int hk,
                          float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const uint64_t kv_rows = (uint64_t)(bh / h * hk) * s;
  cudaError_t err = tile_map(&tq, q, (uint64_t)bh * s, D, kBQ);
  if (err == cudaSuccess) err = tile_map(&tk, k, kv_rows, D, kBK);
  if (err == cudaSuccess) err = tile_map(&tv, v, kv_rows, D, kBK);
  if (err == cudaSuccess)
    err = allow_smem(flash_fwd_kernel<D, CAUSAL>, Layout<D>::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D, CAUSAL>
      <<<bh * (s / kBQ), kThreads, Layout<D>::kSmem, stream>>>(
          tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), bh, s,
          h, hk, scale);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace edl

// q [bh, s, d], k/v [bh / h * hk, s, d] bf16 -> o [bh, s, d] bf16,
// lse [bh, s] fp32.  The caller guarantees s % 128 == 0, d in {64, 128},
// h % hk == 0 and contiguous 16-byte-aligned buffers.  Returns a cudaError_t.
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int s, int d, int h,
                             int hk, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return causal ? edl::fwd::launch<64, true>(q, k, v, o, lse, bh, s, h, hk, scale, st)
                  : edl::fwd::launch<64, false>(q, k, v, o, lse, bh, s, h, hk, scale, st);
  if (d == 128)
    return causal ? edl::fwd::launch<128, true>(q, k, v, o, lse, bh, s, h, hk, scale, st)
                  : edl::fwd::launch<128, false>(q, k, v, o, lse, bh, s, h, hk, scale, st);
  return (int)cudaErrorInvalidValue;
}
