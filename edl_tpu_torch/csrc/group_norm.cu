// GroupNorm over NHWC activations for Hopper (sm_90a), forward and
// backward, written by hand.
//
// Replaces: edl_tpu/ops/group_norm.py::_fwd_kernel (launched by _fwd) and
// ::_bwd_kernel (launched by _bwd_call).  x is [b, hw, c] (bf16 or fp32),
// scale and bias fp32 [c], G groups of c / G consecutive channels.
//   forward:  y = x·p + q in x's dtype, with per-channel p = inv·γ and
//             q = β − mean·inv·γ rounded to x's dtype; mean and inv [b, G]
//             fp32 from fp32 sums of x and of x·x (the product rounded to
//             x's dtype first, as the Pallas kernel does);
//   backward: per-channel a = Σ dy and s = Σ dy·x (rounded product) give the
//             per-image partials dγ = inv·(s − mean·a), dβ = a [b, c] fp32
//             and dx = dy·p − x·q + r in x's dtype with p, q, r rounded.
//
// Bound on an H100 SXM: bytes.  The forward must read x once and write y
// once, the backward read x and dy once and write dx once.  At ResNet-50,
// b 256 (53 sites, 5.69 GB of bf16 activations) that is ~3.40 ms forward
// and ~5.10 ms backward per step at 3.35 TB/s; the arithmetic is a few
// operations an element.
//
// Design: one kernel per direction, one thread block cluster per image, and
// the image read once, as the Pallas kernels read it once from VMEM.  A
// Hopper block has 227 KB of shared memory and the ResNet-50 stem's image
// is 1.6 MB, but the shared memories of a cluster of 8 blocks hold it (16
// blocks hold the backward's dy and x).  The grid is (k, b) with clusters
// of (k, 1, 1); block r of image i:
//   1. owns rows [r·rows, (r + 1)·rows) of image i, one contiguous byte
//      range of NHWC, and copies the first `resident` of them into shared
//      memory with 1-D bulk copies in kPieces pieces, each completing on its
//      own mbarrier (the backward keeps dy's rows first, then x's), thread
//      0 starting them;
//   2. sums u and u·v per channel over its rows (forward u = v = x,
//      backward u = dy, v = x): the rows that are not resident straight
//      from device memory while the copies land, then each piece as it
//      lands.  Each thread owns 8 consecutive channels (one 16-byte load a
//      row); the block's row lanes are combined in lane order into one
//      [c, 2] row of partial sums in shared memory;
//   3. after a cluster barrier, reads the k partial rows of its cluster
//      through distributed shared memory, all at once, and sums them in
//      rank order; a second cluster barrier ends every remote read, so no
//      block exits (or overwrites its row) while a peer may still read it;
//   4. folds the image's channel sums into groups and computes the
//      statistics and its per-channel coefficients itself: every block sums
//      the same values in the same order and holds the same bits, so
//      nothing more is exchanged.  Rank 0 writes mean and inv (forward) or
//      the image's dγ/dβ partials (backward);
//   5. computes y (or dx) from its resident rows and writes it with 16-byte
//      stores; the rows that did not fit are read again from device memory,
//      where this block has just read them (usually still in L2).
// In bf16 the products, differences and sums that round to bf16 are bf16x2
// instructions, each rounding once as the plain versions' fp32 operation
// rounded to bf16 does.  A revision that rounded each fp32 result with a
// conversion, one element at a time, was bound by the conversions, not the
// bytes (PERF.md).
// ops/group_norm.py::cluster_plan picks k, rows and resident on the host.
// Every sum runs in a fixed order and no atomics are used, so every run
// gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

#include "hopper_common.cuh"

namespace edl {
namespace {

constexpr int kBlock = 512;  // threads; thread 0 also starts the copies
constexpr int kVec = 8;      // channels of one thread: 16 bytes of bf16
constexpr int kMaxChannels = 2048;
constexpr int kSteps = kMaxChannels / kBlock;  // channels (or groups) a thread folds
constexpr int kPieces = 8;   // bulk copies, each on its own mbarrier
constexpr int kMaxCluster = 16;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block

struct Params {
  const void* u;        // forward: x; backward: dy
  const void* v;        // backward: x
  const float* scale;   // γ [c]
  const float* bias;    // β [c] (forward)
  const float* mean;    // backward: the forward's statistics [b, G]
  const float* inv;
  void* out;            // y or dx
  float* stat_a;        // forward: mean [b, G]; backward: dγ partials [b, c]
  float* stat_b;        // forward: inv [b, G]; backward: dβ partials [b, c]
  int hw, c, groups;
  int rows;             // rows of one block
  int resident;         // rows held in shared memory (backward: dy's, then x's)
  float n, eps;         // elements of one group; the variance's epsilon
};

// 8 channels of one row as loaded: one 16-byte word of bf16, two of fp32
template <typename T>
struct Raw {
  uint4 w[sizeof(T) / 2];
};

template <bool GLOBAL, typename T>
__device__ __forceinline__ void fetch(const T* p, Raw<T>& raw) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    raw.w[i] = GLOBAL ? __ldg(q + i) : q[i];
}

template <typename T>
__device__ __forceinline__ const uint32_t* words(const Raw<T>& raw) {
  return reinterpret_cast<const uint32_t*>(raw.w);
}

// rounding to the activation dtype (none for fp32)
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }

// bf16 pairs: the low and high halves of a word as fp32, and the products,
// differences and sums of pairs rounded once to bf16.  For bf16 operands
// that equals the fp32 operation rounded to bf16, as the plain versions
// compute it: fp32 carries more than 2·8 + 2 bits, so rounding twice gives
// the same value as rounding once.
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// two fp32 values that are bf16 already as one pair
__device__ __forceinline__ uint32_t pair(float l, float h) {
  return (__float_as_uint(h) & 0xffff0000u) | (__float_as_uint(l) >> 16);
}
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// sa += u and sb += rnd(u·v) over 8 channels of one row (forward: v = u)
__device__ __forceinline__ void sum8(const Raw<bf16>& ru, const Raw<bf16>& rv,
                                     float* sa, float* sb) {
  const uint32_t *u = words(ru), *v = words(rv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = mul2(u[i], v[i]);
    sa[2 * i] += lo(u[i]);
    sa[2 * i + 1] += hi(u[i]);
    sb[2 * i] += lo(m);
    sb[2 * i + 1] += hi(m);
  }
}

__device__ __forceinline__ void sum8(const Raw<float>& ru,
                                     const Raw<float>& rv, float* sa,
                                     float* sb) {
  const float* u = reinterpret_cast<const float*>(ru.w);
  const float* v = reinterpret_cast<const float*>(rv.w);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    sa[i] += u[i];
    sb[i] += __fmul_rn(u[i], v[i]);
  }
}

// A thread's per-channel coefficients as its elementwise pass uses them:
// bf16 pairs, or fp32
template <typename T> struct Coef;
template <> struct Coef<bf16> { uint32_t p[4], q[4], r[4]; };
template <> struct Coef<float> { float p[kVec], q[kVec], r[kVec]; };

__device__ __forceinline__ void set_coef(Coef<bf16>& k, const float* p,
                                         const float* q, const float* r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    k.p[i] = pair(p[2 * i], p[2 * i + 1]);
    k.q[i] = pair(q[2 * i], q[2 * i + 1]);
    k.r[i] = pair(r[2 * i], r[2 * i + 1]);
  }
}

__device__ __forceinline__ void set_coef(Coef<float>& k, const float* p,
                                         const float* q, const float* r) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    k.p[i] = p[i];
    k.q[i] = q[i];
    k.r[i] = r[i];
  }
}

// y = x·p + q (forward; u = x) or dx = dy·p − x·q + r (backward; u = dy,
// v = x) over 8 channels, each operation rounded to T
template <bool BWD>
__device__ __forceinline__ void norm8(const Raw<bf16>& ru, const Raw<bf16>& rv,
                                      const Coef<bf16>& k, Raw<bf16>& out) {
  const uint32_t *u = words(ru), *v = words(rv);
  uint32_t* o = reinterpret_cast<uint32_t*>(out.w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = BWD ? add2(sub2(mul2(u[i], k.p[i]), mul2(v[i], k.q[i])), k.r[i])
               : add2(mul2(u[i], k.p[i]), k.q[i]);
}

template <bool BWD>
__device__ __forceinline__ void norm8(const Raw<float>& ru,
                                      const Raw<float>& rv,
                                      const Coef<float>& k, Raw<float>& out) {
  const float* u = reinterpret_cast<const float*>(ru.w);
  const float* v = reinterpret_cast<const float*>(rv.w);
  float* o = reinterpret_cast<float*>(out.w);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    o[i] = BWD ? __fadd_rn(__fsub_rn(__fmul_rn(u[i], k.p[i]),
                                     __fmul_rn(v[i], k.q[i])),
                           k.r[i])
               : __fadd_rn(__fmul_rn(u[i], k.p[i]), k.q[i]);
}

// Rows a thread loads before it uses any.  From shared memory one row at
// a time (unrolled 4); from device memory (or L2) 64 bytes of each of u and
// v in flight a thread in the backward, 128 bytes of u in the forward, so
// that a thread waits once a batch.
template <typename T, bool BWD, bool GLOBAL>
constexpr int kBatch = GLOBAL ? (BWD ? 8 : 16) / (int)sizeof(T) : 1;

template <typename T, bool BWD, bool U_GLOBAL, bool V_GLOBAL>
__device__ __forceinline__ void accumulate(const T* __restrict__ u,
                                           const T* __restrict__ v, int r0,
                                           int r1, int lane, int lanes,
                                           int c, float* sa, float* sb) {
  constexpr int B = kBatch<T, BWD, U_GLOBAL || V_GLOBAL>;
#pragma unroll ((U_GLOBAL || V_GLOBAL) ? 1 : 4)
  for (int r = r0 + lane; r < r1; r += B * lanes) {
    Raw<T> ru[B], rv[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (r + b * lanes < r1) {
        fetch<U_GLOBAL>(u + (size_t)(r + b * lanes) * c, ru[b]);
        if constexpr (BWD) fetch<V_GLOBAL>(v + (size_t)(r + b * lanes) * c, rv[b]);
      }
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (r + b * lanes < r1) sum8(ru[b], BWD ? rv[b] : ru[b], sa, sb);
  }
}

// y (or dx) over rows [r0, r1), walked as accumulate walks them
template <typename T, bool BWD, bool U_GLOBAL, bool V_GLOBAL>
__device__ __forceinline__ void apply_rows(const T* __restrict__ u,
                                           const T* __restrict__ v,
                                           T* __restrict__ out, int r0,
                                           int r1, int lane, int lanes,
                                           int c, const Coef<T>& k) {
  constexpr int B = kBatch<T, BWD, U_GLOBAL || V_GLOBAL>;
#pragma unroll ((U_GLOBAL || V_GLOBAL) ? 1 : 4)
  for (int row = r0 + lane; row < r1; row += B * lanes) {
    Raw<T> ru[B], rv[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (row + b * lanes < r1) {
        fetch<U_GLOBAL>(u + (size_t)(row + b * lanes) * c, ru[b]);
        if constexpr (BWD) fetch<V_GLOBAL>(v + (size_t)(row + b * lanes) * c, rv[b]);
      }
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (row + b * lanes < r1) {
        Raw<T> o;
        norm8<BWD>(ru[b], BWD ? rv[b] : ru[b], k, o);
        uint4* dst = reinterpret_cast<uint4*>(out + (size_t)(row + b * lanes) * c);
#pragma unroll
        for (int i = 0; i < (int)(sizeof(T) / 2); ++i) dst[i] = o.w[i];
      }
  }
}

// p, q, r of dx = dy·p − x·q + r for 8 channels, rounded to T, from their γ
// and their group's mean and inv, and the group sums s1 = Σ dy·γ (at m[g])
// and s2 = Σ dy·γ·x (at m[c + g]) of the image; n elements a group.
template <typename T>
__device__ __forceinline__ void dx_coefs(const float* m, int c, int cg,
                                         int ch0, float n,
                                         const float* gamma,
                                         const float* mean, const float* inv,
                                         float* p, float* q, float* r) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int g = (ch0 + i) / cg;
    const float s1 = m[g], s2 = m[c + g];
    const float m1 = __fdiv_rn(s1, n);
    const float m2 =
        __fdiv_rn(__fmul_rn(inv[i], __fsub_rn(s2, __fmul_rn(mean[i], s1))), n);
    // dx = (dy·γ − m1 − x̂·m2)·inv ≡ dy·p − x·q + r
    p[i] = rnd<T>(__fmul_rn(gamma[i], inv[i]));
    q[i] = rnd<T>(__fmul_rn(__fmul_rn(inv[i], inv[i]), m2));
    r[i] = rnd<T>(__fmul_rn(
        __fsub_rn(__fmul_rn(__fmul_rn(mean[i], inv[i]), m2), m1), inv[i]));
  }
}

// Rows [r0, r1) of `rows` (row_bytes each) into L2, 64 KB a request.
__device__ __forceinline__ void prefetch_rows(const void* rows, int r0,
                                              int r1, uint32_t row_bytes) {
  const char* p = static_cast<const char*>(rows);
  for (size_t at = (size_t)r0 * row_bytes, end = (size_t)r1 * row_bytes;
       at < end; at += 65536)
    hopper::bulk_prefetch_l2(p + at, end - at < 65536 ? end - at : 65536);
}

// Shared memory of one block: the resident rows (u's, then v's), then the
// fp32 lane sums [lanes][c] of one sum at a time (later the partial row
// [2][c], the image's channel sums and the group values), then the
// mbarriers.
__host__ __device__ inline size_t lane_sums_bytes(int c) {
  return sizeof(float) * max(kBlock / (c / kVec), 2) * c;
}

inline size_t smem_bytes(int c, int resident, size_t itemsize) {
  return (size_t)resident * c * itemsize + lane_sums_bytes(c) +
         sizeof(uint64_t) * kPieces;
}

template <typename T, bool BWD>
__device__ __forceinline__ void cluster_norm(const Params& P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = P.c, cg = c / P.groups, nv = c / kVec, lanes = kBlock / nv;
  const int tid = threadIdx.x, lane = tid / nv, off = tid % nv * kVec;
  const bool active = lane < lanes;  // a thread with 8 channels of a row
  const int k = (int)hopper::cluster_size();
  const int rank = (int)hopper::cluster_rank();
  const int img = blockIdx.y, row0 = rank * P.rows;
  const int n = max(0, min(P.rows, P.hw - row0));  // rows of this block
  const int res_u = min(P.resident, n);
  const int res_v = BWD ? min(max(P.resident - P.rows, 0), n) : 0;
  T* su = reinterpret_cast<T*>(smem);
  T* sv = su + (size_t)res_u * c;
  float* red =
      reinterpret_cast<float*>(smem + (size_t)P.resident * c * sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(red) + lane_sums_bytes(c));
  const size_t base = ((size_t)img * P.hw + row0) * c;
  const T* gu = static_cast<const T*>(P.u) + base;
  const T* gv = static_cast<const T*>(BWD ? P.v : P.u) + base;
  T* out = static_cast<T*>(P.out) + base;

  // 1. the rows that are not resident into L2, where the sums and then the
  // elementwise pass read them; the resident rows, in pieces of consecutive
  // rows
  const int piece = res_u ? (res_u + kPieces - 1) / kPieces : 1;
  const int n_pieces = (res_u + piece - 1) / piece;
  if (tid == 0) {
    for (int i = 0; i < n_pieces; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // the copies queue up in the copy engine; every thread starts on each
  // piece as it lands
  if (tid == 0) {
    const uint32_t row_bytes = c * sizeof(T);
    prefetch_rows(gu, res_u, n, row_bytes);
    if (BWD) prefetch_rows(gv, res_v, n, row_bytes);
    for (int i = 0; i < n_pieces; ++i) {
      const int r0 = i * piece, r1 = min(r0 + piece, res_u);
      const int v1 = min(r1, res_v);
      const uint32_t bu = (r1 - r0) * row_bytes;
      const uint32_t bv = v1 > r0 ? (v1 - r0) * row_bytes : 0;
      hopper::mbar_expect_tx(&bars[i], bu + bv);
      hopper::bulk_load(su + (size_t)r0 * c, gu + (size_t)r0 * c, bu,
                        &bars[i]);
      if (bv)
        hopper::bulk_load(sv + (size_t)r0 * c, gv + (size_t)r0 * c, bv,
                          &bars[i]);
    }
  }

  // parameters, loaded first so that their latency hides under the copies:
  // γ and β (forward) or γ and the group's mean and inv (backward) of this
  // thread's 8 channels, and the backward's γ, mean and inv of the channels
  // it folds (tid + j·kBlock)
  float pg[kVec], pb[kVec], pm[kVec], pi[kVec];
  float fg[kSteps], fm[kSteps], fi[kSteps];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int ch = min(off + i, c - 1), at = img * P.groups + ch / cg;
    pg[i] = __ldg(P.scale + ch);
    pb[i] = BWD ? 0.f : __ldg(P.bias + ch);
    pm[i] = BWD ? __ldg(P.mean + at) : 0.f;
    pi[i] = BWD ? __ldg(P.inv + at) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int ch = min(tid + j * kBlock, c - 1), at = img * P.groups + ch / cg;
    fg[j] = BWD ? __ldg(P.scale + ch) : 0.f;
    fm[j] = BWD ? __ldg(P.mean + at) : 0.f;
    fi[j] = BWD ? __ldg(P.inv + at) : 0.f;
  }

  // 2. per-channel sums over this block's rows
  float sa[kVec], sb[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sa[i] = sb[i] = 0.f;
  if (active) {
    // rows that are not resident, while the copies land
    accumulate<T, BWD, true, true>(gu + off, gv + off, res_u, n, lane, lanes,
                                   c, sa, sb);
    for (int i = 0; i < n_pieces; ++i) {
      const int r0 = i * piece, r1 = min(r0 + piece, res_u);
      const int rv = min(max(res_v, r0), r1);  // rows [r0, rv) hold v too
      hopper::mbar_wait(&bars[i], 0);
      accumulate<T, BWD, false, false>(su + off, sv + off, r0, rv, lane,
                                       lanes, c, sa, sb);
      accumulate<T, BWD, false, true>(su + off, gv + off, rv, r1, lane,
                                      lanes, c, sa, sb);
    }
  }
  // 3. the block's partial row [c][2].  Where a warp holds whole rows, its
  // rows first (a fixed butterfly of shuffles), then the warps' sums in warp
  // order; else the lanes' sums in lane order.  One sum at a time through
  // shared memory, then in place
  const bool by_warp = nv <= 32 && 32 % nv == 0;
  const int parts = by_warp ? kBlock / 32 : lanes;
  const int part = by_warp ? tid / 32 : lane;
  if (by_warp)
    for (int o = nv; o < 32; o *= 2)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sa[i] += __shfl_xor_sync(0xffffffffu, sa[i], o);
        sb[i] += __shfl_xor_sync(0xffffffffu, sb[i], o);
      }
  float ta[kSteps], tb[kSteps];  // channels tid + j·kBlock
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    if (active && (!by_warp || tid % 32 < nv)) {
      const float* s = which ? sb : sa;
      float4* l = reinterpret_cast<float4*>(red + part * c + off);
      l[0] = make_float4(s[0], s[1], s[2], s[3]);
      l[1] = make_float4(s[4], s[5], s[6], s[7]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int ch = tid + j * kBlock;
      float t = 0.f;
      if (ch < c)
#pragma unroll 8
        for (int l = 0; l < parts; ++l) t += red[l * c + ch];
      (which ? tb : ta)[j] = t;
    }
    __syncthreads();
  }
  // (the two sums of a channel side by side, one 8-byte read for a peer)
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int ch = tid + j * kBlock;
    if (ch < c) {
      red[2 * ch] = ta[j];
      red[2 * ch + 1] = tb[j];
    }
  }
  hopper::cluster_sync();
  // the image's channel sums: every peer's partial row read at once, then
  // summed in rank order
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int ch = tid + j * kBlock;
    if (ch < c) {
      float2 part[kMaxCluster];
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk) {
        if (rk >= k) break;
        part[rk] = hopper::ld_cluster2(red + 2 * ch, rk);
      }
      float a = 0.f, s = 0.f;
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk)
        if (rk < k) {
          a += part[rk].x;
          s += part[rk].y;
        }
      ta[j] = a;
      tb[j] = s;
    }
  }
  hopper::cluster_sync();  // no block reads another's shared memory after this

  // 4. the image's statistics, each block for itself.  The backward folds
  // dy·γ and dy·γ·x; its rank 0 writes the dγ/dβ partials
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int ch = tid + j * kBlock;
    if (ch < c) {
      const float a = ta[j], s = tb[j];
      if (BWD && rank == 0) {
        const float mean = fm[j], inv = fi[j];
        // dγ = Σ dy·x̂ = inv·(s − mean·a);  dβ = a
        P.stat_a[(size_t)img * c + ch] =
            __fmul_rn(inv, __fsub_rn(s, __fmul_rn(mean, a)));
        P.stat_b[(size_t)img * c + ch] = a;
      }
      red[ch] = BWD ? __fmul_rn(fg[j], a) : a;
      red[c + ch] = BWD ? __fmul_rn(fg[j], s) : s;
    }
  }
  __syncthreads();
  // the group sums (forward: of x and x·x, turned into mean and inv)
  float ga[kSteps], gb[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int g = tid + j * kBlock;
    float s1 = 0.f, s2 = 0.f;
    if (g < P.groups)
#pragma unroll 8
      for (int i = 0; i < cg; ++i) {
        const int ch = g * cg + i;
        s1 = __fadd_rn(s1, red[ch]);
        s2 = __fadd_rn(s2, red[c + ch]);
      }
    ga[j] = s1;
    gb[j] = s2;
    if (!BWD && g < P.groups) {
      const float mean = __fdiv_rn(s1, P.n), mean2 = __fdiv_rn(s2, P.n);
      const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
      ga[j] = mean;
      gb[j] = rsqrtf(__fadd_rn(var, P.eps));
      if (rank == 0) {
        P.stat_a[(size_t)img * P.groups + g] = ga[j];
        P.stat_b[(size_t)img * P.groups + g] = gb[j];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int g = tid + j * kBlock;
    if (g < P.groups) {
      red[g] = ga[j];
      red[c + g] = gb[j];
    }
  }
  __syncthreads();
  if (!active) return;

  // per-channel coefficients of this thread's 8 channels, rounded to T
  float p[kVec], q[kVec], r[kVec];
  Coef<T> coef;
  if constexpr (BWD) {
    dx_coefs<T>(red, c, cg, off, P.n, pg, pm, pi, p, q, r);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int g = (off + i) / cg;
      const float mean = red[g], inv = red[c + g];
      p[i] = rnd<T>(__fmul_rn(inv, pg[i]));
      q[i] = rnd<T>(__fsub_rn(pb[i], __fmul_rn(__fmul_rn(mean, inv), pg[i])));
      r[i] = 0.f;
    }
  }
  set_coef(coef, p, q, r);

  // 5. y (or dx): the resident rows, then the rows read again
  const T* ur = su + off;
  const T* xa = gv + off;  // the backward's x, read again
  apply_rows<T, BWD, false, false>(ur, sv + off, out + off, 0, res_v, lane,
                                   lanes, c, coef);
  apply_rows<T, BWD, false, true>(ur, xa, out + off, res_v, res_u, lane,
                                  lanes, c, coef);
  apply_rows<T, BWD, true, true>(gu + off, xa, out + off, res_u, n, lane,
                                 lanes, c, coef);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
gn_fwd_cluster_kernel(const Params P) {
  cluster_norm<T, false>(P);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
gn_bwd_cluster_kernel(const Params P) {
  cluster_norm<T, true>(P);
}

typedef void (*Kernel)(const Params);

template <typename T>
Kernel kernel_of(bool backward) {
  return backward ? gn_bwd_cluster_kernel<T> : gn_fwd_cluster_kernel<T>;
}

std::mutex g_mu;
// (kernel, device) whose attributes are set
std::set<std::pair<const void*, int>> g_ready;
// (kernel, device, k, shared bytes) -> clusters the card runs at once
std::map<std::tuple<const void*, int, int, size_t>, int> g_clusters;

cudaLaunchConfig_t launch_config(int k, int b, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, b, 1);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of k blocks with `smem` bytes each that the card runs at once
// (cudaOccupancyMaxActiveClusters), once per (kernel, device, k, smem);
// sets the kernel's shared-memory and cluster-size attributes first.
cudaError_t active_clusters(Kernel kernel, int k, size_t smem,
                            int* clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_mu);
  if (!g_ready.count({key, dev})) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_ready.insert({key, dev});
  }
  const auto id = std::make_tuple(key, dev, k, smem);
  auto it = g_clusters.find(id);
  if (it == g_clusters.end()) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(k, 1, smem, nullptr, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    it = g_clusters.emplace(id, n).first;
  }
  *clusters = it->second;
  return cudaSuccess;
}

template <typename T>
int launch(bool backward, const Params& P, int b, int k,
           cudaStream_t stream) {
  const Kernel kernel = kernel_of<T>(backward);
  const size_t smem = smem_bytes(P.c, P.resident, sizeof(T));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  int clusters = 0;
  cudaError_t err = active_clusters(kernel, k, smem, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(k, b, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shapes the kernels take, and a plan that covers every row once.
bool plan_ok(int b, int hw, int c, int groups, int k, int rows, int resident,
             bool backward) {
  return b > 0 && b <= 65535 && hw > 0 && groups > 0 && c >= kVec &&
         c <= kMaxChannels && c % kVec == 0 && c % groups == 0 && k >= 1 &&
         k <= kMaxCluster && rows > 0 && (long)k * rows >= hw &&
         resident >= 0 && resident <= (backward ? 2 : 1) * rows;
}

}  // namespace
}  // namespace edl

extern "C" int edl_group_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* inv, int b, int hw, int c, int groups,
                                  int k, int rows, int resident, int is_bf16,
                                  float eps, void* stream) {
  if (!edl::plan_ok(b, hw, c, groups, k, rows, resident, false))
    return cudaErrorInvalidValue;
  const edl::Params P = {x, nullptr, static_cast<const float*>(scale),
                         static_cast<const float*>(bias), nullptr, nullptr,
                         y, static_cast<float*>(mean),
                         static_cast<float*>(inv), hw, c, groups, rows,
                         resident, (float)hw * (float)(c / groups), eps};
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? edl::launch<__nv_bfloat16>(false, P, b, k, st)
                 : edl::launch<float>(false, P, b, k, st);
}

extern "C" int edl_group_norm_bwd(const void* x, const void* dy,
                                  const void* scale, const void* mean,
                                  const void* inv, void* dx, void* dg,
                                  void* db, int b, int hw, int c, int groups,
                                  int k, int rows, int resident, int is_bf16,
                                  void* stream) {
  if (!edl::plan_ok(b, hw, c, groups, k, rows, resident, true))
    return cudaErrorInvalidValue;
  const edl::Params P = {dy, x, static_cast<const float*>(scale), nullptr,
                         static_cast<const float*>(mean),
                         static_cast<const float*>(inv), dx,
                         static_cast<float*>(dg), static_cast<float*>(db),
                         hw, c, groups, rows, resident,
                         (float)hw * (float)(c / groups), 0.f};
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? edl::launch<__nv_bfloat16>(true, P, b, k, st)
                 : edl::launch<float>(true, P, b, k, st);
}

// Clusters of k blocks holding `resident` rows of c channels that the card
// runs at once, into *clusters.
extern "C" int edl_group_norm_active_clusters(int backward, int is_bf16,
                                              int c, int k, int resident,
                                              int* clusters) {
  if (c < edl::kVec || c > edl::kMaxChannels || c % edl::kVec || k < 1 ||
      k > edl::kMaxCluster || resident < 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      edl::smem_bytes(c, resident, is_bf16 ? sizeof(__nv_bfloat16) : 4);
  if (smem > edl::kSmemLimit) return cudaErrorInvalidValue;
  return is_bf16 ? edl::active_clusters(edl::kernel_of<__nv_bfloat16>(backward),
                                        k, smem, clusters)
                 : edl::active_clusters(edl::kernel_of<float>(backward), k,
                                        smem, clusters);
}
