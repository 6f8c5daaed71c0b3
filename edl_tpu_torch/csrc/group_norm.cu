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
// Design, simple first.  The Pallas kernels hold one image's [hw, c] in
// VMEM and read it once; a Hopper block has 227 KB of shared memory and the
// ResNet-50 stem's image is 1.6 MB, so each direction is three kernels:
//   1. stats: one block per (chunk of rows, image) sums u and u·v per
//      channel over its rows (each thread owns 8 consecutive channels, one
//      16-byte load per row; the block's row lanes are combined in lane
//      order in shared memory) and writes one partial row [c];
//   2. finalize: one block per image sums the partials in chunk order,
//      folds channels into groups and writes the statistics and the
//      per-channel coefficients;
//   3. apply: one block per (chunk, image) streams the rows again and
//      writes y (or dx).
// Every sum runs in a fixed order and no atomics are used, so every run
// gives the same bits.  The second read of x (and dy) makes the traffic
// 1.5x (forward) and 5/3x (backward) of the bound at best; keeping an
// image resident in a cluster's distributed shared memory would save it
// and is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels of one thread: 16 bytes of bf16
constexpr int kMaxChannels = kThreads * kVec;

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// rounding to the activation dtype (none for fp32)
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }

// Per-channel sums of u and of u·v (rounded to T) over one chunk of rows of
// one image.  part is [2][b][n_chunks][c]: the sums of u, then of u·v.
template <typename T, bool SQUARE>
__device__ __forceinline__ void chunk_sums(const T* __restrict__ u,
                                           const T* __restrict__ v,
                                           float* __restrict__ part, int b,
                                           int hw, int c, int rows) {
  __shared__ float red[2][kMaxChannels];
  const int nv = c / kVec, per_pass = kThreads / nv;
  const int lane_row = threadIdx.x / nv, cv = threadIdx.x % nv;
  const int chunk = blockIdx.x, img = blockIdx.y, n_chunks = gridDim.x;
  const int r_end = min((chunk + 1) * rows, hw);
  float sa[kVec], sb[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sa[i] = sb[i] = 0.f;
  if (lane_row < per_pass) {
    const size_t base = (size_t)img * hw * c + cv * kVec;
#pragma unroll 4
    for (int r = chunk * rows + lane_row; r < r_end; r += per_pass) {
      float fu[kVec], fv[kVec];
      load8(u + base + (size_t)r * c, fu);
      if (SQUARE) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) fv[i] = fu[i];
      } else {
        load8(v + base + (size_t)r * c, fv);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sa[i] += fu[i];
        sb[i] += rnd<T>(__fmul_rn(fu[i], fv[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      red[0][lane_row * c + cv * kVec + i] = sa[i];
      red[1][lane_row * c + cv * kVec + i] = sb[i];
    }
  }
  __syncthreads();
  float* pa = part + ((size_t)img * n_chunks + chunk) * c;
  float* pb = pa + (size_t)b * n_chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, s = 0.f;
    for (int k = 0; k < per_pass; ++k) {
      a += red[0][k * c + ch];
      s += red[1][k * c + ch];
    }
    pa[ch] = a;
    pb[ch] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_fwd_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int b,
                    int hw, int c, int rows) {
  chunk_sums<T, true>(x, x, part, b, hw, c, rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_stats_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    float* __restrict__ part, int b, int hw, int c, int rows) {
  chunk_sums<T, false>(dy, x, part, b, hw, c, rows);
}

// One block per image: group mean and inv from the chunk partials, and the
// per-channel p, q (coef [b][2][c], values of T held in fp32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_fwd_finalize_kernel(const float* __restrict__ part,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       float* __restrict__ mean_out,
                       float* __restrict__ inv_out, float* __restrict__ coef,
                       int b, int n_chunks, int c, int groups, float n,
                       float eps) {
  __shared__ float sum_x[kMaxChannels], sum_xx[kMaxChannels];
  __shared__ float g_mean[kMaxChannels], g_inv[kMaxChannels];
  const int img = blockIdx.x, cg = c / groups;
  const float* pa = part + (size_t)img * n_chunks * c;
  const float* pb = pa + (size_t)b * n_chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, s = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      a += pa[(size_t)k * c + ch];
      s += pb[(size_t)k * c + ch];
    }
    sum_x[ch] = a;
    sum_xx[ch] = s;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float a = 0.f, s = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int ch = g * cg + j;
      a += sum_x[ch];
      s += sum_xx[ch];
    }
    const float mean = __fdiv_rn(a, n), mean2 = __fdiv_rn(s, n);
    const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
    const float inv = rsqrtf(__fadd_rn(var, eps));
    g_mean[g] = mean;
    g_inv[g] = inv;
    mean_out[(size_t)img * groups + g] = mean;
    inv_out[(size_t)img * groups + g] = inv;
  }
  __syncthreads();
  float* cp = coef + (size_t)img * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const float mean = g_mean[ch / cg], inv = g_inv[ch / cg];
    const float gamma = scale[ch];
    cp[ch] = rnd<T>(__fmul_rn(inv, gamma));
    cp[c + ch] = rnd<T>(
        __fsub_rn(bias[ch], __fmul_rn(__fmul_rn(mean, inv), gamma)));
  }
}

// y = x·p + q, each operation rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                    T* __restrict__ y, int hw, int c, int rows) {
  const int nv = c / kVec, per_pass = kThreads / nv;
  const int lane_row = threadIdx.x / nv, cv = threadIdx.x % nv;
  if (lane_row >= per_pass) return;
  const int chunk = blockIdx.x, img = blockIdx.y;
  const float* cp = coef + (size_t)img * 2 * c + cv * kVec;
  float p[kVec], q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    p[i] = cp[i];
    q[i] = cp[c + i];
  }
  const size_t base = (size_t)img * hw * c + cv * kVec;
  const int r_end = min((chunk + 1) * rows, hw);
#pragma unroll 4
  for (int r = chunk * rows + lane_row; r < r_end; r += per_pass) {
    float f[kVec];
    load8(x + base + (size_t)r * c, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      f[i] = __fadd_rn(rnd<T>(__fmul_rn(f[i], p[i])), q[i]);
    store8(y + base + (size_t)r * c, f);
  }
}

// One block per image: the dγ/dβ partials of this image, and the
// per-channel p, q, r of dx (coef [b][3][c], values of T held in fp32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_finalize_kernel(const float* __restrict__ part,
                       const float* __restrict__ scale,
                       const float* __restrict__ mean_in,
                       const float* __restrict__ inv_in,
                       float* __restrict__ dg, float* __restrict__ db,
                       float* __restrict__ coef, int b, int n_chunks, int c,
                       int groups, float n) {
  __shared__ float sum_dy[kMaxChannels], sum_dyx[kMaxChannels];
  __shared__ float g_m1[kMaxChannels], g_m2[kMaxChannels];
  const int img = blockIdx.x, cg = c / groups;
  const float* pa = part + (size_t)img * n_chunks * c;
  const float* pb = pa + (size_t)b * n_chunks * c;
  const float* mean_g = mean_in + (size_t)img * groups;
  const float* inv_g = inv_in + (size_t)img * groups;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, s = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc) {
      a += pa[(size_t)kc * c + ch];
      s += pb[(size_t)kc * c + ch];
    }
    sum_dy[ch] = a;
    sum_dyx[ch] = s;
    const float mean = mean_g[ch / cg], inv = inv_g[ch / cg];
    // dγ = Σ dy·x̂ = inv·(s − mean·a);  dβ = a
    dg[(size_t)img * c + ch] = __fmul_rn(inv, __fsub_rn(s, __fmul_rn(mean, a)));
    db[(size_t)img * c + ch] = a;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    // group sums of dy·γ and dy·γ·x over the group's channels
    float s1 = 0.f, s2 = 0.f;
    for (int ch = g * cg; ch < (g + 1) * cg; ++ch) {
      s1 = __fadd_rn(s1, __fmul_rn(scale[ch], sum_dy[ch]));
      s2 = __fadd_rn(s2, __fmul_rn(scale[ch], sum_dyx[ch]));
    }
    g_m1[g] = __fdiv_rn(s1, n);
    g_m2[g] = __fdiv_rn(
        __fmul_rn(inv_g[g], __fsub_rn(s2, __fmul_rn(mean_g[g], s1))), n);
  }
  __syncthreads();
  float* cp = coef + (size_t)img * 3 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int g = ch / cg;
    const float mean = mean_g[g], inv = inv_g[g];
    const float m1 = g_m1[g], m2 = g_m2[g];
    // dx = (dy·γ − m1 − x̂·m2)·inv ≡ dy·p − x·q + r
    cp[ch] = rnd<T>(__fmul_rn(scale[ch], inv));
    cp[c + ch] = rnd<T>(__fmul_rn(__fmul_rn(inv, inv), m2));
    cp[2 * c + ch] = rnd<T>(__fmul_rn(
        __fsub_rn(__fmul_rn(__fmul_rn(mean, inv), m2), m1), inv));
  }
}

__device__ __forceinline__ void load_coef(const float* cp, int c, float* p,
                                          float* q, float* r) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    p[i] = cp[i];
    q[i] = cp[c + i];
    r[i] = cp[2 * c + i];
  }
}

// dx = dy·p − x·q + r, each operation rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ coef, T* __restrict__ dx, int hw,
                    int c, int rows) {
  const int nv = c / kVec, per_pass = kThreads / nv;
  const int lane_row = threadIdx.x / nv, cv = threadIdx.x % nv;
  if (lane_row >= per_pass) return;
  const int chunk = blockIdx.x, img = blockIdx.y;
  float p[kVec], q[kVec], r[kVec];
  load_coef(coef + (size_t)img * 3 * c + cv * kVec, c, p, q, r);
  const size_t base = (size_t)img * hw * c + cv * kVec;
  const int r_end = min((chunk + 1) * rows, hw);
#pragma unroll 4
  for (int row = chunk * rows + lane_row; row < r_end; row += per_pass) {
    float fd[kVec], fx[kVec];
    load8(dy + base + (size_t)row * c, fd);
    load8(x + base + (size_t)row * c, fx);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float t = rnd<T>(__fsub_rn(rnd<T>(__fmul_rn(fd[i], p[i])),
                                       rnd<T>(__fmul_rn(fx[i], q[i]))));
      fd[i] = __fadd_rn(t, r[i]);
    }
    store8(dx + base + (size_t)row * c, fd);
  }
}

template <typename T>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y,
               void* mean, void* inv, void* part, void* coef, int b, int hw,
               int c, int groups, int rows, float eps, cudaStream_t stream) {
  const int n_chunks = (hw + rows - 1) / rows;
  const dim3 grid(n_chunks, b);
  const float n = (float)hw * (float)(c / groups);
  gn_fwd_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), b, hw, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_fwd_finalize_kernel<T><<<b, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(mean),
      static_cast<float*>(inv), static_cast<float*>(coef), b, n_chunks, c,
      groups, n, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_fwd_apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(coef),
      static_cast<T*>(y), hw, c, rows);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* scale,
               const void* mean, const void* inv, void* dx, void* dg, void* db,
               void* part, void* coef, int b, int hw, int c, int groups,
               int rows, cudaStream_t stream) {
  const int n_chunks = (hw + rows - 1) / rows;
  const dim3 grid(n_chunks, b);
  const float n = (float)hw * (float)(c / groups);
  gn_bwd_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<float*>(part), b, hw, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_finalize_kernel<T><<<b, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<const float*>(mean), static_cast<const float*>(inv),
      static_cast<float*>(dg), static_cast<float*>(db),
      static_cast<float*>(coef), b, n_chunks, c, groups, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(coef), static_cast<T*>(dx), hw, c, rows);
  return cudaGetLastError();
}

bool shape_ok(int b, int hw, int c, int groups, int rows) {
  return b > 0 && b <= 65535 && hw > 0 && rows > 0 && groups > 0 &&
         c >= kVec && c <= kMaxChannels && c % kVec == 0 && c % groups == 0;
}

}  // namespace
}  // namespace edl

extern "C" int edl_group_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* inv, void* part, void* coef, int b,
                                  int hw, int c, int groups, int rows,
                                  int is_bf16, float eps, void* stream) {
  if (!edl::shape_ok(b, hw, c, groups, rows)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return edl::launch_fwd<__nv_bfloat16>(x, scale, bias, y, mean, inv, part,
                                          coef, b, hw, c, groups, rows, eps,
                                          st);
  return edl::launch_fwd<float>(x, scale, bias, y, mean, inv, part, coef, b,
                                hw, c, groups, rows, eps, st);
}

extern "C" int edl_group_norm_bwd(const void* x, const void* dy,
                                  const void* scale, const void* mean,
                                  const void* inv, void* dx, void* dg,
                                  void* db, void* part, void* coef, int b,
                                  int hw, int c, int groups, int rows,
                                  int is_bf16, void* stream) {
  if (!edl::shape_ok(b, hw, c, groups, rows)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return edl::launch_bwd<__nv_bfloat16>(x, dy, scale, mean, inv, dx, dg, db,
                                          part, coef, b, hw, c, groups, rows,
                                          st);
  return edl::launch_bwd<float>(x, dy, scale, mean, inv, dx, dg, db, part,
                                coef, b, hw, c, groups, rows, st);
}
