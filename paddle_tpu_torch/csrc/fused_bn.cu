// Fused training batch norm and fused 1x1-conv + batch norm for Hopper
// (sm_90a), on the channel-minor (M, C) view of an NCHW activation that is
// stored channels-last (M = N*H*W rows of C contiguous channels).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/fused_bn.py:
//   K1 fused_bn_stats      <- _stats_kernel (via bn_stats): per-channel sum and
//                             sum of squares in one pass; mean = s/m,
//                             var = max(ss/m - mean^2, 0).
//   K2 fused_bn_apply      <- _apply_kernel (via bn_apply and _apply2d):
//                             y = (x - mean)*isc + bias (+ res) (relu), in x's
//                             type.
//   K3 fused_bn_bwd_reduce <- _bwd_reduce_kernel: dbeta = sum g,
//                             dgamma = sum g*xhat, g = dy*(y > 0) under relu;
//      fused_bn_bwd_dx     <- _bwd_dx_kernel: dx = isc*(g - dbeta/m -
//                             xhat*dgamma/m), dres = g.
//   K4 fused_conv_stats    <- _conv_stats_kernel (via _conv_stats):
//                             (M, Ci) @ (Ci, Co), stored in x's type, with the
//                             column sums and sums of squares of the STORED
//                             (rounded) values.
//
// Design. On the TPU the grid runs in order and the statistics accumulate in
// one output block across grid steps. Here blocks run in parallel, so every
// reduction (K1, K3's reduce, K4's epilogue) writes per-block f32 partials
// [nblocks, C] and one shared finishing kernel (finish_kernel) sums them in a
// fixed order. No float atomics: the results are the same run to run, as the
// TPU's sequential accumulation is. mean and var are finished on the device,
// so nothing waits on the host. The TPU's lane fold (_fold, C < 128) has no
// counterpart: a CTA covers up to 32 16-byte channel vectors of a row and as
// many rows as fill 256 threads, so a warp reads 512 contiguous bytes
// whatever C is.
//   K4 bf16: persistent CTAs of two warpgroups over 128-row M tiles and a
//            Co chunk of up to 256 (X read once for Co <= 256), fed by
//            cp.async through a 3-4 stage ring of 128-byte swizzled tiles
//            and multiplied by wgmma (bf16 in, f32 accumulate); the
//            epilogue stores Y in 16-byte vectors from a staging tile and
//            keeps the column statistics in registers across tiles, so the
//            partial rows are one per CTA of a chunk (see the kernel).
//   K4 f32:  256 threads, a 128x64 output tile, an 8x4 register tile each,
//            f32 FMA on the CUDA cores (TF32 would lose the f32 parity),
//            the next 16-deep k tile loaded into registers while the
//            current one is multiplied. The TPU kept the whole (Ci, Co)
//            weight resident in VMEM; here the grid tiles Co as well. Rows
//            of x are addressed through (n, h, w) strides, so a stride-2
//            subsample of a channels-last x is read in place, without a
//            copy.
//   K3 dx:   K2's layout (below): per-channel terms in registers, four
//            rows of loads in flight a thread.
//
// Bound. K1-K3 do a few flops per element: they are bound by the bytes they
// move (x once for K1; x, dy, y for K3's reduce; those plus dx, dres for the
// dx pass). K4 does 2*Ci flops per output over 2*(Ci + Co) bytes per row in
// bf16: at Ci = 64..2048 that is 16..512 flops a byte, around the H100's ~295
// flop/byte tensor-core ridge, so the small-Ci convs are memory bound and the
// wide ones compute bound. Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;      // K1, K2, K3
constexpr int kMaxVecs = 32;       // channel vectors per CTA in K1/K3
constexpr int kConvBM = 128;       // K4 output rows per CTA (Python: _CONV_BM)
constexpr int kConvBN = 64;        // K4 output channels per CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as floats, and back.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  float v[N];
  __device__ __forceinline__ void load(const T* p) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(e[i]);
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// ---------------------------------------------------------------------------
// Shared: the fixed-order reduction of per-block partials.
// ---------------------------------------------------------------------------
// part_s, part_q: [nrows, C]. stats = 1: out_a = mean = s/m, out_b = var =
// max(q/m - mean^2, 0) (K1, K4); stats = 0: out_a = s, out_b = q (K3).
// Block (32, 32): thread (tx, ty) sums rows ty, ty+32, ... of channel
// 32*blockIdx.x + tx, then row ty == 0 sums the 32 partial sums in order.
__global__ void __launch_bounds__(1024)
finish_kernel(const float* __restrict__ part_s, const float* __restrict__ part_q,
              int nrows, int C, float m, int stats, float* __restrict__ out_a,
              float* __restrict__ out_b) {
  __shared__ float ss[32][33], sq[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f, q = 0.f;
  if (c < C) {
    for (int r = ty; r < nrows; r += 32) {
      s += part_s[(long long)r * C + c];
      q += part_q[(long long)r * C + c];
    }
  }
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  float S = 0.f, Q = 0.f;
  for (int i = 0; i < 32; ++i) {
    S += ss[i][tx];
    Q += sq[i][tx];
  }
  if (stats) {
    const float mean = S / m;
    out_a[c] = mean;
    out_b[c] = fmaxf(Q / m - mean * mean, 0.f);
  } else {
    out_a[c] = S;
    out_b[c] = Q;
  }
}

cudaError_t finish(const float* part_s, const float* part_q, int nrows, int C,
                   float m, int stats, float* a, float* b, cudaStream_t s) {
  finish_kernel<<<(C + 31) / 32, dim3(32, 32), 0, s>>>(part_s, part_q, nrows,
                                                       C, m, stats, a, b);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1 stats and K3 reduce: column sums over a block of rows.
// ---------------------------------------------------------------------------
// grid (channel chunks, nblocks). A chunk is V <= 32 channel vectors of
// Vec<T>::N channels. Thread (tx = tid % V, ty = tid / V) owns channel vector
// V*blockIdx.x + tx and walks rows r0 + ty, r0 + ty + R, ... (R = 256 / V) of
// its block; the R row lanes are then summed in order through shared memory
// and written as this block's partial row.
// BWD = false: s += x, q += x*x. BWD = true: g = dy (masked by y > 0 under
// RELU), xhat = (x - mean)*inv; s += g, q += g*xhat.
template <typename T, bool BWD, bool RELU>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const T* __restrict__ y, const float* __restrict__ mean,
              const float* __restrict__ inv, long long M, int C,
              long long rows_per_block, float* __restrict__ part_s,
              float* __restrict__ part_q) {
  constexpr int N = Vec<T>::N;
  __shared__ float red_s[kThreads * N], red_q[kThreads * N];
  const int nvec = C / N;
  const int V = nvec < kMaxVecs ? nvec : kMaxVecs;
  const int R = kThreads / V;
  const int tid = threadIdx.x;
  const int tx = tid % V, ty = tid / V;
  const int cv = blockIdx.x * V + tx;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, M);

  float s[N], q[N], mu[N], iv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = q[i] = mu[i] = iv[i] = 0.f;
  const bool active = ty < R && cv < nvec;
  if (active && BWD) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mu[i] = mean[cv * N + i];
      iv[i] = inv[cv * N + i];
    }
  }
  if (active) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += R) {
      const long long off = r * C + (long long)cv * N;
      Vec<T> a;
      a.load(x + off);
      if (!BWD) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s[i] += a.v[i];
          q[i] += a.v[i] * a.v[i];
        }
      } else {
        Vec<T> g;
        g.load(dy + off);
        if (RELU) {
          Vec<T> yv;
          yv.load(y + off);
#pragma unroll
          for (int i = 0; i < N; ++i) g.v[i] = yv.v[i] > 0.f ? g.v[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xhat = (a.v[i] - mu[i]) * iv[i];
          s[i] += g.v[i];
          q[i] += g.v[i] * xhat;
        }
      }
    }
  }
  // red[ty][tx*N + i]
  if (ty < R) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      red_s[ty * (V * N) + tx * N + i] = s[i];
      red_q[ty * (V * N) + tx * N + i] = q[i];
    }
  }
  __syncthreads();
  if (tid >= V * N) return;
  const int c = blockIdx.x * V * N + tid;
  if (c >= C) return;
  float S = 0.f, Q = 0.f;
  for (int r = 0; r < R; ++r) {
    S += red_s[r * (V * N) + tid];
    Q += red_q[r * (V * N) + tid];
  }
  part_s[(long long)blockIdx.y * C + c] = S;
  part_q[(long long)blockIdx.y * C + c] = Q;
}

template <typename T, bool BWD, bool RELU>
cudaError_t colsums(const void* x, const void* dy, const void* y,
                    const float* mean, const float* inv, long long M, int C,
                    int nblocks, float* part, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const int nvec = C / N;
  const int V = nvec < kMaxVecs ? nvec : kMaxVecs;
  const long long rpb = (M + nblocks - 1) / nblocks;
  dim3 grid((nvec + V - 1) / V, nblocks);
  colsum_kernel<T, BWD, RELU><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), mean, inv, M, C, rpb, part,
      part + (long long)nblocks * C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 apply: a pass at memory rate. A thread owns one 16-byte channel vector
// of a row for the whole CTA: it loads that vector's mean, isc and bias once
// (float4s) into registers and walks the CTA's rows at a fixed stride,
// kApplyUnroll rows' x (and residual) loads in flight before the math. The
// wrapper sizes the grid (fused_bn.py apply_geometry): block (vectors,
// rows a step), grid (row blocks, channel chunks), rows_per_cta each.
// ---------------------------------------------------------------------------
constexpr int kApplyUnroll = 4;  // Python: _APPLY_UNROLL

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
             T* __restrict__ y, const float* __restrict__ mean,
             const float* __restrict__ isc, const float* __restrict__ bias,
             long long M, int C, int rows_per_cta) {
  constexpr int N = Vec<T>::N;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * N;
  if (c0 >= C) return;  // the last chunk's spare lanes
  float mu[N], sc[N], bi[N];
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(mean + c0 + j));
    const float4 b = __ldg(reinterpret_cast<const float4*>(isc + c0 + j));
    const float4 c = __ldg(reinterpret_cast<const float4*>(bias + c0 + j));
    mu[j] = a.x; mu[j + 1] = a.y; mu[j + 2] = a.z; mu[j + 3] = a.w;
    sc[j] = b.x; sc[j + 1] = b.y; sc[j + 2] = b.z; sc[j + 3] = b.w;
    bi[j] = c.x; bi[j + 1] = c.y; bi[j + 2] = c.z; bi[j + 3] = c.w;
  }
  const long long r_end =
      min(M, (long long)(blockIdx.x + 1) * rows_per_cta);
  const int step = blockDim.y;
  for (long long r = (long long)blockIdx.x * rows_per_cta + threadIdx.y;
       r < r_end; r += kApplyUnroll * step) {
    uint4 xr[kApplyUnroll], rr[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const long long off = (r + u * step) * C + c0;
      if (r + u * step < r_end) {
        xr[u] = *reinterpret_cast<const uint4*>(x + off);
        if (RES) rr[u] = *reinterpret_cast<const uint4*>(res + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (r + u * step >= r_end) break;
      const T* xe = reinterpret_cast<const T*>(&xr[u]);
      const T* re = reinterpret_cast<const T*>(&rr[u]);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v = (to_f(xe[j]) - mu[j]) * sc[j] + bi[j];
        if (RES) v += to_f(re[j]);
        if (RELU) v = fmaxf(v, 0.f);
        oe[j] = from_f<T>(v);
      }
      *reinterpret_cast<uint4*>(y + (r + u * step) * C + c0) = out;
    }
  }
}

template <typename T, bool RES, bool RELU>
cudaError_t apply(const void* x, const void* res, void* y, const float* mean,
                  const float* isc, const float* bias, long long M, int C,
                  dim3 grid, dim3 block, int rows_per_cta, cudaStream_t s) {
  apply_kernel<T, RES, RELU><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y),
      mean, isc, bias, M, C, rows_per_cta);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 dx: K2's layout and geometry (fused_bn.py apply_geometry sizes both). A
// thread owns one 16-byte channel vector: it loads that vector's mean, inv,
// isc and the two per-channel terms dbeta/m and dgamma/m once (float4s)
// into registers, then walks the CTA's rows at a fixed stride with
// kApplyUnroll rows' dy and x (and y under relu) loads in flight, and
// writes dx (and dres = g).
// ---------------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src + j));
    dst[j] = a.x; dst[j + 1] = a.y; dst[j + 2] = a.z; dst[j + 3] = a.w;
  }
}

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const T* __restrict__ y, const float* __restrict__ mean,
              const float* __restrict__ inv, const float* __restrict__ isc,
              const float* __restrict__ dbeta, const float* __restrict__ dgamma,
              T* __restrict__ dx, T* __restrict__ dres, long long M, int C,
              float inv_m, int rows_per_cta) {
  constexpr int N = Vec<T>::N;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * N;
  if (c0 >= C) return;  // the last chunk's spare lanes
  float mu[N], iv[N], sc[N], db[N], dg[N];
  load_vec<N>(mu, mean + c0);
  load_vec<N>(iv, inv + c0);
  load_vec<N>(sc, isc + c0);
  load_vec<N>(db, dbeta + c0);
  load_vec<N>(dg, dgamma + c0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    db[j] *= inv_m;
    dg[j] *= inv_m;
  }
  const long long r_end =
      min(M, (long long)(blockIdx.x + 1) * rows_per_cta);
  const int step = blockDim.y;
  for (long long r = (long long)blockIdx.x * rows_per_cta + threadIdx.y;
       r < r_end; r += kApplyUnroll * step) {
    uint4 gr[kApplyUnroll], xr[kApplyUnroll], yr[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const long long off = (r + u * step) * C + c0;
      if (r + u * step < r_end) {
        gr[u] = *reinterpret_cast<const uint4*>(dy + off);
        xr[u] = *reinterpret_cast<const uint4*>(x + off);
        if (RELU) yr[u] = *reinterpret_cast<const uint4*>(y + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (r + u * step >= r_end) break;
      const long long off = (r + u * step) * C + c0;
      const T* ge = reinterpret_cast<const T*>(&gr[u]);
      const T* xe = reinterpret_cast<const T*>(&xr[u]);
      const T* ye = reinterpret_cast<const T*>(&yr[u]);
      uint4 out, gout;
      T* oe = reinterpret_cast<T*>(&out);
      T* go = reinterpret_cast<T*>(&gout);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float g = to_f(ge[j]);
        if (RELU) g = to_f(ye[j]) > 0.f ? g : 0.f;
        go[j] = from_f<T>(g);
        const float xhat = (to_f(xe[j]) - mu[j]) * iv[j];
        oe[j] = from_f<T>(sc[j] * (g - db[j] - xhat * dg[j]));
      }
      if (RES) *reinterpret_cast<uint4*>(dres + off) = gout;
      *reinterpret_cast<uint4*>(dx + off) = out;
    }
  }
}

template <typename T, bool RES, bool RELU>
cudaError_t bwd_dx(const void* dy, const void* x, const void* y,
                   const float* mean, const float* inv, const float* isc,
                   const float* dbeta, const float* dgamma, void* dx,
                   void* dres, long long M, int C, float inv_m, dim3 grid,
                   dim3 block, int rows_per_cta, cudaStream_t s) {
  bwd_dx_kernel<T, RES, RELU><<<grid, block, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(y), mean, inv, isc, dbeta, dgamma,
      static_cast<T*>(dx), static_cast<T*>(dres), M, C, inv_m, rows_per_cta);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: 1x1-conv GEMM with the statistics of the stored output.
// ---------------------------------------------------------------------------
struct ConvParams {
  const void* x;   // rows addressed as n*sN + h*sH + w*sW, channels contiguous
  const void* w;   // [Co, Ci] row-major
  void* y;         // [M, Co] row-major
  float* part_s;   // [mtiles, Co]
  float* part_q;
  int M, Hs, Ws, Ci, Co;
  long long sN, sH, sW;
};

__device__ __forceinline__ long long row_offset(const ConvParams& p, int m) {
  const int hw = p.Hs * p.Ws;
  const int n = m / hw, r = m - n * hw;
  const int h = r / p.Ws, w = r - h * p.Ws;
  return n * p.sN + h * p.sH + w * p.sW;
}

// K4 bf16 on Hopper. A CTA is two consumer warpgroups over a 128-row M tile
// (64 rows each) and a BN-column chunk of Co, BN = 64, 128 or 256 (the
// smallest that holds Co, so X is read once for Co <= 256). The CTAs are
// persistent: CTA b owns chunk b % nchunks and walks the M tiles b /
// nchunks, + per_chunk, ... in order (the CTAs of one M tile's chunks are
// neighbours, so above Co = 256 their reads of X meet in the L2). Its (tile,
// k step) pairs run as one sequence through a ring of shared-memory stages
// that cp.async keeps stages - 1 steps ahead of the products, across tile
// boundaries: X rows are addressed through (n, h, w) strides, so a stride-2
// subsample is read in place. A stage holds a [128][64] X tile and, unless
// the CTA's whole [BN][Ci] W chunk stays resident (WRES: loaded once, when
// it fits), a [BN][64] W tile; all K-major and 128-byte swizzled as wgmma
// reads them (hopper.cuh). The products are wgmma m64nBN (two n128 at BN =
// 256), bf16 in, f32 accumulate. The epilogue rounds to bf16 into a padded
// staging tile; then each thread owns one 16-byte column chunk and walks
// rows of it, storing 16-byte vectors of Y and summing the stored values and
// their squares in registers across all its tiles. The partial rows drop
// from one per M tile to one per CTA of a chunk.
constexpr int kK4Rows = 128;      // M tile
constexpr int kK4Threads = 256;   // two warpgroups
constexpr int kK4Smem = 232448;   // bytes a CTA may have (227 KB)

// The layout of a CTA at BN output columns, CTAS CTAs an SM and room for a
// resident W chunk of WMAX bytes (0: W streams through the ring). Where
// the resident W leaves room for fewer than three ring stages, the staging
// tile holds one warpgroup's 64 rows at a time (kHalf).
template <int BN, int CTAS, int WMAX>
struct K4Layout {
  static constexpr int kWN = BN >= 128 ? 128 : 64;  // wgmma N
  static constexpr int kNW = BN / kWN;              // wgmmas a k sub-step
  static constexpr int kA = kK4Rows * 128;          // bytes of a [128][64] tile
  static constexpr int kB = BN * 128;               // bytes of a [BN][64] tile
  static constexpr int kPitch = BN * 2 + 16;        // staging row, bytes
  static constexpr int kChunks = BN / 8;            // 16-byte chunks a row
  static constexpr int kRowLanes = kK4Threads / kChunks;
  static constexpr int kW = WMAX;
  static constexpr int kStage = kA + (WMAX ? 0 : kB);
  static constexpr bool kHalf =
      (kK4Smem / CTAS - 2048 - kW - kK4Rows * kPitch) / kStage < 3;
  static constexpr int kStagingRows = kHalf ? kK4Rows / 2 : kK4Rows;
  static constexpr int kStaging = kStagingRows * kPitch;
  // the rest of the CTA's share of the SM (less the 1 KB alignment and
  // the 1 KB reserve) in ring stages, at most 8
  static constexpr int kFit =
      (kK4Smem / CTAS - 2048 - kW - kStaging) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kW + kStages * kStage + kStaging + 1024;
  static_assert(kStages >= 2, "K4: no room for a ring");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct K4Walk {
  int nk, mtiles, nchunks, per_chunk;
};

// A position in a CTA's walk of (M tile, k block) steps, advanced one step
// at a time (no divisions in the loop).
struct K4Cursor {
  int mt, kb, slot;
  __device__ __forceinline__ void next(const K4Walk& w, int stages) {
    if (++kb == w.nk) {
      kb = 0;
      mt += w.per_chunk;
    }
    if (++slot == stages) slot = 0;
  }
};

template <int BN, int CTAS, int WMAX>
__global__ void __launch_bounds__(kK4Threads, CTAS)
conv_stats_bf16_kernel(ConvParams p, K4Walk walk) {
  using L = K4Layout<BN, CTAS, WMAX>;
  constexpr bool WRES = WMAX > 0;
  extern __shared__ unsigned char k4_smem_raw[];
  unsigned char* smem = hopper::smem_base(k4_smem_raw);
  // [resident W (WRES)] [stages] [staging]
  unsigned char* wres = smem;
  unsigned char* ring = smem + L::kW;
  unsigned char* staging = ring + L::kStages * L::kStage;
  const uint32_t ring_s = hopper::smem_u32(ring);

  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* Y = static_cast<__nv_bfloat16*>(p.y);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  const int nc = blockIdx.x % walk.nchunks, j0 = blockIdx.x / walk.nchunks;
  const int n0 = nc * BN;
  const int ntiles = j0 < walk.mtiles
      ? (walk.mtiles - 1 - j0) / walk.per_chunk + 1 : 0;
  const int total = ntiles * walk.nk;

  // the W tile of k block kb into `dst`
  auto load_w = [&](uint32_t dst, int kb) {
#pragma unroll
    for (int u = 0; u < BN * 8 / kK4Threads; ++u) {
      const int idx = tid + u * kK4Threads, r = idx / 8, c = idx % 8;
      const int n = n0 + r, k = kb * 64 + c * 8;
      const bool ok = n < p.Co && k < p.Ci;
      const __nv_bfloat16* src = ok ? W + (long long)n * p.Ci + k : W;
      cp_async16(dst + hopper::swz(r, c * 8), src, ok);
    }
  };
  // the X tile (and the W tile unless resident) of the step at `at`
  auto load = [&](const K4Cursor& at) {
    const uint32_t st = ring_s + at.slot * L::kStage;
#pragma unroll
    for (int u = 0; u < kK4Rows * 8 / kK4Threads; ++u) {
      const int idx = tid + u * kK4Threads, r = idx / 8, c = idx % 8;
      const int m = at.mt * kK4Rows + r, k = at.kb * 64 + c * 8;
      const bool ok = m < p.M && k < p.Ci;
      const __nv_bfloat16* src = ok ? X + row_offset(p, m) + k : X;
      cp_async16(st + hopper::swz(r, c * 8), src, ok);
    }
    if (!WRES) load_w(st + L::kA, at.kb);
  };

  float acc[L::kNW][L::kWN / 2];
  // the thread's column chunk of the staging tile and its statistics
  const int cc = tid % L::kChunks, rl = tid / L::kChunks;
  const bool col_ok = n0 + cc * 8 < p.Co;
  float cs[8], cq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] = cq[e] = 0.f;

  if (WRES) {  // the whole W chunk, in the first group
    for (int kb = 0; kb < walk.nk; ++kb)
      load_w(hopper::smem_u32(wres) + kb * L::kB, kb);
  }
  K4Cursor ld{j0, 0, 0}, at{j0, 0, 0};
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < total) load(ld);
    cp_async_commit();
    ld.next(walk, L::kStages);
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<L::kStages - 2>();
    // the stage's cp.async writes are seen by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + L::kStages - 1 < total) load(ld);
    cp_async_commit();
    ld.next(walk, L::kStages);

    const unsigned char* st = ring + at.slot * L::kStage;
    const unsigned char* a_tile = st + wg * (kK4Rows / 2) * 128;
    const unsigned char* b_tile = WRES ? wres + at.kb * L::kB : st + L::kA;
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = hopper::desc_kmajor(a_tile, ks);
#pragma unroll
      for (int jn = 0; jn < L::kNW; ++jn)
        hopper::mma_ss<L::kWN, 0>(
            acc[jn], da, hopper::desc_kmajor(b_tile + jn * L::kWN * 128, ks),
            (at.kb > 0 || ks > 0) ? 1 : 0);
    }
    hopper::wg_commit();
    hopper::wg_wait_all();
#pragma unroll
    for (int jn = 0; jn < L::kNW; ++jn) hopper::pin(acc[jn]);
    const int mt = at.mt;
    const bool tile_done = at.kb == walk.nk - 1;
    at.next(walk, L::kStages);
    if (!tile_done) continue;

    // epilogue of M tile mt, in one pass or one warpgroup's rows at a time
    // (kHalf): round into the staging tile (register 4·nb + 2h + e of lane
    // (g, t) of warp w: row 16w + g + 8h, column 8·nb + 2t + e of its
    // wgmma block)...
#pragma unroll
    for (int half = 0; half < (L::kHalf ? 2 : 1); ++half) {
      if (!L::kHalf || wg == half) {
        const int row0 = L::kHalf ? 0 : wg * 64;
#pragma unroll
        for (int jn = 0; jn < L::kNW; ++jn)
#pragma unroll
          for (int nb = 0; nb < L::kWN / 8; ++nb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + warp * 16 + g + 8 * h;
              const int col = jn * L::kWN + nb * 8 + 2 * t;
              *reinterpret_cast<uint32_t*>(staging + row * L::kPitch +
                                           col * 2) =
                  hopper::pack_bf16(acc[jn][4 * nb + 2 * h],
                                    acc[jn][4 * nb + 2 * h + 1]);
            }
      }
      __syncthreads();
      // ... then 16-byte stores of Y and the statistics of the stored
      // values
      for (int r = rl; r < L::kStagingRows; r += L::kRowLanes) {
        const int m = mt * kK4Rows + half * 64 + r;
        if (m >= p.M || !col_ok) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            staging + r * L::kPitch + cc * 16);
        *reinterpret_cast<uint4*>(Y + (long long)m * p.Co + n0 + cc * 8) =
            v;
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          cs[2 * e] += f.x;
          cq[2 * e] += f.x * f.x;
          cs[2 * e + 1] += f.y;
          cq[2 * e + 1] += f.y * f.y;
        }
      }
      if (L::kHalf) __syncthreads();  // the rows are read before reuse
    }
  }
  cp_async_wait<0>();

  // the CTA's partial row: the row lanes of each column summed in order
  __syncthreads();
  float* red = reinterpret_cast<float*>(staging);  // [2][row lanes][BN]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[rl * BN + cc * 8 + e] = cs[e];
    red[(L::kRowLanes + rl) * BN + cc * 8 + e] = cq[e];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < p.Co) {
    float S = 0.f, Q = 0.f;
    for (int r = 0; r < L::kRowLanes; ++r) {
      S += red[r * BN + tid];
      Q += red[(L::kRowLanes + r) * BN + tid];
    }
    p.part_s[(long long)j0 * p.Co + n0 + tid] = S;
    p.part_q[(long long)j0 * p.Co + n0 + tid] = Q;
  }
}

template <int BN, int CTAS, int WMAX>
cudaError_t launch_conv_bf16(const ConvParams& p, const K4Walk& walk,
                             cudaStream_t s) {
  using L = K4Layout<BN, CTAS, WMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_stats_bf16_kernel<BN, CTAS, WMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  conv_stats_bf16_kernel<BN, CTAS, WMAX>
      <<<walk.per_chunk * walk.nchunks, kK4Threads, L::kSmem, s>>>(p, walk);
  return cudaGetLastError();
}

// Launches K4 bf16: BN the smallest of 64, 128, 256 that holds Co (256 for
// a wider Co, in chunks), the card's CTA slots (2 an SM at BN = 64, else 1)
// split evenly over the chunks and at most one CTA per M tile; the W chunk
// resident when it fits in 32 KB (or, at one CTA an SM, 128 KB), else
// streamed through the ring. Returns the partial rows it writes in *rows.
cudaError_t launch_conv_bf16(const ConvParams& p, int sms, int* rows,
                             cudaStream_t s) {
  const int bn = p.Co <= 64 ? 64 : p.Co <= 128 ? 128 : 256;
  K4Walk walk;
  walk.nk = (p.Ci + 63) / 64;
  walk.mtiles = (p.M + kK4Rows - 1) / kK4Rows;
  walk.nchunks = (p.Co + bn - 1) / bn;
  walk.per_chunk = sms * (bn == 64 ? 2 : 1) / walk.nchunks;
  walk.per_chunk = walk.per_chunk < 1 ? 1 : walk.per_chunk;
  walk.per_chunk =
      walk.per_chunk > walk.mtiles ? walk.mtiles : walk.per_chunk;
  *rows = walk.per_chunk;
  const int w_bytes = walk.nk * bn * 128;
  constexpr int kSmall = 32 * 1024, kBig = 128 * 1024;
#define K4_LAUNCH(BN, CTAS, WBIG)                                         \
  return w_bytes <= kSmall ? launch_conv_bf16<BN, CTAS, kSmall>(p, walk, s) \
       : w_bytes <= WBIG   ? launch_conv_bf16<BN, CTAS, WBIG>(p, walk, s)   \
                           : launch_conv_bf16<BN, CTAS, 0>(p, walk, s)
  if (bn == 64) K4_LAUNCH(64, 2, kSmall);
  if (bn == 128) K4_LAUNCH(128, 1, kBig);
  K4_LAUNCH(256, 1, kBig);
#undef K4_LAUNCH
}

constexpr int kBK32 = 16;  // f32 k step

__global__ void __launch_bounds__(256)
conv_stats_f32_kernel(ConvParams p) {
  __shared__ __align__(16) float sA[kBK32][kConvBM + 4];  // k-major
  __shared__ __align__(16) float sB[kBK32][kConvBN + 4];
  __shared__ float red_s[16][kConvBN], red_q[16][kConvBN];

  const float* X = static_cast<const float*>(p.x);
  const float* W = static_cast<const float*>(p.w);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kConvBM, n0 = blockIdx.y * kConvBN;

  // A: 128 rows x 16 k = 512 float4, two a thread; B: 64 x 16 = 256, one.
  long long a_off[2];
  bool a_ok[2];
  int a_row[2], a_kv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + 256 * j;
    a_row[j] = i / 4;
    a_kv[j] = (i % 4) * 4;
    const int m = m0 + a_row[j];
    a_ok[j] = m < p.M;
    a_off[j] = a_ok[j] ? row_offset(p, m) : 0;
  }
  const int b_row = tid / 4, b_kv = (tid % 4) * 4;

  float4 ra[2], rb;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + a_kv[j];
      ra[j] = (a_ok[j] && k < p.Ci)
          ? *reinterpret_cast<const float4*>(X + a_off[j] + k)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int n = n0 + b_row, k = k0 + b_kv;
    rb = (n < p.Co && k < p.Ci)
        ? *reinterpret_cast<const float4*>(W + (long long)n * p.Ci + k)
        : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sA[a_kv[j] + 0][a_row[j]] = ra[j].x;
      sA[a_kv[j] + 1][a_row[j]] = ra[j].y;
      sA[a_kv[j] + 2][a_row[j]] = ra[j].z;
      sA[a_kv[j] + 3][a_row[j]] = ra[j].w;
    }
    sB[b_kv + 0][b_row] = rb.x;
    sB[b_kv + 1][b_row] = rb.y;
    sB[b_kv + 2][b_row] = rb.z;
    sB[b_kv + 3][b_row] = rb.w;
  };

  // rows ty + 16*i, columns tx + 16*j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (p.Ci + kBK32 - 1) / kBK32;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) * kBK32);
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store_tile();
      __syncthreads();
    }
  }

  float* Y = static_cast<float*>(p.y);
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, cq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.Co) continue;
      const float v = acc[i][j];
      Y[(long long)m * p.Co + n] = v;
      cs[j] += v;
      cq[j] += v * v;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty][tx + 16 * j] = cs[j];
    red_q[ty][tx + 16 * j] = cq[j];
  }
  __syncthreads();
  if (tid < kConvBN && n0 + tid < p.Co) {
    float S = 0.f, Q = 0.f;
    for (int r = 0; r < 16; ++r) {
      S += red_s[r][tid];
      Q += red_q[r][tid];
    }
    p.part_s[(long long)blockIdx.x * p.Co + n0 + tid] = S;
    p.part_q[(long long)blockIdx.x * p.Co + n0 + tid] = Q;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. (M, C) tensors are row-major and
// contiguous; C is a multiple of 16 bytes' worth of elements. `part` is
// scratch of 2*nblocks*C floats. Each function returns a cudaError_t
// (0 = launched).

int fused_bn_stats(const void* x, long long M, int C, int dtype, int nblocks,
                   float* part, float* mean, float* var, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? colsums<float, false, false>(x, nullptr, nullptr, nullptr,
                                                nullptr, M, C, nblocks, part, s)
                 : colsums<__nv_bfloat16, false, false>(
                       x, nullptr, nullptr, nullptr, nullptr, M, C, nblocks,
                       part, s);
  if (err != cudaSuccess) return err;
  return finish(part, part + (long long)nblocks * C, nblocks, C, (float)M, 1,
                mean, var, s);
}

// K2's launch geometry comes from the wrapper (apply_geometry): a grid of
// (row blocks, channel chunks) CTAs of (vectors, rows a step) threads, each
// CTA over rows_per_cta rows. mean, isc and bias are 16-byte aligned.
int fused_bn_apply(const void* x, const void* res, void* y, const float* mean,
                   const float* isc, const float* bias, long long M, int C,
                   int relu, int dtype, int row_blocks, int chunks,
                   int vectors, int rows_step, int rows_per_cta,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (res != nullptr) * 2 + (relu != 0);
  const dim3 grid(row_blocks, chunks), block(vectors, rows_step);
#define APPLY(T)                                                             \
  switch (variant) {                                                         \
    case 0: return apply<T, false, false>(x, res, y, mean, isc, bias, M, C,  \
                                          grid, block, rows_per_cta, s);     \
    case 1: return apply<T, false, true>(x, res, y, mean, isc, bias, M, C,   \
                                         grid, block, rows_per_cta, s);      \
    case 2: return apply<T, true, false>(x, res, y, mean, isc, bias, M, C,   \
                                         grid, block, rows_per_cta, s);      \
    default: return apply<T, true, true>(x, res, y, mean, isc, bias, M, C,   \
                                         grid, block, rows_per_cta, s);      \
  }
  if (dtype == 0) { APPLY(float) }
  APPLY(__nv_bfloat16)
#undef APPLY
}

int fused_bn_bwd_reduce(const void* dy, const void* x, const void* y,
                        const float* mean, const float* inv, long long M, int C,
                        int relu, int dtype, int nblocks, float* part,
                        float* dbeta, float* dgamma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = relu ? colsums<float, true, true>(x, dy, y, mean, inv, M, C, nblocks,
                                            part, s)
               : colsums<float, true, false>(x, dy, y, mean, inv, M, C,
                                             nblocks, part, s);
  else
    err = relu ? colsums<__nv_bfloat16, true, true>(x, dy, y, mean, inv, M, C,
                                                    nblocks, part, s)
               : colsums<__nv_bfloat16, true, false>(x, dy, y, mean, inv, M, C,
                                                     nblocks, part, s);
  if (err != cudaSuccess) return err;
  return finish(part, part + (long long)nblocks * C, nblocks, C, (float)M, 0,
                dbeta, dgamma, s);
}

// K3's dx pass takes K2's launch geometry (apply_geometry); mean, inv, isc,
// dbeta and dgamma are 16-byte aligned.
int fused_bn_bwd_dx(const void* dy, const void* x, const void* y,
                    const float* mean, const float* inv, const float* isc,
                    const float* dbeta, const float* dgamma, void* dx,
                    void* dres, long long M, int C, int relu, float inv_m,
                    int dtype, int row_blocks, int chunks, int vectors,
                    int rows_step, int rows_per_cta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (dres != nullptr) * 2 + (relu != 0);
  const dim3 grid(row_blocks, chunks), block(vectors, rows_step);
#define BWD_DX(T)                                                             \
  switch (variant) {                                                          \
    case 0: return bwd_dx<T, false, false>(dy, x, y, mean, inv, isc, dbeta,   \
                                           dgamma, dx, dres, M, C, inv_m,     \
                                           grid, block, rows_per_cta, s);     \
    case 1: return bwd_dx<T, false, true>(dy, x, y, mean, inv, isc, dbeta,    \
                                          dgamma, dx, dres, M, C, inv_m,      \
                                          grid, block, rows_per_cta, s);      \
    case 2: return bwd_dx<T, true, false>(dy, x, y, mean, inv, isc, dbeta,    \
                                          dgamma, dx, dres, M, C, inv_m,      \
                                          grid, block, rows_per_cta, s);      \
    default: return bwd_dx<T, true, true>(dy, x, y, mean, inv, isc, dbeta,    \
                                          dgamma, dx, dres, M, C, inv_m,      \
                                          grid, block, rows_per_cta, s);      \
  }
  if (dtype == 0) { BWD_DX(float) }
  BWD_DX(__nv_bfloat16)
#undef BWD_DX
}

// x rows: n*sN + h*sH + w*sW for output position (n, h, w) of an N x Hs x Ws
// grid (a stride-2 subsample is passed as its strided view); w is [Co, Ci].
// y is [M, Co]; `part` is scratch of 2*ceil(M/128)*Co floats. Co is even in
// f32 and a multiple of 8 in bf16 (16-byte stores of Y).
int fused_conv_stats(const void* x, const void* w, void* y, int N, int Hs,
                     int Ws, long long sN, long long sH, long long sW, int Ci,
                     int Co, int dtype, float* part, float* mean, float* var,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ConvParams p;
  p.x = x; p.w = w; p.y = y;
  p.M = N * Hs * Ws; p.Hs = Hs; p.Ws = Ws; p.Ci = Ci; p.Co = Co;
  p.sN = sN; p.sH = sH; p.sW = sW;
  const int mtiles = (p.M + kConvBM - 1) / kConvBM;
  p.part_s = part;
  p.part_q = part + (long long)mtiles * Co;
  cudaError_t err;
  int rows = mtiles;  // partial rows written
  if (Co % (dtype == 0 ? 2 : 8)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    dim3 grid(mtiles, (Co + kConvBN - 1) / kConvBN);
    conv_stats_f32_kernel<<<grid, 256, 0, s>>>(p);
    err = cudaGetLastError();
  } else {
    int dev, sms;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    err = launch_conv_bf16(p, sms, &rows, s);
  }
  if (err != cudaSuccess) return err;
  return finish(p.part_s, p.part_q, rows, Co, (float)p.M, 1, mean, var, s);
}

const char* fused_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
