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
//   K4 f32:  the bf16 walk with 64-wide Co chunks, the products in
//            3xTF32 on wgmma (tf32x3.cuh: one TF32 product would lose the
//            f32 parity, three keep it) in 16-deep partial sums, X (and W
//            where it does not stay resident) by cp.async, W split once
//            into TF32 big and small parts, Y stored in 16-byte vectors
//            from the registers (see the kernel). Rows of x are addressed
//            through (n, h, w) strides, so a stride-2 subsample of a
//            channels-last x is read in place, without a copy.
//   K3 dx:   K2's layout (below): per-channel terms in registers, four
//            rows of loads in flight a thread.
//
// Bound. K1-K3 do a few flops per element: they are bound by the bytes they
// move (x once for K1; x, dy, y for K3's reduce; those plus dx, dres for the
// dx pass). K4 does 2*Ci flops per output over 2*(Ci + Co) bytes per row in
// bf16: at Ci = 64..2048 that is 16..512 flops a byte, around the H100's ~295
// flop/byte tensor-core ridge, so the small-Ci convs are memory bound and the
// wide ones compute bound. In f32 (3xTF32: three TF32 products at 495
// TFLOP/s per product, a ~49 flop/byte ridge, 4 bytes a value) the same
// convs give 8..256 flops a byte: stage 1's .a (256 -> 64) is bound by its
// bytes, stage 4's by its operations. Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kThreads = 256;      // K1, K2, K3
constexpr int kMaxVecs = 32;       // channel vectors per CTA in K1/K3
constexpr int kConvBM = 128;       // K4 output rows per CTA (Python: _CONV_BM)

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

// K4 f32 on Hopper: the bf16 walk (persistent CTAs over 128-row M tiles of
// a Co chunk, the statistics in registers across tiles, one partial row a
// CTA) with the products in 3xTF32 on wgmma (tf32x3.cuh). A CTA is two
// warpgroups, 64 rows of the tile each, over a 64-wide Co chunk, one CTA
// an SM. X and W are both K-major (Ci contiguous), as tf32 wgmma reads
// them. X tiles of 32 Ci values arrive by cp.async through (n, h, w)
// strides (a stride-2 subsample is read in place) into a ring of stages;
// each warp takes its A fragments from them by ldmatrix and splits them
// in registers (wgmma's A operand from registers). W is split once into
// big and small boxes, 128-byte swizzled as wgmma's B operand: the whole
// chunk when it fits (Ci <= 256, split at the start), else a [64][32] tile
// a step that streams through the ring beside X and is split, a step ahead
// of its products, into one of three box pairs. Each 16-deep partial sum
// (Ci runs to 2048, and the tensor core's sums round toward zero) is six
// wgmmas into a zeroed register block; two blocks take turns, so one
// partial sum is added to the accumulator while the next is in flight.
// (mma.sync in the flash kernels' way, two CTAs an SM of 32x32 warp tiles,
// measured 1.1-1.5x slower at every ResNet-50 shape: see PERF.md.) W's rows are stored in the
// boxes with the output columns paired (blocks 2j and 2j + 1 are columns
// 16j + 2c and 16j + 2c + 1), so a lane holds four adjacent columns of each
// of its rows and stores them as one 16-byte vector (two 8-byte ones at a
// Co that is no multiple of 4), straight from the registers: a staging
// tile would add nothing to the stores and take shared memory from the
// ring. The statistics are of these stored values.
constexpr int kK4F32BN = 64;                       // Co chunk
constexpr int kK4F32KB = 32;                       // Ci values a stage
constexpr int kK4F32Pitch = kK4F32KB + 4;          // floats a staged row
constexpr int kK4F32X = kK4Rows * kK4F32Pitch;     // floats of an X tile
constexpr int kK4F32W = kK4F32BN * kK4F32Pitch;    // of a streamed W tile
constexpr int kK4F32Box = kK4F32BN * 128;          // bytes of a [64][32] box
constexpr int kK4F32WresMax = 8;                   // k blocks: Ci <= 256

// Bytes of the layout: [W boxes: big then small, resident or three pairs]
// [ring stages] (+ 1 KB of alignment for the swizzle).
template <bool WRES>
struct K4F32Layout {
  static constexpr int kW = 2 * kK4F32Box * (WRES ? kK4F32WresMax : 3);
  static constexpr int kStage = 4 * (kK4F32X + (WRES ? 0 : kK4F32W));
  static constexpr int kStages = WRES ? 5 : 6;
  static constexpr int kSmem = kW + kStages * kStage + 1024;
  static_assert(kSmem <= kK4Smem, "K4 f32: the layout does not fit");
};

// Row of W's output column o (0..63 of a chunk) in a box: block 2j + o % 2,
// column (o % 16) / 2 of it, j = o / 16.
__device__ __forceinline__ int k4_box_row(int o) {
  return 8 * (2 * (o >> 4) + (o & 1)) + ((o & 15) >> 1);
}

// Splits 4 adjacent values of W's row o at chunk c4 of a 32-deep k block
// into the big and small boxes.
__device__ __forceinline__ void k4_split_w(unsigned char* big,
                                           unsigned char* small, int o,
                                           int c4, float4 w) {
  uint32_t b[4], s[4];
  tf32x3::split_tf32(w.x, b[0], s[0]);
  tf32x3::split_tf32(w.y, b[1], s[1]);
  tf32x3::split_tf32(w.z, b[2], s[2]);
  tf32x3::split_tf32(w.w, b[3], s[3]);
  const uint32_t off = tf32x3::swz_tf32(k4_box_row(o), c4);
  *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(small + off) = make_uint4(s[0], s[1], s[2], s[3]);
}

template <bool WRES>
__global__ void __launch_bounds__(kK4Threads, 1)
conv_stats_f32_kernel(ConvParams p, K4Walk walk) {
  using L = K4F32Layout<WRES>;
  using namespace tf32x3;
  extern __shared__ unsigned char k4f_smem_raw[];
  unsigned char* smem = hopper::smem_base(k4f_smem_raw);
  unsigned char* wbig = smem;  // resident: box kb at kb · kK4F32Box
  unsigned char* wsmall = smem + L::kW / 2;
  float* ring = reinterpret_cast<float*>(smem + L::kW);

  const float* X = static_cast<const float*>(p.x);
  const float* W = static_cast<const float*>(p.w);
  float* Y = static_cast<float*>(p.y);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nc = blockIdx.x % walk.nchunks, j0 = blockIdx.x / walk.nchunks;
  const int n0 = nc * kK4F32BN;
  const int ntiles = j0 < walk.mtiles
      ? (walk.mtiles - 1 - j0) / walk.per_chunk + 1 : 0;
  const int total = ntiles * walk.nk;

  // the thread's four X rows of a tile (tid / 8 + 32u), located once a tile
  long long xoff[4];
  bool xok[4];
  // the X tile (and the raw W tile unless resident) of the step at `at`
  auto load = [&](const K4Cursor& at) {
    if (at.kb == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = at.mt * kK4Rows + tid / 8 + 32 * u;
        xok[u] = m < p.M;
        xoff[u] = xok[u] ? row_offset(p, m) : 0;
      }
    }
    float* st = ring + at.slot * (L::kStage / 4);
    const int c = tid % 8 * 4, k = at.kb * kK4F32KB + c;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = xok[u] && k < p.Ci;
      cp_async16(st + (tid / 8 + 32 * u) * kK4F32Pitch + c,
                 ok ? X + xoff[u] + k : X, ok);
    }
    if (!WRES) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = tid / 8 + 32 * u, n = n0 + r;
        const bool ok = n < p.Co && k < p.Ci;
        cp_async16(st + kK4F32X + r * kK4F32Pitch + c,
                   ok ? W + (long long)n * p.Ci + k : W, ok);
      }
    }
  };

  if (WRES) {  // the whole W chunk, split once
    for (int i = tid; i < walk.nk * kK4F32BN * 8; i += kK4Threads) {
      const int kb = i / (kK4F32BN * 8), o = i / 8 % kK4F32BN, c4 = i % 8;
      const int n = n0 + o, k = kb * kK4F32KB + c4 * 4;
      const float4 w = n < p.Co && k < p.Ci
          ? *reinterpret_cast<const float4*>(W + (long long)n * p.Ci + k)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      k4_split_w(wbig + kb * kK4F32Box, wsmall + kb * kK4F32Box, o, c4, w);
    }
    // the boxes are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  K4Cursor ld{j0, 0, 0}, at{j0, 0, 0};
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < total) load(ld);
    cp_async_commit();
    ld.next(walk, L::kStages);
  }

  float acc[32], ps[2][32];
  uint32_t ab[2][2][4], as[2][2][4];  // [partial][k step] A fragments
  float cs[16], cq[16];  // column sums of the stored values: 16j + 4t + e
#pragma unroll
  for (int e = 0; e < 16; ++e) cs[e] = cq[e] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int arow = 64 * wg + 16 * warp;  // the warp's 16 rows of the tile
  // streamed W: the raw tile of step j (ring slot `slot`) split into box
  // pair j % 3, read by wgmma after the next barrier
  auto split_step = [&](int j, int slot) {
    const float* wr = ring + slot * (L::kStage / 4) + kK4F32X;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kK4Threads, o = i / 8, c4 = i % 8;
      k4_split_w(wbig + j % 3 * kK4F32Box, wsmall + j % 3 * kK4F32Box, o,
                 c4, *reinterpret_cast<const float4*>(wr + o * kK4F32Pitch +
                                                      c4 * 4));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  for (int s = 0; s < total; ++s) {
    // the step's tiles have landed (streamed W: the next step's too), and
    // the oldest slot is free
    cp_async_wait<WRES ? L::kStages - 2 : L::kStages - 3>();
    __syncthreads();
    if (!WRES && s == 0) {
      split_step(0, 0);
      __syncthreads();
    }
    if (s + L::kStages - 1 < total) load(ld);
    cp_async_commit();
    ld.next(walk, L::kStages);

    const float* xs = ring + at.slot * (L::kStage / 4);
    const int box = WRES ? at.kb : s % 3;
    const unsigned char* bbig = wbig + box * kK4F32Box;
    const unsigned char* bsmall = wsmall + box * kK4F32Box;

    // two 16-deep partial sums, in blocks 0 and 1 of ps, each added to acc
    // while the next is in flight (the other block's wgmmas have finished
    // once one group is left)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_a(xs, kK4F32Pitch, arow, 16 * h + 8 * ks, lane, ab[h][ks],
               as[h][ks]);
      hopper::pin(ab[h]);
      hopper::pin(as[h]);
      hopper::wg_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int step = 2 * h + ks;  // 8-deep step of the box
        const uint64_t db = hopper::desc_kmajor(bbig, step);
        wgmma_tf32_n64(ps[h], ab[h][ks], hopper::desc_kmajor(bsmall, step),
                       ks);
        wgmma_tf32_n64(ps[h], as[h][ks], db, 1);
        wgmma_tf32_n64(ps[h], ab[h][ks], db, 1);
      }
      hopper::wg_commit();
      if (s > 0 || h > 0) {  // the partial sum before this one
        wg_wait<1>();
        // its registers stay untouched until here (wgmma reads them late)
        hopper::pin(ps[h ^ 1]);
        hopper::pin(ab[h ^ 1]);
        hopper::pin(as[h ^ 1]);
        if (!(h == 0 && at.kb == 0)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += ps[h ^ 1][i];
        }
      }
    }
    // streamed W: the next step's tile, split while these products run
    // (its box pair was last read two steps ago, which both warpgroups
    // finished before this step's barrier)
    if (!WRES && s + 1 < total)
      split_step(s + 1, at.slot + 1 == L::kStages ? 0 : at.slot + 1);
    const int mt = at.mt;
    const bool tile_done = at.kb == walk.nk - 1;
    at.next(walk, L::kStages);
    if (!tile_done) continue;

    // epilogue of M tile mt: the last partial sum, then the lane's four
    // adjacent columns of each of its rows, stored and summed (rows past M
    // are X's zero fill: they add 0 to the sums)
    wg_wait<0>();
    hopper::pin(ps[1]);
    hopper::pin(ab[1]);
    hopper::pin(as[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += ps[1][i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * kK4Rows + arow + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* a = acc + 8 * j + 2 * h;
        const float v[4] = {a[0], a[4], a[1], a[5]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cs[4 * j + e] += v[e];
          cq[4 * j + e] += v[e] * v[e];
        }
        const int col = n0 + 16 * j + 4 * t;
        if (m >= p.M || col >= p.Co) continue;
        float* dst = Y + (long long)m * p.Co + col;
        if (p.Co % 4 == 0) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          if (col + 2 < p.Co)
            *reinterpret_cast<float2*>(dst + 2) = make_float2(v[2], v[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }
  cp_async_wait<0>();

  // the CTA's partial row: the 8 row lanes of a warp summed by a fixed
  // butterfly, then the eight row warps of each column in order
#pragma unroll
  for (int e = 0; e < 16; ++e)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], off);
      cq[e] += __shfl_xor_sync(0xffffffffu, cq[e], off);
    }
  __syncthreads();
  float* red = ring;  // [2][8 row warps][64 columns]
  const int rw = tid / 32;
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = 16 * (e / 4) + 4 * t + e % 4;
      red[rw * kK4F32BN + col] = cs[e];
      red[(8 + rw) * kK4F32BN + col] = cq[e];
    }
  }
  __syncthreads();
  if (tid < kK4F32BN && n0 + tid < p.Co) {
    float S = 0.f, Q = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      S += red[r * kK4F32BN + tid];
      Q += red[(8 + r) * kK4F32BN + tid];
    }
    p.part_s[(long long)j0 * p.Co + n0 + tid] = S;
    p.part_q[(long long)j0 * p.Co + n0 + tid] = Q;
  }
}

template <bool WRES>
cudaError_t launch_conv_f32(const ConvParams& p, const K4Walk& walk,
                            cudaStream_t s) {
  using L = K4F32Layout<WRES>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_stats_f32_kernel<WRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  conv_stats_f32_kernel<WRES>
      <<<walk.per_chunk * walk.nchunks, kK4Threads, L::kSmem, s>>>(p, walk);
  return cudaGetLastError();
}

// Launches K4 f32: 64-wide Co chunks, the card's SMs (one CTA each) split
// evenly over the chunks and at most one CTA per M tile; W resident up to
// Ci = 256. Returns the partial rows it writes in *rows.
cudaError_t launch_conv_f32(const ConvParams& p, int sms, int* rows,
                            cudaStream_t s) {
  K4Walk walk;
  walk.nk = (p.Ci + kK4F32KB - 1) / kK4F32KB;
  walk.mtiles = (p.M + kK4Rows - 1) / kK4Rows;
  walk.nchunks = (p.Co + kK4F32BN - 1) / kK4F32BN;
  walk.per_chunk = sms / walk.nchunks;
  walk.per_chunk = walk.per_chunk < 1 ? 1 : walk.per_chunk;
  walk.per_chunk =
      walk.per_chunk > walk.mtiles ? walk.mtiles : walk.per_chunk;
  *rows = walk.per_chunk;
  return walk.nk <= kK4F32WresMax ? launch_conv_f32<true>(p, walk, s)
                                  : launch_conv_f32<false>(p, walk, s);
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
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = dtype == 0 ? launch_conv_f32(p, sms, &rows, s)
                   : launch_conv_bf16(p, sms, &rows, s);
  if (err != cudaSuccess) return err;
  return finish(p.part_s, p.part_q, rows, Co, (float)p.M, 1, mean, var, s);
}

const char* fused_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
