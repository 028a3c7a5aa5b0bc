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
//   K4 bf16: 4 warps, a 128x64 output tile, 32-deep k steps staged in shared
//            memory, mma.sync.m16n8k16 (bf16 in, f32 accumulate); the next
//            k tile is loaded into registers while the current one is
//            multiplied. f32: 256 threads, the same tile, an 8x4 register
//            tile each, f32 FMA on the CUDA cores (TF32 would lose the f32
//            parity). The TPU kept the whole (Ci, Co) weight resident in VMEM;
//            here the grid tiles Co as well. Rows of x are addressed through
//            (n, h, w) strides, so a stride-2 subsample of a channels-last x
//            is read in place, without a copy.
//
// Bound. K1-K3 do a few flops per element: they are bound by the bytes they
// move (x once for K1; x, dy, y for K3's reduce; those plus dx, dres for the
// dx pass). K4 does 2*Ci flops per output over 2*(Ci + Co) bytes per row in
// bf16: at Ci = 64..2048 that is 16..512 flops a byte, around the H100's ~295
// flop/byte tensor-core ridge, so the small-Ci convs are memory bound and the
// wide ones compute bound. This first version uses mma.sync, not wgmma/TMA,
// and no multi-stage pipeline; its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// K3 dx: elementwise over 16-byte vectors of one row, grid-stride.
// ---------------------------------------------------------------------------
int grid_for(long long nvec) {
  long long blocks = (nvec + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);  // grid-stride beyond
}

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const T* __restrict__ y, const float* __restrict__ mean,
              const float* __restrict__ inv, const float* __restrict__ isc,
              const float* __restrict__ dbeta, const float* __restrict__ dgamma,
              T* __restrict__ dx, T* __restrict__ dres, long long nvec, int C,
              float inv_m) {
  constexpr int N = Vec<T>::N;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    const long long off = i * N;
    const int c0 = (int)(off % C);
    Vec<T> g, a;
    g.load(dy + off);
    a.load(x + off);
    if (RELU) {
      Vec<T> yv;
      yv.load(y + off);
#pragma unroll
      for (int j = 0; j < N; ++j) g.v[j] = yv.v[j] > 0.f ? g.v[j] : 0.f;
    }
    if (RES) g.store(dres + off);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = c0 + j;
      const float xhat = (a.v[j] - __ldg(mean + c)) * __ldg(inv + c);
      a.v[j] = __ldg(isc + c) * (g.v[j] - __ldg(dbeta + c) * inv_m -
                                 xhat * (__ldg(dgamma + c) * inv_m));
    }
    a.store(dx + off);
  }
}

template <typename T, bool RES, bool RELU>
cudaError_t bwd_dx(const void* dy, const void* x, const void* y,
                   const float* mean, const float* inv, const float* isc,
                   const float* dbeta, const float* dgamma, void* dx,
                   void* dres, long long M, int C, float inv_m,
                   cudaStream_t s) {
  const long long nvec = M * C / Vec<T>::N;
  bwd_dx_kernel<T, RES, RELU><<<grid_for(nvec), kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(y), mean, inv, isc, dbeta, dgamma,
      static_cast<T*>(dx), static_cast<T*>(dres), nvec, C, inv_m);
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

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Column sums of a warp's fragment rows, reduced over the 8 lanes that hold
// the same columns (the mma group id g = lane / 4).
__device__ __forceinline__ float sum_over_groups(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

constexpr int kBK16 = 32;           // bf16 k step
constexpr int kPitch16 = kBK16 + 8; // smem row pitch (elements): conflict-free

__global__ void __launch_bounds__(128)
conv_stats_bf16_kernel(ConvParams p) {
  __shared__ __align__(16) __nv_bfloat16 sA[kConvBM * kPitch16];
  __shared__ __align__(16) __nv_bfloat16 sB[kConvBN * kPitch16];
  __shared__ float red_s[4][kConvBN], red_q[4][kConvBN];

  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(p.w);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * kConvBM, n0 = blockIdx.y * kConvBN;

  // this thread's A rows (4 vectors of 8 channels a k tile) and B rows (2)
  long long a_off[4];
  bool a_ok[4];
  int a_row[4], a_kv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = tid + 128 * j;
    a_row[j] = i / 4;
    a_kv[j] = (i % 4) * 8;
    const int m = m0 + a_row[j];
    a_ok[j] = m < p.M;
    a_off[j] = a_ok[j] ? row_offset(p, m) : 0;
  }
  int b_row[2], b_kv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + 128 * j;
    b_row[j] = i / 4;
    b_kv[j] = (i % 4) * 8;
  }

  uint4 ra[4], rb[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_kv[j];
      ra[j] = (a_ok[j] && k < p.Ci)
          ? *reinterpret_cast<const uint4*>(X + a_off[j] + k)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + b_row[j], k = k0 + b_kv[j];
      rb[j] = (n < p.Co && k < p.Ci)
          ? *reinterpret_cast<const uint4*>(W + (long long)n * p.Ci + k)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(sA + a_row[j] * kPitch16 + a_kv[j]) = ra[j];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint4*>(sB + b_row[j] * kPitch16 + b_kv[j]) = rb[j];
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = (p.Ci + kBK16 - 1) / kBK16;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) * kBK16);
#pragma unroll
    for (int ks = 0; ks < kBK16 / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* base =
            sA + (warp * 32 + mt * 16 + g) * kPitch16 + ks * 16 + tig * 2;
        a[mt][0] = ld_u32(base);
        a[mt][1] = ld_u32(base + 8 * kPitch16);
        a[mt][2] = ld_u32(base + 8);
        a[mt][3] = ld_u32(base + 8 * kPitch16 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* brow = sB + (nt * 8 + g) * kPitch16 + ks * 16 +
                                    tig * 2;
        const uint32_t b0 = ld_u32(brow), b1 = ld_u32(brow + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store_tile();
      __syncthreads();
    }
  }

  // epilogue: round, store, and take the statistics of the rounded values.
  // Element e of acc[mt][nt] is row g + 8*(e/2), column 2*tig + e%2.
  __nv_bfloat16* Y = static_cast<__nv_bfloat16*>(p.y);
  float cs[8][2], cq[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) cs[nt][e] = cq[nt][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 32 + mt * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + nt * 8 + tig * 2;
        if (n >= p.Co) continue;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt][2 * h],
                                                 acc[mt][nt][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(Y + (long long)m * p.Co + n) = v;
        const float v0 = __low2float(v), v1 = __high2float(v);
        cs[nt][0] += v0;
        cq[nt][0] += v0 * v0;
        cs[nt][1] += v1;
        cq[nt][1] += v1 * v1;
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = sum_over_groups(cs[nt][e]);
      const float q = sum_over_groups(cq[nt][e]);
      if (g == 0) {
        red_s[warp][nt * 8 + tig * 2 + e] = s;
        red_q[warp][nt * 8 + tig * 2 + e] = q;
      }
    }
  __syncthreads();
  if (tid < kConvBN && n0 + tid < p.Co) {
    float S = 0.f, Q = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      S += red_s[w][tid];
      Q += red_q[w][tid];
    }
    p.part_s[(long long)blockIdx.x * p.Co + n0 + tid] = S;
    p.part_q[(long long)blockIdx.x * p.Co + n0 + tid] = Q;
  }
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

int fused_bn_bwd_dx(const void* dy, const void* x, const void* y,
                    const float* mean, const float* inv, const float* isc,
                    const float* dbeta, const float* dgamma, void* dx,
                    void* dres, long long M, int C, int relu, float inv_m,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (dres != nullptr) * 2 + (relu != 0);
#define BWD_DX(T)                                                             \
  switch (variant) {                                                          \
    case 0: return bwd_dx<T, false, false>(dy, x, y, mean, inv, isc, dbeta,   \
                                           dgamma, dx, dres, M, C, inv_m, s); \
    case 1: return bwd_dx<T, false, true>(dy, x, y, mean, inv, isc, dbeta,    \
                                          dgamma, dx, dres, M, C, inv_m, s);  \
    case 2: return bwd_dx<T, true, false>(dy, x, y, mean, inv, isc, dbeta,    \
                                          dgamma, dx, dres, M, C, inv_m, s);  \
    default: return bwd_dx<T, true, true>(dy, x, y, mean, inv, isc, dbeta,    \
                                          dgamma, dx, dres, M, C, inv_m, s);  \
  }
  if (dtype == 0) { BWD_DX(float) }
  BWD_DX(__nv_bfloat16)
#undef BWD_DX
}

// x rows: n*sN + h*sH + w*sW for output position (n, h, w) of an N x Hs x Ws
// grid (a stride-2 subsample is passed as its strided view); w is [Co, Ci].
// y is [M, Co]; `part` is scratch of 2*ceil(M/128)*Co floats.
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
  dim3 grid(mtiles, (Co + kConvBN - 1) / kConvBN);
  if (dtype == 0)
    conv_stats_f32_kernel<<<grid, 256, 0, s>>>(p);
  else
    conv_stats_bf16_kernel<<<grid, 128, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finish(p.part_s, p.part_q, mtiles, Co, (float)p.M, 1, mean, var, s);
}

const char* fused_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
