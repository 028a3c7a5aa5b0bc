// Flash-attention backward for Hopper (sm_90a): dq, dk, dv (and optionally
// dbias) of out = softmax(q·kᵀ·scale + bias [, causal]) [, dropout] · v,
// recomputing the probabilities from the forward's lse instead of storing
// the [Tq, Tk] score matrix.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/flash_attention.py:
// _bwd_dq_kernel + _bwd_dkv_kernel (via _flash_bwd_pallas) and
// _bwd_kernel_onepass (via _flash_bwd_pallas_onepass). The math is theirs:
//   delta = Σ_d dO·out            (one plain reduction before the launch,
//                                  as _bwd_host_prep computes it)
//   p  = exp(s − lse)             s = q·kᵀ·scale + bias, causal −1e30
//   dv = p_dropᵀ·dO               dp = dO·vᵀ, drop-scaled
//   ds = p·(dp − delta)           dk = dsᵀ·q·scale     dq = ds·k·scale
// with dropout's keep bits regenerated from the forward's seed (philox.cuh),
// p_drop, ds and dO rounded to the input type before their products, and f32
// accumulation. dbias is ds itself for a per-query bias ([B·nh, Tq, Tk] f32,
// written by the dq kernel, its causally skipped tiles zeroed) or ds summed
// over the queries for a mask-like bias ([B·nh, Tk] f32, from the dk/dv
// kernel). Keys past a ragged Tk and queries past a ragged Tq contribute
// exactly 0.
//
// Design. Two kernels, as the TPU split has them, so every output is
// written by one CTA and the result is deterministic (no atomics):
//   dq kernel:   one CTA per (b·h, 64-row q tile) walks the 64-key tiles
//                and keeps dq in registers;
//   dk/dv kernel: one CTA per (b·h, 64-key tile) walks the 64-row q tiles
//                (from the diagonal on when causal) and keeps dk, dv and the
//                column sum of ds in registers.
// Both recompute s, p and dp = dO·vᵀ. q, k, v, dO and the outputs are
// addressed through (batch, head, token) strides with a contiguous head dim,
// so the q/k/v thirds of the fused qkv projection and the packed [B, T, H]
// gradients are read and written in place.
//   bf16: 4 warps; mma.sync m16n8k16 (bf16 in, f32 accumulate) for all five
//         products. The dk/dv kernel computes sᵀ = k·qᵀ directly, so p and ds
//         come out of the accumulators already in the A-fragment layout of
//         dv += p_dropᵀ·dO and dk += dsᵀ·q; k (for dq) and q, dO (for dk, dv)
//         are also stored transposed in shared memory as B operands.
//   f32:  256 threads, a 4x4 register tile of the 64x64 score block each,
//         FMA on the CUDA cores (TF32 off, for parity with the CPU).
//
// Bound. Five products of 2·Tq·Tk·d flops per head (s, dp, dv, dk, dq) over
// the bytes of q, k, v, out, dO, dq, dk, dv, lse and delta: in bf16 about
// 0.4·T flops a byte (50 at T = 128, 200 at T = 512), under the H100's ~295
// flop/byte tensor-core ridge, so a perfect bf16 kernel is memory bound at
// T = 128 and close to the ridge at T = 512; in f32 (0.2·T flops a byte
// against a ~20 flop/byte FMA ridge) it is compute bound. Recomputing s and
// dp in both kernels costs 7 products instead of 5. This first kernel uses
// mma.sync from shared memory tiles, without wgmma, TMA or software
// pipelining, so it stays far from either roof; its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX package
constexpr int kTile = 64;          // q rows and keys per tile

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  const void* bias;    // nullptr = no bias; same dtype as q
  void* dq;
  void* dk;
  void* dv;
  float* dbias;      // per-query dbias [B*H, Tq, Tk] or nullptr
  float* dbias_col;  // column-sum dbias [B*H, Tk] or nullptr
  int B, H, Tq, Tk;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long g_sb, g_sh, g_st;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  long long b_sb, b_sh, b_sq, b_sk;
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p = exp(s − lse) of (row, col) from the raw q·k dot product; exactly 0 past
// the ragged ends.
template <typename T>
__device__ __forceinline__ float prob(const BwdParams& p, float acc,
                                      const T* bias, int row, int col,
                                      float lse) {
  if (row >= p.Tq || col >= p.Tk) return 0.f;
  float s = acc * p.sm_scale;
  if (bias != nullptr) s += to_float(bias[row * p.b_sq + col * p.b_sk]);
  if (p.causal && col > row) s = kNegInf;
  return expf(s - lse);
}

// Key tiles a q tile needs: causal rows see no key past their own index.
__device__ __forceinline__ int num_k_tiles(const BwdParams& p, int q0) {
  int n = (p.Tk + kTile - 1) / kTile;
  if (p.causal) {
    int last_row = min(q0 + kTile, p.Tq) - 1;
    n = min(n, last_row / kTile + 1);
  }
  return n;
}

// Zeroes the per-query dbias of the key tiles a causal q tile skips (the
// TPU dq kernel writes zeros for its skipped blocks too).
__device__ __forceinline__ void zero_skipped_dbias(const BwdParams& p, int bh,
                                                   int q0, int n_tiles,
                                                   int tid, int nthreads) {
  const int c0 = n_tiles * kTile, ncols = p.Tk - c0;
  if (p.dbias == nullptr || ncols <= 0) return;
  for (int idx = tid; idx < kTile * ncols; idx += nthreads) {
    const int r = idx / ncols, c = idx % ncols;
    if (q0 + r < p.Tq)
      p.dbias[((long long)bh * p.Tq + q0 + r) * p.Tk + c0 + c] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores. Thread (ty, tx) owns score rows ty*4+i and
// columns tx+16j of the 64x64 block.
// ---------------------------------------------------------------------------

// Loads a 64-row tile of a [T, D] f32 matrix (row stride `st`) into shared
// memory with row pitch D+1; rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long st, int valid,
                                              int tid) {
  constexpr int kVec = D / 4;
  for (int i = tid; i < kTile * kVec; i += 256) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * st + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

// s = a·bᵀ and t = c·dᵀ for the thread's 4x4 block, from 64-row tiles.
template <int D>
__device__ __forceinline__ void two_products_f32(const float* sA,
                                                 const float* sB,
                                                 const float* sC,
                                                 const float* sD, int ty,
                                                 int tx, float (&s)[4][4],
                                                 float (&t)[4][4]) {
  constexpr int kPad = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = sA[(ty * 4 + i) * kPad + d];
      cv[i] = sC[(ty * 4 + i) * kPad + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = sB[(tx + 16 * j) * kPad + d];
      dv[j] = sD[(tx + 16 * j) * kPad + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], dv[j], t[i][j]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32_kernel(BwdParams p) {
  constexpr int kPad = D + 1, kPitchS = kTile + 1;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;             // [64][D+1]
  float* sG = sQ + kTile * kPad;    // [64][D+1]  dO
  float* sK = sG + kTile * kPad;    // [64][D+1]
  float* sV = sK + kTile * kPad;    // [64][D+1]
  float* sDS = sV + kTile * kPad;   // [64][65]
  float* sL = sDS + kTile * kPitchS;
  float* sDelta = sL + kTile;
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sDelta + kTile);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_sb + h * p.b_sh;

  load_tile_f32<D>(sQ, q + q0 * p.q_st, p.q_st, p.Tq - q0, tid);
  load_tile_f32<D>(sG, g + q0 * p.g_st, p.g_st, p.Tq - q0, tid);
  if (tid < kTile) {
    const bool ok = q0 + tid < p.Tq;
    sL[tid] = ok ? p.lse[(long long)bh * p.Tq + q0 + tid] : 0.f;
    sDelta[tid] = ok ? p.delta[(long long)bh * p.Tq + q0 + tid] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int n_tiles = num_k_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK/sV/sDS/sKeep are consumed
    load_tile_f32<D>(sK, k + k0 * p.k_st, p.k_st, p.Tk - k0, tid);
    load_tile_f32<D>(sV, v + k0 * p.v_st, p.v_st, p.Tk - k0, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products_f32<D>(sQ, sK, sG, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row_l = ty * 4 + i, col_l = tx + 16 * j;
        const int row = q0 + row_l, col = k0 + col_l;
        const float pr = prob(p, s[i][j], bias, row, col, sL[row_l]);
        float dpv = dp[i][j];
        if (p.drop.on)
          dpv = sKeep[row_l * flash::kKeepPitch + col_l] ? dpv * p.drop.scale
                                                         : 0.f;
        const float ds = pr * (dpv - sDelta[row_l]);
        sDS[row_l * kPitchS + col_l] = ds;
        if (p.dbias != nullptr && row < p.Tq && col < p.Tk)
          p.dbias[((long long)bh * p.Tq + row) * p.Tk + col] = ds;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * kPitchS + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kv[j] = sK[kk * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
  zero_skipped_dbias(p, bh, q0, n_tiles, tid, 256);

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[row * p.dq_st + tx + 16 * j] = acc[i][j] * p.sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32_kernel(BwdParams p) {
  constexpr int kPad = D + 1, kPitchS = kTile + 1;
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;             // [64][D+1]
  float* sV = sK + kTile * kPad;    // [64][D+1]
  float* sQ = sV + kTile * kPad;    // [64][D+1]
  float* sG = sQ + kTile * kPad;    // [64][D+1]  dO
  float* sP = sG + kTile * kPad;    // [64 q][65]  p_drop
  float* sDS = sP + kTile * kPitchS;  // [64 q][65]
  float* sL = sDS + kTile * kPitchS;
  float* sDelta = sL + kTile;
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sDelta + kTile);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_sb + h * p.b_sh;

  load_tile_f32<D>(sK, k + k0 * p.k_st, p.k_st, p.Tk - k0, tid);
  load_tile_f32<D>(sV, v + k0 * p.v_st, p.v_st, p.Tk - k0, tid);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;
  float dbc = 0.f;  // column sum of ds for key k0 + tid (tid < 64)

  const int nq = (p.Tq + kTile - 1) / kTile;
  for (int iq = p.causal ? k0 / kTile : 0; iq < nq; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();  // the previous q tile is consumed
    load_tile_f32<D>(sQ, q + q0 * p.q_st, p.q_st, p.Tq - q0, tid);
    load_tile_f32<D>(sG, g + q0 * p.g_st, p.g_st, p.Tq - q0, tid);
    if (tid < kTile) {
      const bool ok = q0 + tid < p.Tq;
      sL[tid] = ok ? p.lse[(long long)bh * p.Tq + q0 + tid] : 0.f;
      sDelta[tid] = ok ? p.delta[(long long)bh * p.Tq + q0 + tid] : 0.f;
    }
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
    __syncthreads();

    // rows = queries ty*4+i, columns = keys tx+16j
    float s[4][4], dp[4][4];
    two_products_f32<D>(sQ, sK, sG, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row_l = ty * 4 + i, col_l = tx + 16 * j;
        const float pr = prob(p, s[i][j], bias, q0 + row_l, k0 + col_l,
                              sL[row_l]);
        float pd = pr, dpv = dp[i][j];
        if (p.drop.on) {
          const bool keep = sKeep[row_l * flash::kKeepPitch + col_l];
          pd = keep ? pr * p.drop.scale : 0.f;
          dpv = keep ? dpv * p.drop.scale : 0.f;
        }
        sP[row_l * kPitchS + col_l] = pd;
        sDS[row_l * kPitchS + col_l] = pr * (dpv - sDelta[row_l]);
      }
    __syncthreads();

    if (p.dbias_col != nullptr && tid < kTile)
      for (int r = 0; r < kTile; ++r) dbc += sDS[r * kPitchS + tid];
    // dv += p_dropᵀ·dO and dk += dsᵀ·q: rows = keys ty*4+i, cols = d
#pragma unroll 2
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], gv[D / 16], qv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[qq * kPitchS + ty * 4 + i];
        dsv[i] = sDS[qq * kPitchS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        gv[j] = sG[qq * kPad + tx + 16 * j];
        qv[j] = sQ[qq * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  if (p.dbias_col != nullptr && tid < kTile && k0 + tid < p.Tk)
    p.dbias_col[(long long)bh * p.Tk + k0 + tid] = dbc;
  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dkp[key * p.dk_st + tx + 16 * j] = dk[i][j] * p.sm_scale;
      dvp[key * p.dv_st + tx + 16 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16. In a fragment, g = lane / 4
// and t = lane % 4; accumulator element e of an n-block sits at row
// g + 8·(e / 2), column 2t + e % 2.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from r0, 16 columns from c) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int pitch,
                                       int r0, int c) {
  a[0] = ld_u32(tile + r0 * pitch + c);
  a[1] = ld_u32(tile + (r0 + 8) * pitch + c);
  a[2] = ld_u32(tile + r0 * pitch + c + 8);
  a[3] = ld_u32(tile + (r0 + 8) * pitch + c + 8);
}

// The accumulators of n-blocks 2kk and 2kk+1 are exactly the A fragment of
// the 16-wide k step kk of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[8][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// Loads a 64-row tile of a [T, D] bf16 matrix into `dst` (row pitch D+8)
// and, when `dst_t` is given, its transpose into `dst_t` (row pitch 72);
// rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               __nv_bfloat16* dst_t,
                                               const __nv_bfloat16* src,
                                               long long st, int valid,
                                               int tid) {
  constexpr int kVec = D / 8, kPadT = kTile + 8;
  for (int i = tid; i < kTile * kVec; i += 128) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * st + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
    if (dst_t != nullptr) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst_t[(c + e) * kPadT + r] = xe[e];
    }
  }
}

// Stores a warp's 16 x D f32 accumulators (times `scale`) as bf16 rows
// r0 and r0+8 of a [T, D] matrix, skipping rows past `limit`.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                long long st,
                                                const float (&acc)[D / 8][4],
                                                int row0, int limit, int tig,
                                                float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* out = dst + row * st + tig * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * r] * scale,
                                acc[nb][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(BwdParams p) {
  constexpr int kPadQK = D + 8, kPadT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][D+8]
  __nv_bfloat16* sG = sQ + kTile * kPadQK;                           // [64][D+8]
  __nv_bfloat16* sK = sG + kTile * kPadQK;                           // [64][D+8]
  __nv_bfloat16* sV = sK + kTile * kPadQK;                           // [64][D+8]
  __nv_bfloat16* sKt = sV + kTile * kPadQK;                          // [D][72]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sKt + D * kPadT);     // [64][68]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* k = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* v = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf* gd = static_cast<const bf*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const bf* bias = p.bias == nullptr ? nullptr
      : static_cast<const bf*>(p.bias) + b * p.b_sb + h * p.b_sh;

  load_tile_bf16<D>(sQ, nullptr, q + q0 * p.q_st, p.q_st, p.Tq - q0, tid);
  load_tile_bf16<D>(sG, nullptr, gd + q0 * p.g_st, p.g_st, p.Tq - q0, tid);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool ok = row < p.Tq;
    lse[r] = ok ? p.lse[(long long)bh * p.Tq + row] : 0.f;
    delta[r] = ok ? p.delta[(long long)bh * p.Tq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int n_tiles = num_k_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D>(sK, sKt, k + k0 * p.k_st, p.k_st, p.Tk - k0, tid);
    load_tile_bf16<D>(sV, nullptr, v + k0 * p.v_st, p.v_st, p.Tk - k0, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 128);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ for 16 rows x 64 keys: 8 n-blocks of 8 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t aq[4], ag[4];
      load_a(aq, sQ, kPadQK, r0, ks * 16 + tig * 2);
      load_a(ag, sG, kPadQK, r0, ks * 16 + tig * 2);
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb) {
        const bf* krow = sK + (nb * 8 + g) * kPadQK + ks * 16 + tig * 2;
        const bf* vrow = sV + (nb * 8 + g) * kPadQK + ks * 16 + tig * 2;
        mma_bf16_16816(s[nb], aq, ld_u32(krow), ld_u32(krow + 8));
        mma_bf16_16816(dp[nb], ag, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }

    // ds = p·(dp − delta), in place of s
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row_l = r0 + 8 * (e >> 1), col_l = nb * 8 + tig * 2 + (e & 1);
        const int row = q0 + row_l, col = k0 + col_l;
        const float pr = prob(p, s[nb][e], bias, row, col, lse[e >> 1]);
        float dpv = dp[nb][e];
        if (p.drop.on)
          dpv = sKeep[row_l * flash::kKeepPitch + col_l] ? dpv * p.drop.scale
                                                         : 0.f;
        s[nb][e] = pr * (dpv - delta[e >> 1]);
        if (p.dbias != nullptr && row < p.Tq && col < p.Tk)
          p.dbias[((long long)bh * p.Tq + row) * p.Tk + col] = s[nb][e];
      }

    // dQ += dS·K: B operand from the transposed K tile
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const bf* ktrow = sKt + (nb * 8 + g) * kPadT + kk * 16 + tig * 2;
        mma_bf16_16816(acc[nb], a, ld_u32(ktrow), ld_u32(ktrow + 8));
      }
    }
  }
  zero_skipped_dbias(p, bh, q0, n_tiles, tid, 128);

  bf* dq = static_cast<bf*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows_bf16<D>(dq, p.dq_st, acc, q0 + r0, p.Tq, tig, p.sm_scale);
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(BwdParams p) {
  constexpr int kPadQK = D + 8, kPadT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][D+8]
  __nv_bfloat16* sV = sK + kTile * kPadQK;                           // [64][D+8]
  __nv_bfloat16* sQ = sV + kTile * kPadQK;                           // [64][D+8]
  __nv_bfloat16* sG = sQ + kTile * kPadQK;                           // [64][D+8]
  __nv_bfloat16* sQt = sG + kTile * kPadQK;                          // [D][72]
  __nv_bfloat16* sGt = sQt + D * kPadT;                              // [D][72]
  float* sL = reinterpret_cast<float*>(sGt + D * kPadT);            // [64]
  float* sDelta = sL + kTile;                                        // [64]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sDelta + kTile);      // [64][68]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* k = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* v = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf* gd = static_cast<const bf*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const bf* bias = p.bias == nullptr ? nullptr
      : static_cast<const bf*>(p.bias) + b * p.b_sb + h * p.b_sh;

  load_tile_bf16<D>(sK, nullptr, k + k0 * p.k_st, p.k_st, p.Tk - k0, tid);
  load_tile_bf16<D>(sV, nullptr, v + k0 * p.v_st, p.v_st, p.Tk - k0, tid);

  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;
  float dbc[2] = {0.f, 0.f};  // column sums of ds for keys r0, r0 + 8

  const int nq = (p.Tq + kTile - 1) / kTile;
  for (int iq = p.causal ? k0 / kTile : 0; iq < nq; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile_bf16<D>(sQ, sQt, q + q0 * p.q_st, p.q_st, p.Tq - q0, tid);
    load_tile_bf16<D>(sG, sGt, gd + q0 * p.g_st, p.g_st, p.Tq - q0, tid);
    if (tid < kTile) {
      const bool ok = q0 + tid < p.Tq;
      sL[tid] = ok ? p.lse[(long long)bh * p.Tq + q0 + tid] : 0.f;
      sDelta[tid] = ok ? p.delta[(long long)bh * p.Tq + q0 + tid] : 0.f;
    }
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 128);
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for 16 keys x 64 queries
    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ak[4], av[4];
      load_a(ak, sK, kPadQK, r0, ks * 16 + tig * 2);
      load_a(av, sV, kPadQK, r0, ks * 16 + tig * 2);
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb) {
        const bf* qrow = sQ + (nb * 8 + g) * kPadQK + ks * 16 + tig * 2;
        const bf* grow = sG + (nb * 8 + g) * kPadQK + ks * 16 + tig * 2;
        mma_bf16_16816(st[nb], ak, ld_u32(qrow), ld_u32(qrow + 8));
        mma_bf16_16816(dpt[nb], av, ld_u32(grow), ld_u32(grow + 8));
      }
    }

    // p_drop in place of sᵀ, ds in place of dpᵀ (row = key, column = query)
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key_l = r0 + 8 * (e >> 1), q_l = nb * 8 + tig * 2 + (e & 1);
        const float pr = prob(p, st[nb][e], bias, q0 + q_l, k0 + key_l,
                              sL[q_l]);
        float pd = pr, dpv = dpt[nb][e];
        if (p.drop.on) {
          const bool keep = sKeep[q_l * flash::kKeepPitch + key_l];
          pd = keep ? pr * p.drop.scale : 0.f;
          dpv = keep ? dpv * p.drop.scale : 0.f;
        }
        const float ds = pr * (dpv - sDelta[q_l]);
        st[nb][e] = pd;
        dpt[nb][e] = ds;
        dbc[e >> 1] += ds;
      }

    // dV += P_dropᵀ·dO and dK += dSᵀ·Q over the 64 queries
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a(ap, st, kk);
      acc_to_a(ads, dpt, kk);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const bf* gtrow = sGt + (nb * 8 + g) * kPadT + kk * 16 + tig * 2;
        const bf* qtrow = sQt + (nb * 8 + g) * kPadT + kk * 16 + tig * 2;
        mma_bf16_16816(dv[nb], ap, ld_u32(gtrow), ld_u32(gtrow + 8));
        mma_bf16_16816(dk[nb], ads, ld_u32(qtrow), ld_u32(qtrow + 8));
      }
    }
  }

  if (p.dbias_col != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dbc[r] += __shfl_xor_sync(0xffffffffu, dbc[r], 1);
      dbc[r] += __shfl_xor_sync(0xffffffffu, dbc[r], 2);
      const int key = k0 + r0 + 8 * r;
      if (tig == 0 && key < p.Tk)
        p.dbias_col[(long long)bh * p.Tk + key] = dbc[r];
    }
  }
  bf* dkp = static_cast<bf*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf* dvp = static_cast<bf*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows_bf16<D>(dkp, p.dk_st, dk, k0 + r0, p.Tk, tig, p.sm_scale);
  store_rows_bf16<D>(dvp, p.dv_st, dv, k0 + r0, p.Tk, tig, 1.f);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
constexpr size_t kKeepBytes = kTile * flash::kKeepPitch;

template <int D>
size_t smem_dq_f32() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) +
                          2 * kTile) + kKeepBytes;
}
template <int D>
size_t smem_dkv_f32() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) +
                          2 * kTile) + kKeepBytes;
}
template <int D>
size_t smem_dq_bf16() {
  return sizeof(__nv_bfloat16) * (4 * kTile * (D + 8) + D * (kTile + 8)) +
         kKeepBytes;
}
template <int D>
size_t smem_dkv_bf16() {
  return sizeof(__nv_bfloat16) * (4 * kTile * (D + 8) + 2 * D * (kTile + 8)) +
         sizeof(float) * 2 * kTile + kKeepBytes;
}

// Opts a kernel into its dynamic shared memory once per device, then
// launches it on `stream` over (tiles, B·H).
template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned* configured, const BwdParams& p,
                   int tiles, int threads, size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(*configured & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *configured |= bit;  // idempotent: a racing second setter is harmless
  }
  kernel<<<dim3(tiles, p.B * p.H), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

unsigned configured[8] = {0, 0, 0, 0, 0, 0, 0, 0};

template <int D>
cudaError_t launch_pair(const BwdParams& p, int dtype, cudaStream_t s) {
  const int nq = (p.Tq + kTile - 1) / kTile, nk = (p.Tk + kTile - 1) / kTile;
  const int slot = (dtype * 2 + (D == 128)) * 2;
  cudaError_t err;
  if (dtype == 0) {
    err = launch(flash_bwd_dq_f32_kernel<D>, &configured[slot], p, nq, 256,
                 smem_dq_f32<D>(), s);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dkv_f32_kernel<D>, &configured[slot + 1], p, nk,
                  256, smem_dkv_f32<D>(), s);
  }
  err = launch(flash_bwd_dq_bf16_kernel<D>, &configured[slot], p, nq, 128,
               smem_dq_bf16<D>(), s);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkv_bf16_kernel<D>, &configured[slot + 1], p, nk,
                128, smem_dkv_bf16<D>(), s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous. lse and delta are [B*H, Tq] f32. dbias (per query,
// [B*H, Tq, Tk] f32) and dbias_col ([B*H, Tk] f32) may be null. Dropout as
// in flash_attention_fwd. Launches the dq kernel, then the dk/dv kernel, on
// `stream`. Returns a cudaError_t (0 = launched).
int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* bias, void* dq,
    void* dk, void* dv, float* dbias, float* dbias_col, int B, int H, int Tq,
    int Tk, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long g_sb, long long g_sh,
    long long g_st, long long dq_sb, long long dq_sh, long long dq_st,
    long long dk_sb, long long dk_sh, long long dk_st, long long dv_sb,
    long long dv_sh, long long dv_st, long long b_sb, long long b_sh,
    long long b_sq, long long b_sk, float sm_scale, int causal, int dtype,
    const long long* seed, unsigned threshold, float drop_scale, int dropout,
    void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.bias = bias; p.dq = dq; p.dk = dk; p.dv = dv;
  p.dbias = dbias; p.dbias_col = dbias_col;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_st = g_st;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_st = dq_st;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_st = dk_st;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_st = dv_st;
  p.b_sb = b_sb; p.b_sh = b_sh; p.b_sq = b_sq; p.b_sk = b_sk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  return D == 64 ? (int)launch_pair<64>(p, dtype, s)
                 : (int)launch_pair<128>(p, dtype, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
