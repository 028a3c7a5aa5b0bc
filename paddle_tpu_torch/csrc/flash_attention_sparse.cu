// Block-sparse packed-segment flash attention for Hopper (sm_90a): forward
// (out, lse), and backward (dq; dk and dv) of
//   out = softmax(q·kᵀ·scale, masked to each query's own segment
//                 [, causal]) [, dropout] · v
// on packed rows (several sentences per row, reader.pack_by_tokens), with no
// [Tq, Tk] mask or bias in memory.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/flash_attention.py:
//   forward:  _fwd_kernel_sparse (via _flash_fwd_pallas_sparse)
//   backward: _bwd_dq_kernel_sparse + _bwd_dkv_kernel_sparse (via
//             _flash_bwd_pallas_sparse)
// Their contract, kept here exactly:
//   - visibility travels as one int32 per (batch row, query),
//     se = (start << 16) | end: query i sees keys start <= k < end (its own
//     segment; the empty range [0, 0) for a pad query), and k <= i when
//     causal. It is stored once per batch row and read through b = bh / H.
//   - a [B, nq, nk] table `vis` says which (q tile, k tile) pairs hold a
//     visible element. The forward and dq kernels walk only the k tiles whose
//     bit is set; the dk/dv kernel, which owns a k tile, walks only the q
//     tiles whose bit is set (the transposed walk over the same table).
//   - masked scores are -1e30 and masked probabilities are SET to 0 (not
//     exp(-1e30 - m), which is exp(0) = 1 while the running max is still at
//     its -1e30 start): a fully masked tile then leaves m, l and every
//     accumulator bit for bit unchanged, so skipping a tile is bitwise the
//     same as processing it, and vis may be conservative (all ones included).
//   - the running max starts at -1e30 and a zero row sum divides by 1: a pad
//     query gets out = 0, lse = -1e30, and zero gradients.
// Backward math as the dense kernels (flash_attention_bwd.cu): delta = Σ dO·out
// (a plain reduction before the launch), p = exp(s - lse) where visible,
// ds = p·(dp - delta), dropout's keep bits regenerated from the forward's seed
// with the counter (j / 4, i, bh, 0) of philox.cuh, so every kernel here, the
// dense ones and dropout_keep_mask draw the same bit for every (bh, i, j)
// whatever is skipped.
//
// Design. The dense kernels' layout: one CTA per (b·h, 64-row q tile) for the
// forward and dq, one per (b·h, 64-key tile) for dk/dv, each owning its
// outputs (no atomics, deterministic); q, k, v, dO and the outputs addressed
// through (batch, head, token) strides with a contiguous head dim, so the
// packed [B, T, nh·d] fc outputs are read and written in place. Tq and Tk are
// multiples of 64 (the wrapper raises otherwise); Tq != Tk (cross attention)
// is allowed.
//   bf16: 4 warps, 16 q rows (or keys) each; mma.sync m16n8k16, bf16 in, f32
//         accumulate; p and ds rounded to bf16 before their products, as the
//         TPU kernels cast them.
//   f32:  256 threads, a 4x4 register tile each, FMA on the CUDA cores (TF32
//         would lose the f32 parity the tests hold it to).
//
// Bound. Work scales with the visible (i, j) pairs, not with Tq·Tk: 4·d flops
// a pair forward, 10·d backward. At the NMT shapes (T = 256, d = 64, packed
// sentences of ~26 tokens) most tiles hold few visible pairs, so a perfect
// kernel would be bound by the bytes of q, k, v, out (and dO, dq, dk, dv);
// a processed tile still costs its full 64x64 products here, so this first
// kernel (mma.sync, no wgmma, TMA or pipelining) stays far from that bound.
// Its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX package
constexpr int kTile = 64;          // q rows and keys per tile

struct SparseParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward only
  const int* se;       // [B, Tq] packed (start << 16) | end
  const int* vis;      // [B, Tq / 64, Tk / 64] tile visibility
  const float* lse_in;  // [B*H, Tq] (backward)
  const float* delta;   // [B*H, Tq] (backward)
  void* out;           // forward
  float* lse;          // [B*H, Tq] (forward)
  void* dq;
  void* dk;
  void* dv;
  int B, H, Tq, Tk;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;     // out (forward) or dO (backward)
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

__device__ __forceinline__ int nq_tiles(const SparseParams& p) {
  return p.Tq / kTile;
}
__device__ __forceinline__ int nk_tiles(const SparseParams& p) {
  return p.Tk / kTile;
}

// The element mask: key `col` is visible to query `row` with range
// [start, end).
__device__ __forceinline__ bool visible(const SparseParams& p, int row,
                                        int col, int start, int end) {
  return col >= start && col < end && (!p.causal || col <= row);
}

__device__ __forceinline__ void unpack_se(int se, int& start, int& end) {
  start = static_cast<int>(static_cast<unsigned>(se) >> 16);
  end = se & 0xFFFF;
}

// Loads the (start, end) of the 64 queries from q0 into shared memory.
__device__ __forceinline__ void load_ranges(const SparseParams& p, int b,
                                            int q0, int* sStart, int* sEnd,
                                            int tid) {
  if (tid < kTile) {
    int s, e;
    unpack_se(p.se[(long long)b * p.Tq + q0 + tid], s, e);
    sStart[tid] = s;
    sEnd[tid] = e;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores. Thread (ty, tx) owns score rows ty*4+i and
// columns tx+16j of the 64x64 block.
// ---------------------------------------------------------------------------

// A 64-row tile of a [T, D] f32 matrix (row stride `st`) into shared memory
// with row pitch `pitch`.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int pitch,
                                              const float* src, long long st,
                                              int tid) {
  constexpr int kVec = D / 4;
  for (int i = tid; i < kTile * kVec; i += 256) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * st + c);
    float* d = dst + r * pitch + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

// s = a·bᵀ (and t = c·dᵀ when sC is given) for the thread's 4x4 block.
template <int D, bool kTwo>
__device__ __forceinline__ void products_f32(const float* sA, const float* sB,
                                             const float* sC, const float* sD,
                                             int ty, int tx, float (&s)[4][4],
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
      if (kTwo) cv[i] = sC[(ty * 4 + i) * kPad + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = sB[(tx + 16 * j) * kPad + d];
      if (kTwo) dv[j] = sD[(tx + 16 * j) * kPad + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        if (kTwo) t[i][j] = fmaf(cv[i], dv[j], t[i][j]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(256) sparse_fwd_f32_kernel(SparseParams p) {
  constexpr int kPad = D + 1, kPitchP = kTile + 1;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                 // [64][D+1]
  float* sK = sQ + kTile * kPad;        // [64][D+1]
  float* sV = sK + kTile * kPad;        // [64][D]
  float* sP = sV + kTile * D;           // [64][65]  p (dropped)
  int* sStart = reinterpret_cast<int*>(sP + kTile * kPitchP);  // [64]
  int* sEnd = sStart + kTile;                                    // [64]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sEnd + kTile);    // [64][68]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int iq = blockIdx.x, q0 = iq * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile_f32<D>(sQ, kPad, q + q0 * p.q_st, p.q_st, tid);
  load_ranges(p, b, q0, sStart, sEnd, tid);
  __syncthreads();

  float m[4], l[4], acc[4][D / 16];
  int st[4], en[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    st[i] = sStart[ty * 4 + i];
    en[i] = sEnd[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int nk = nk_tiles(p);
  const int* vis = p.vis + ((long long)b * nq_tiles(p) + iq) * nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (vis[kt] == 0) continue;  // the same for the whole CTA
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK/sV/sP/sKeep are consumed
    load_tile_f32<D>(sK, kPad, k + k0 * p.k_st, p.k_st, tid);
    load_tile_f32<D>(sV, D, v + k0 * p.v_st, p.v_st, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
    __syncthreads();

    float s[4][4], unused[4][4];
    products_f32<D, false>(sQ, sK, nullptr, nullptr, ty, tx, s, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row_l = ty * 4 + i, row = q0 + row_l;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(p, row, k0 + tx + 16 * j, st[i], en[i]);
        s[i][j] = ok[j] ? s[i][j] * p.sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += e;  // the row sum is over the undropped p
        float pv = e;
        if (p.drop.on)
          pv = sKeep[row_l * flash::kKeepPitch + tx + 16 * j]
                   ? e * p.drop.scale : 0.f;
        sP[row_l * kPitchP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kPitchP + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = sV[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* out = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[row * p.o_st + tx + 16 * j] = acc[i][j] / l_safe;
    if (tx == 0) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(256) sparse_dq_f32_kernel(SparseParams p) {
  constexpr int kPad = D + 1, kPitchS = kTile + 1;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;             // [64][D+1]
  float* sG = sQ + kTile * kPad;    // [64][D+1]  dO
  float* sK = sG + kTile * kPad;    // [64][D+1]
  float* sV = sK + kTile * kPad;    // [64][D+1]
  float* sDS = sV + kTile * kPad;   // [64][65]
  float* sL = sDS + kTile * kPitchS;
  float* sDelta = sL + kTile;
  int* sStart = reinterpret_cast<int*>(sDelta + kTile);
  int* sEnd = sStart + kTile;
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sEnd + kTile);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int iq = blockIdx.x, q0 = iq * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile_f32<D>(sQ, kPad, q + q0 * p.q_st, p.q_st, tid);
  load_tile_f32<D>(sG, kPad, g + q0 * p.o_st, p.o_st, tid);
  load_ranges(p, b, q0, sStart, sEnd, tid);
  if (tid < kTile) {
    sL[tid] = p.lse_in[(long long)bh * p.Tq + q0 + tid];
    sDelta[tid] = p.delta[(long long)bh * p.Tq + q0 + tid];
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int nk = nk_tiles(p);
  const int* vis = p.vis + ((long long)b * nq_tiles(p) + iq) * nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (vis[kt] == 0) continue;  // the same for the whole CTA
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK/sV/sDS/sKeep are consumed
    load_tile_f32<D>(sK, kPad, k + k0 * p.k_st, p.k_st, tid);
    load_tile_f32<D>(sV, kPad, v + k0 * p.v_st, p.v_st, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
    __syncthreads();

    float s[4][4], dp[4][4];
    products_f32<D, true>(sQ, sK, sG, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row_l = ty * 4 + i, col_l = tx + 16 * j;
        const bool ok = visible(p, q0 + row_l, k0 + col_l, sStart[row_l],
                                sEnd[row_l]);
        const float pr = ok ? expf(s[i][j] * p.sm_scale - sL[row_l]) : 0.f;
        float dpv = dp[i][j];
        if (p.drop.on)
          dpv = sKeep[row_l * flash::kKeepPitch + col_l] ? dpv * p.drop.scale
                                                         : 0.f;
        sDS[row_l * kPitchS + col_l] = pr * (dpv - sDelta[row_l]);
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

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[row * p.dq_st + tx + 16 * j] = acc[i][j] * p.sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256) sparse_dkv_f32_kernel(SparseParams p) {
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
  int* sStart = reinterpret_cast<int*>(sDelta + kTile);
  int* sEnd = sStart + kTile;
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sEnd + kTile);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile_f32<D>(sK, kPad, k + k0 * p.k_st, p.k_st, tid);
  load_tile_f32<D>(sV, kPad, v + k0 * p.v_st, p.v_st, tid);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the transposed walk: column kt of this batch row's [nq, nk] table
  const int nq = nq_tiles(p), nk = nk_tiles(p);
  const int* vis = p.vis + (long long)b * nq * nk + kt;
  for (int iq = 0; iq < nq; ++iq) {
    if (vis[iq * nk] == 0) continue;  // the same for the whole CTA
    const int q0 = iq * kTile;
    __syncthreads();  // the previous q tile is consumed
    load_tile_f32<D>(sQ, kPad, q + q0 * p.q_st, p.q_st, tid);
    load_tile_f32<D>(sG, kPad, g + q0 * p.o_st, p.o_st, tid);
    load_ranges(p, b, q0, sStart, sEnd, tid);
    if (tid < kTile) {
      sL[tid] = p.lse_in[(long long)bh * p.Tq + q0 + tid];
      sDelta[tid] = p.delta[(long long)bh * p.Tq + q0 + tid];
    }
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
    __syncthreads();

    // rows = queries ty*4+i, columns = keys tx+16j
    float s[4][4], dp[4][4];
    products_f32<D, true>(sQ, sK, sG, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row_l = ty * 4 + i, col_l = tx + 16 * j;
        const bool ok = visible(p, q0 + row_l, k0 + col_l, sStart[row_l],
                                sEnd[row_l]);
        const float pr = ok ? expf(s[i][j] * p.sm_scale - sL[row_l]) : 0.f;
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

  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
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
using bf = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t ld_u32(const bf* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from r0, 16 columns from c) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf* tile,
                                       int pitch, int r0, int c) {
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

// A 64-row tile of a [T, D] bf16 matrix into `dst` (row pitch D+8) and, when
// `dst_t` is given, its transpose into `dst_t` (row pitch 72).
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf* dst, bf* dst_t,
                                               const bf* src, long long st,
                                               int tid) {
  constexpr int kVec = D / 8, kPadT = kTile + 8;
  for (int i = tid; i < kTile * kVec; i += 128) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(src + r * st + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
    if (dst_t != nullptr) {
      const bf* xe = reinterpret_cast<const bf*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst_t[(c + e) * kPadT + r] = xe[e];
    }
  }
}

// Stores a warp's 16 x D f32 accumulators (times `scale`) as bf16 rows
// row0 and row0+8 of a [T, D] matrix.
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf* dst, long long st,
                                                const float (&acc)[D / 8][4],
                                                int row0, int tig,
                                                float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf* out = dst + (row0 + 8 * r) * st + tig * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * r] * scale,
                                acc[nb][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(128) sparse_fwd_bf16_kernel(SparseParams p) {
  constexpr int kPadQK = D + 8, kPadT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sQ = reinterpret_cast<bf*>(smem_raw);                     // [64][D+8]
  bf* sK = sQ + kTile * kPadQK;                                 // [64][D+8]
  bf* sVt = sK + kTile * kPadQK;                                // [D][72]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sVt + D * kPadT);  // [64][68]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // mma group id, thread in group
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int iq = blockIdx.x, q0 = iq * kTile;
  const bf* q = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* k = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* v = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile_bf16<D>(sQ, nullptr, q + q0 * p.q_st, p.q_st, tid);
  __syncthreads();

  // this warp's 16 q rows as mma A fragments, for every 16-wide d step
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    load_a(qf[ks], sQ, kPadQK, r0, ks * 16 + tig * 2);

  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  int st[2], en[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    unpack_se(p.se[(long long)b * p.Tq + rows[r]], st[r], en[r]);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;

  const int nk = nk_tiles(p);
  const int* vis = p.vis + ((long long)b * nq_tiles(p) + iq) * nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (vis[kt] == 0) continue;  // the same for the whole CTA
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous sK/sVt
    load_tile_bf16<D>(sK, nullptr, k + k0 * p.k_st, p.k_st, tid);
    load_tile_bf16<D>(nullptr, sVt, v + k0 * p.v_st, p.v_st, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 128);
    __syncthreads();

    // S = Q·Kᵀ for 16 rows x 64 keys: 8 n-blocks of 8 keys
    float s[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const bf* krow = sK + (nb * 8 + g) * kPadQK + tig * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_bf16_16816(s[nb], qf[ks], ld_u32(krow + ks * 16),
                       ld_u32(krow + ks * 16 + 8));
    }

    // mask and online softmax; bit nb*4+e of `ok` is element e of n-block nb
    uint32_t ok = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + nb * 8 + tig * 2 + (e & 1);
        const bool vis_e = visible(p, rows[r], col, st[r], en[r]);
        ok |= (vis_e ? 1u : 0u) << (nb * 4 + e);
        s[nb][e] = vis_e ? s[nb][e] * p.sm_scale : kNegInf;
        mx[r] = fmaxf(mx[r], s[nb][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = (ok >> (nb * 4 + e)) & 1u ? expf(s[nb][e] - m[e >> 1])
                                             : 0.f;
        sum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
    if (p.drop.on) {  // drop after the row sum: lse is over the undropped p
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row_l = r0 + 8 * (e >> 1);
          const int col_l = nb * 8 + tig * 2 + (e & 1);
          s[nb][e] = sKeep[row_l * flash::kKeepPitch + col_l]
                         ? s[nb][e] * p.drop.scale : 0.f;
        }
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb][0] *= corr[0]; o[nb][1] *= corr[0];
      o[nb][2] *= corr[1]; o[nb][3] *= corr[1];
    }

    // O += P·V
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const bf* vrow = sVt + (nb * 8 + g) * kPadT + kk * 16 + tig * 2;
        mma_bf16_16816(o[nb], a, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  }

  bf* out = static_cast<bf*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    bf* orow = out + rows[r] * p.o_st + tig * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(o[nb][2 * r] * inv, o[nb][2 * r + 1] * inv);
    if (tig == 0) p.lse[(long long)bh * p.Tq + rows[r]] = m[r] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(128) sparse_dq_bf16_kernel(SparseParams p) {
  constexpr int kPadQK = D + 8, kPadT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sQ = reinterpret_cast<bf*>(smem_raw);                     // [64][D+8]
  bf* sG = sQ + kTile * kPadQK;                                 // [64][D+8]
  bf* sK = sG + kTile * kPadQK;                                 // [64][D+8]
  bf* sV = sK + kTile * kPadQK;                                 // [64][D+8]
  bf* sKt = sV + kTile * kPadQK;                                // [D][72]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sKt + D * kPadT);  // [64][68]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int iq = blockIdx.x, q0 = iq * kTile;
  const bf* q = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* k = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* v = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf* gd = static_cast<const bf*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile_bf16<D>(sQ, nullptr, q + q0 * p.q_st, p.q_st, tid);
  load_tile_bf16<D>(sG, nullptr, gd + q0 * p.o_st, p.o_st, tid);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float lse[2], delta[2];
  int st[2], en[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lse[r] = p.lse_in[(long long)bh * p.Tq + row];
    delta[r] = p.delta[(long long)bh * p.Tq + row];
    unpack_se(p.se[(long long)b * p.Tq + row], st[r], en[r]);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int nk = nk_tiles(p);
  const int* vis = p.vis + ((long long)b * nq_tiles(p) + iq) * nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (vis[kt] == 0) continue;  // the same for the whole CTA
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D>(sK, sKt, k + k0 * p.k_st, p.k_st, tid);
    load_tile_bf16<D>(sV, nullptr, v + k0 * p.v_st, p.v_st, tid);
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
        const int r = e >> 1, row_l = r0 + 8 * r;
        const int col_l = nb * 8 + tig * 2 + (e & 1);
        const bool ok = visible(p, q0 + row_l, k0 + col_l, st[r], en[r]);
        const float pr = ok ? expf(s[nb][e] * p.sm_scale - lse[r]) : 0.f;
        float dpv = dp[nb][e];
        if (p.drop.on)
          dpv = sKeep[row_l * flash::kKeepPitch + col_l] ? dpv * p.drop.scale
                                                         : 0.f;
        s[nb][e] = pr * (dpv - delta[r]);
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

  bf* dq = static_cast<bf*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows_bf16<D>(dq, p.dq_st, acc, q0 + r0, tig, p.sm_scale);
}

template <int D>
__global__ void __launch_bounds__(128) sparse_dkv_bf16_kernel(SparseParams p) {
  constexpr int kPadQK = D + 8, kPadT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sK = reinterpret_cast<bf*>(smem_raw);                     // [64][D+8]
  bf* sV = sK + kTile * kPadQK;                                 // [64][D+8]
  bf* sQ = sV + kTile * kPadQK;                                 // [64][D+8]
  bf* sG = sQ + kTile * kPadQK;                                 // [64][D+8]
  bf* sQt = sG + kTile * kPadQK;                                // [D][72]
  bf* sGt = sQt + D * kPadT;                                    // [D][72]
  float* sL = reinterpret_cast<float*>(sGt + D * kPadT);        // [64]
  float* sDelta = sL + kTile;                                   // [64]
  int* sStart = reinterpret_cast<int*>(sDelta + kTile);         // [64]
  int* sEnd = sStart + kTile;                                   // [64]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sEnd + kTile);    // [64][68]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const bf* q = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* k = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* v = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf* gd = static_cast<const bf*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile_bf16<D>(sK, nullptr, k + k0 * p.k_st, p.k_st, tid);
  load_tile_bf16<D>(sV, nullptr, v + k0 * p.v_st, p.v_st, tid);

  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;

  // the transposed walk: column kt of this batch row's [nq, nk] table
  const int nq = nq_tiles(p), nk = nk_tiles(p);
  const int* vis = p.vis + (long long)b * nq * nk + kt;
  for (int iq = 0; iq < nq; ++iq) {
    if (vis[iq * nk] == 0) continue;  // the same for the whole CTA
    const int q0 = iq * kTile;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile_bf16<D>(sQ, sQt, q + q0 * p.q_st, p.q_st, tid);
    load_tile_bf16<D>(sG, sGt, gd + q0 * p.o_st, p.o_st, tid);
    load_ranges(p, b, q0, sStart, sEnd, tid);
    if (tid < kTile) {
      sL[tid] = p.lse_in[(long long)bh * p.Tq + q0 + tid];
      sDelta[tid] = p.delta[(long long)bh * p.Tq + q0 + tid];
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
        const bool ok = visible(p, q0 + q_l, k0 + key_l, sStart[q_l],
                                sEnd[q_l]);
        const float pr = ok ? expf(st[nb][e] * p.sm_scale - sL[q_l]) : 0.f;
        float pd = pr, dpv = dpt[nb][e];
        if (p.drop.on) {
          const bool keep = sKeep[q_l * flash::kKeepPitch + key_l];
          pd = keep ? pr * p.drop.scale : 0.f;
          dpv = keep ? dpv * p.drop.scale : 0.f;
        }
        st[nb][e] = pd;
        dpt[nb][e] = pr * (dpv - sDelta[q_l]);
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

  bf* dkp = static_cast<bf*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf* dvp = static_cast<bf*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows_bf16<D>(dkp, p.dk_st, dk, k0 + r0, tig, p.sm_scale);
  store_rows_bf16<D>(dvp, p.dv_st, dv, k0 + r0, tig, 1.f);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
constexpr size_t kKeepBytes = kTile * flash::kKeepPitch;
constexpr size_t kRangeBytes = 2 * kTile * sizeof(int);

template <int D>
size_t smem_fwd_f32() {
  return sizeof(float) * (2 * kTile * (D + 1) + kTile * D +
                          kTile * (kTile + 1)) + kRangeBytes + kKeepBytes;
}
template <int D>
size_t smem_dq_f32() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) +
                          2 * kTile) + kRangeBytes + kKeepBytes;
}
template <int D>
size_t smem_dkv_f32() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) +
                          2 * kTile) + kRangeBytes + kKeepBytes;
}
template <int D>
size_t smem_fwd_bf16() {
  return sizeof(bf) * (2 * kTile * (D + 8) + D * (kTile + 8)) + kKeepBytes;
}
template <int D>
size_t smem_dq_bf16() {
  return sizeof(bf) * (4 * kTile * (D + 8) + D * (kTile + 8)) + kKeepBytes;
}
template <int D>
size_t smem_dkv_bf16() {
  return sizeof(bf) * (4 * kTile * (D + 8) + 2 * D * (kTile + 8)) +
         sizeof(float) * 2 * kTile + kRangeBytes + kKeepBytes;
}

// Opts a kernel into its dynamic shared memory once per device, then
// launches it on `stream` over (tiles, B·H).
template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned* configured, const SparseParams& p,
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

// one flag word per (kernel, dtype, head dim)
unsigned configured[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

template <int D>
cudaError_t launch_fwd(const SparseParams& p, int dtype, cudaStream_t s) {
  const int slot = (dtype * 2 + (D == 128)) * 3;
  const int nq = p.Tq / kTile;
  if (dtype == 0)
    return launch(sparse_fwd_f32_kernel<D>, &configured[slot], p, nq, 256,
                  smem_fwd_f32<D>(), s);
  return launch(sparse_fwd_bf16_kernel<D>, &configured[slot], p, nq, 128,
                smem_fwd_bf16<D>(), s);
}

template <int D>
cudaError_t launch_bwd(const SparseParams& p, int dtype, cudaStream_t s) {
  const int slot = (dtype * 2 + (D == 128)) * 3;
  const int nq = p.Tq / kTile, nk = p.Tk / kTile;
  cudaError_t err;
  if (dtype == 0) {
    err = launch(sparse_dq_f32_kernel<D>, &configured[slot + 1], p, nq, 256,
                 smem_dq_f32<D>(), s);
    if (err != cudaSuccess) return err;
    return launch(sparse_dkv_f32_kernel<D>, &configured[slot + 2], p, nk, 256,
                  smem_dkv_f32<D>(), s);
  }
  err = launch(sparse_dq_bf16_kernel<D>, &configured[slot + 1], p, nq, 128,
               smem_dq_bf16<D>(), s);
  if (err != cudaSuccess) return err;
  return launch(sparse_dkv_bf16_kernel<D>, &configured[slot + 2], p, nk, 128,
                smem_dkv_bf16<D>(), s);
}

bool shape_ok(int Tq, int Tk, int D, int dtype) {
  return (dtype == 0 || dtype == 1) && (D == 64 || D == 128) && Tq > 0 &&
         Tk > 0 && Tq % kTile == 0 && Tk % kTile == 0 && Tk < (1 << 15);
}

void set_common(SparseParams& p, const void* q, const void* k, const void* v,
                const int* se, const int* vis, int B, int H, int Tq, int Tk,
                const long long* qs, const long long* ks, const long long* vs,
                float sm_scale, int causal, const long long* seed,
                unsigned threshold, float drop_scale, int dropout) {
  p = SparseParams{};
  p.q = q; p.k = k; p.v = v; p.se = se; p.vis = vis;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.q_sb = qs[0]; p.q_sh = qs[1]; p.q_st = qs[2];
  p.k_sb = ks[0]; p.k_sh = ks[1]; p.k_st = ks[2];
  p.v_sb = vs[0]; p.v_sh = vs[1]; p.v_st = vs[2];
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}; Tq, Tk multiples of 64.
// Strides are in elements, three per tensor: (batch, head, token); the head
// dim is contiguous. se is [B, Tq] int32, vis [B, Tq/64, Tk/64] int32, lse
// [B*H, Tq] f32. With dropout != 0, `seed` points at one int64 on the device
// and a probability is dropped iff its Philox word < `threshold`; kept ones
// are scaled by `drop_scale`. Returns a cudaError_t (0 = launched).
int flash_attention_sparse_fwd(
    const void* q, const void* k, const void* v, const int* se,
    const int* vis, void* out, float* lse, int B, int H, int Tq, int Tk, int D,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides, float sm_scale,
    int causal, int dtype, const long long* seed, unsigned threshold,
    float drop_scale, int dropout, void* stream) {
  if (!shape_ok(Tq, Tk, D, dtype) || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  SparseParams p;
  set_common(p, q, k, v, se, vis, B, H, Tq, Tk, q_strides, k_strides,
             v_strides, sm_scale, causal, seed, threshold, drop_scale,
             dropout);
  p.out = out; p.lse = lse;
  p.o_sb = o_strides[0]; p.o_sh = o_strides[1]; p.o_st = o_strides[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? (int)launch_fwd<64>(p, dtype, s)
                 : (int)launch_fwd<128>(p, dtype, s);
}

// The backward: launches the dq kernel, then the dk/dv kernel, on `stream`.
// lse and delta (= Σ_d dO·out) are [B*H, Tq] f32; strides as in the
// forward, dO's in g_strides. Returns a cudaError_t (0 = launched).
int flash_attention_sparse_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* se, const int* vis,
    void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* g_strides,
    const long long* dq_strides, const long long* dk_strides,
    const long long* dv_strides, float sm_scale, int causal, int dtype,
    const long long* seed, unsigned threshold, float drop_scale, int dropout,
    void* stream) {
  if (!shape_ok(Tq, Tk, D, dtype) || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  SparseParams p;
  set_common(p, q, k, v, se, vis, B, H, Tq, Tk, q_strides, k_strides,
             v_strides, sm_scale, causal, seed, threshold, drop_scale,
             dropout);
  p.dout = dout; p.lse_in = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.o_sb = g_strides[0]; p.o_sh = g_strides[1]; p.o_st = g_strides[2];
  p.dq_sb = dq_strides[0]; p.dq_sh = dq_strides[1]; p.dq_st = dq_strides[2];
  p.dk_sb = dk_strides[0]; p.dk_sh = dk_strides[1]; p.dk_st = dk_strides[2];
  p.dv_sb = dv_strides[0]; p.dv_sh = dv_strides[1]; p.dv_st = dv_strides[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? (int)launch_bwd<64>(p, dtype, s)
                 : (int)launch_bwd<128>(p, dtype, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
