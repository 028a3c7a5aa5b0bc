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
// (computed before the launch by the dense backward's delta kernel), p =
// exp(s - lse) where visible, ds = p·(dp - delta),
// dropout's keep bits regenerated from the forward's seed with the counter
// (j / 4, i, bh, 0) of philox.cuh, so every kernel here, the dense ones and
// dropout_keep_mask draw the same bit for every (bh, i, j) whatever is
// skipped.
//
// Layout. The dense kernels' layout: one CTA per (64-row q tile, b·h) for the
// forward and dq, one per (64-key tile, b·h) for dk/dv, each owning its
// outputs (no atomics, deterministic). The grids are those pairs flattened
// onto blockIdx.x, so B·nh has no 65,535 cap. q, k, v, dO and the outputs
// are addressed through (batch, head, token) strides with a contiguous head
// dim, so the packed [B, T, nh·d] fc outputs are read and written in place.
// Tq and Tk are multiples of 64 (the wrapper routes other shapes to the
// plain version); Tq != Tk (cross attention) is allowed. Head dims 64, 128,
// 192 and 256. Above 128 a kernel whose accumulators would not fit in
// registers (or whose f32 tiles would not fit in shared memory) owns one
// 64-wide chunk of the output's head dim: the chunks are a third grid factor
// and each recomputes the scores over the full head dim.
//   f32:  256 threads, a 4x4 register tile each, FMA on the CUDA cores (TF32
//         would lose the f32 parity the tests hold it to). Above d = 128 the
//         backward kernels stream the head dim through shared memory in
//         64-wide chunks, in the same summation order.
//   bf16 forward: 4 warps, 16 q rows each; mma.sync m16n8k16, bf16 in, f32
//         accumulate; p rounded to bf16 before p·v, as the TPU kernel casts
//         it.
//   bf16 backward: wgmma on TMA-written tiles (hopper.cuh), as the dense
//         backward: a dq CTA computes S = Q·Kᵀ and dP = dO·Vᵀ (all K-major),
//         then dQ += dS·K with dS in registers and K read MN-major; a dk/dv
//         CTA computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and
//         dK += dSᵀ·Q with Pᵀ and dSᵀ in registers and dO, Q read MN-major.
//         No operand is transposed in shared memory. Thread 0 keeps a ring
//         of two stages one visible tile ahead of the math (K and V for dq;
//         Q, dO and the tile's lse, delta and se rows for dk/dv): the walk
//         visits only the tiles whose bit is set, so a skipped tile costs
//         no load and no barrier. The element mask is built from the row's
//         (start, end), the column and the causal test with selects; exp is
//         ex2.approx; dropout bits are drawn in registers (keep_bits_rows /
//         keep_bits_cols). Walks are short (~2.4 tiles at the NMT shapes),
//         so per-CTA set-up weighs as much as the products: one launch runs
//         both kinds of CTA (the dk/dv ones first, the dq ones filling the
//         tail), and thread 0 starts the resident tiles' copies before it
//         scans the tile table.
//
// Bound. Work scales with the visible (i, j) pairs, not with Tq·Tk: 4·d flops
// a pair forward, 10·d backward. At the NMT shapes (T = 256, d = 64, packed
// sentences of ~26 tokens) most tiles hold few visible pairs, so a perfect
// kernel would be bound by the bytes of q, k, v, out (and dO, dq, dk, dv);
// a processed tile still costs its full 64x64 products here, and a walk of
// ~2.4 tiles leaves the per-CTA set-up (barriers, the first loads) as large
// as the products. Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
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

// CTA x's place in a flat grid of (chunk, tile, b·h): chunk fastest, then
// the tile, then b·h.
struct Cell {
  int chunk, tile, bh, b, h;
};
__device__ __forceinline__ Cell cell_of(int tiles, int chunks, int H,
                                        unsigned x = blockIdx.x) {
  Cell c;
  c.chunk = x % chunks;
  const unsigned rest = x / chunks;
  c.tile = rest % tiles;
  c.bh = rest / tiles;
  c.b = c.bh / H;
  c.h = c.bh % H;
  return c;
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

// The first visible tile at or after `i` of a walk of `n` tiles whose bits
// are vis[i * stride]; n or more when there is none.
__device__ __forceinline__ int next_visible(const int* vis, int stride, int i,
                                            int n) {
  while (i < n && __ldg(vis + (long long)i * stride) == 0) ++i;
  return i;
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores. Thread (ty, tx) owns score rows ty*4+i and
// columns tx+16j of the 64x64 block.
// ---------------------------------------------------------------------------

// A 64-row tile of W columns of a [T, D] f32 matrix (row stride `st`) into
// shared memory with row pitch `pitch`.
template <int W>
__device__ __forceinline__ void load_tile_f32(float* dst, int pitch,
                                              const float* src, long long st,
                                              int tid) {
  constexpr int kVec = W / 4;
  for (int i = tid; i < kTile * kVec; i += 256) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * st + c);
    float* d = dst + r * pitch + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

// s += a·bᵀ (and t += c·dᵀ when kTwo) for the thread's 4x4 block, over the
// W columns of the tiles (row pitch W+1). Chunks of the head dim taken in
// order sum in the same order as one pass over it.
template <int W, bool kTwo>
__device__ __forceinline__ void products_f32(const float* sA, const float* sB,
                                             const float* sC, const float* sD,
                                             int ty, int tx, float (&s)[4][4],
                                             float (&t)[4][4]) {
  constexpr int kPad = W + 1;
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
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

__device__ __forceinline__ void zero4x4(float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
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
  const Cell cell = cell_of(nq_tiles(p), 1, p.H);
  const int bh = cell.bh, b = cell.b, h = cell.h;
  const int iq = cell.tile, q0 = iq * kTile;
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
    zero4x4(s);
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

// dq for the 64-wide output chunk of the head dim a CTA owns (DC = D up to
// d = 128: the one chunk, Q and dO stay in shared memory). Above that the
// products stream the head dim through the tiles in DC-wide chunks, and K's
// own chunk is loaded again for dQ += dS·K.
template <int D, int DC>
__global__ void __launch_bounds__(256) sparse_dq_f32_kernel(SparseParams p) {
  constexpr int kPad = DC + 1, kPitchS = kTile + 1, kChunks = D / DC;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;             // [64][DC+1]
  float* sG = sQ + kTile * kPad;    // [64][DC+1]  dO
  float* sK = sG + kTile * kPad;    // [64][DC+1]
  float* sV = sK + kTile * kPad;    // [64][DC+1]
  float* sDS = sV + kTile * kPad;   // [64][65]
  float* sL = sDS + kTile * kPitchS;
  float* sDelta = sL + kTile;
  int* sStart = reinterpret_cast<int*>(sDelta + kTile);
  int* sEnd = sStart + kTile;
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sEnd + kTile);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const Cell cell = cell_of(nq_tiles(p), kChunks, p.H);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int iq = cell.tile, q0 = iq * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  if (kChunks == 1) {
    load_tile_f32<DC>(sQ, kPad, q + q0 * p.q_st, p.q_st, tid);
    load_tile_f32<DC>(sG, kPad, g + q0 * p.o_st, p.o_st, tid);
  }
  load_ranges(p, b, q0, sStart, sEnd, tid);
  if (tid < kTile) {
    sL[tid] = p.lse_in[(long long)bh * p.Tq + q0 + tid];
    sDelta[tid] = p.delta[(long long)bh * p.Tq + q0 + tid];
  }

  float acc[4][DC / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) acc[i][j] = 0.f;

  const int nk = nk_tiles(p);
  const int* vis = p.vis + ((long long)b * nq_tiles(p) + iq) * nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (vis[kt] == 0) continue;  // the same for the whole CTA
    const int k0 = kt * kTile;
    float s[4][4], dp[4][4];
    zero4x4(s);
    zero4x4(dp);
    for (int c = 0; c < kChunks; ++c) {
      __syncthreads();  // the previous products and dQ step are done
      if (kChunks > 1) {
        load_tile_f32<DC>(sQ, kPad, q + q0 * p.q_st + c * DC, p.q_st, tid);
        load_tile_f32<DC>(sG, kPad, g + q0 * p.o_st + c * DC, p.o_st, tid);
      }
      load_tile_f32<DC>(sK, kPad, k + k0 * p.k_st + c * DC, p.k_st, tid);
      load_tile_f32<DC>(sV, kPad, v + k0 * p.v_st + c * DC, p.v_st, tid);
      if (c == 0 && p.drop.on)
        flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
      __syncthreads();
      products_f32<DC, true>(sQ, sK, sG, sV, ty, tx, s, dp);
    }
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
    if (kChunks > 1 && oc != kChunks - 1) {
      __syncthreads();  // every thread is done with the last chunk's sK
      load_tile_f32<DC>(sK, kPad, k + k0 * p.k_st + oc * DC, p.k_st, tid);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[DC / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * kPitchS + kk];
#pragma unroll
      for (int j = 0; j < DC / 16; ++j) kv[j] = sK[kk * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC / 16; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + oc * DC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < DC / 16; ++j)
      dq[row * p.dq_st + tx + 16 * j] = acc[i][j] * p.sm_scale;
  }
}

// dk and dv for the output chunk a CTA owns; streamed as the dq kernel.
template <int D, int DC>
__global__ void __launch_bounds__(256) sparse_dkv_f32_kernel(SparseParams p) {
  constexpr int kPad = DC + 1, kPitchS = kTile + 1, kChunks = D / DC;
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;             // [64][DC+1]
  float* sV = sK + kTile * kPad;    // [64][DC+1]
  float* sQ = sV + kTile * kPad;    // [64][DC+1]
  float* sG = sQ + kTile * kPad;    // [64][DC+1]  dO
  float* sP = sG + kTile * kPad;    // [64 q][65]  p_drop
  float* sDS = sP + kTile * kPitchS;  // [64 q][65]
  float* sL = sDS + kTile * kPitchS;
  float* sDelta = sL + kTile;
  int* sStart = reinterpret_cast<int*>(sDelta + kTile);
  int* sEnd = sStart + kTile;
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sEnd + kTile);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const Cell cell = cell_of(nk_tiles(p), kChunks, p.H);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int kt = cell.tile, k0 = kt * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  if (kChunks == 1) {
    load_tile_f32<DC>(sK, kPad, k + k0 * p.k_st, p.k_st, tid);
    load_tile_f32<DC>(sV, kPad, v + k0 * p.v_st, p.v_st, tid);
  }

  float dk[4][DC / 16], dv[4][DC / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the transposed walk: column kt of this batch row's [nq, nk] table
  const int nq = nq_tiles(p), nk = nk_tiles(p);
  const int* vis = p.vis + (long long)b * nq * nk + kt;
  for (int iq = 0; iq < nq; ++iq) {
    if (vis[iq * nk] == 0) continue;  // the same for the whole CTA
    const int q0 = iq * kTile;
    float s[4][4], dp[4][4];
    zero4x4(s);
    zero4x4(dp);
    for (int c = 0; c < kChunks; ++c) {
      __syncthreads();  // the previous products and updates are done
      if (kChunks > 1) {
        load_tile_f32<DC>(sK, kPad, k + k0 * p.k_st + c * DC, p.k_st, tid);
        load_tile_f32<DC>(sV, kPad, v + k0 * p.v_st + c * DC, p.v_st, tid);
      }
      load_tile_f32<DC>(sQ, kPad, q + q0 * p.q_st + c * DC, p.q_st, tid);
      load_tile_f32<DC>(sG, kPad, g + q0 * p.o_st + c * DC, p.o_st, tid);
      if (c == 0) {
        load_ranges(p, b, q0, sStart, sEnd, tid);
        if (tid < kTile) {
          sL[tid] = p.lse_in[(long long)bh * p.Tq + q0 + tid];
          sDelta[tid] = p.delta[(long long)bh * p.Tq + q0 + tid];
        }
        if (p.drop.on)
          flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
      }
      __syncthreads();
      // rows = queries ty*4+i, columns = keys tx+16j
      products_f32<DC, true>(sQ, sK, sG, sV, ty, tx, s, dp);
    }
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
    if (kChunks > 1 && oc != kChunks - 1) {
      __syncthreads();  // every thread is done with the last chunk's sQ/sG
      load_tile_f32<DC>(sQ, kPad, q + q0 * p.q_st + oc * DC, p.q_st, tid);
      load_tile_f32<DC>(sG, kPad, g + q0 * p.o_st + oc * DC, p.o_st, tid);
    }
    __syncthreads();

    // dv += p_dropᵀ·dO and dk += dsᵀ·q: rows = keys ty*4+i, cols = d
#pragma unroll 2
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], gv[DC / 16], qv[DC / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[qq * kPitchS + ty * 4 + i];
        dsv[i] = sDS[qq * kPitchS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DC / 16; ++j) {
        gv[j] = sG[qq * kPad + tx + 16 * j];
        qv[j] = sQ[qq * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC / 16; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + oc * DC;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + oc * DC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) {
      dkp[key * p.dk_st + tx + 16 * j] = dk[i][j] * p.sm_scale;
      dvp[key * p.dv_st + tx + 16 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: tensor cores through mma.sync.m16n8k16. In a fragment,
// g = lane / 4 and t = lane % 4; accumulator element e of an n-block sits at
// row g + 8·(e / 2), column 2t + e % 2.
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
  a[0] = hopper::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = hopper::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = hopper::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = hopper::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// A 64-row tile of W columns of a [T, D] bf16 matrix into `dst` (row pitch
// W+8) and, when `dst_t` is given, its transpose into `dst_t` (row pitch
// 72).
template <int W>
__device__ __forceinline__ void load_tile_bf16(bf* dst, bf* dst_t,
                                               const bf* src, long long st,
                                               int tid) {
  constexpr int kVec = W / 8, kPadT = kTile + 8;
  for (int i = tid; i < kTile * kVec; i += 128) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(src + r * st + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * (W + 8) + c) = x;
    if (dst_t != nullptr) {
      const bf* xe = reinterpret_cast<const bf*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst_t[(c + e) * kPadT + r] = xe[e];
    }
  }
}

// The forward for the output chunk of DC columns a CTA owns: S over the full
// head dim, P·V over the chunk (only V's chunk is loaded).
template <int D, int DC>
__global__ void __launch_bounds__(128) sparse_fwd_bf16_kernel(SparseParams p) {
  constexpr int kPadQK = D + 8, kPadT = kTile + 8, kChunks = D / DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sQ = reinterpret_cast<bf*>(smem_raw);                      // [64][D+8]
  bf* sK = sQ + kTile * kPadQK;                                  // [64][D+8]
  bf* sVt = sK + kTile * kPadQK;                                 // [DC][72]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sVt + DC * kPadT);  // [64][68]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // mma group id, thread in group
  const Cell cell = cell_of(nq_tiles(p), kChunks, p.H);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int iq = cell.tile, q0 = iq * kTile;
  const bf* q = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* k = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* v = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh +
                oc * DC;

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
  float o[DC / 8][4];
#pragma unroll
  for (int nb = 0; nb < DC / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;

  const int nk = nk_tiles(p);
  const int* vis = p.vis + ((long long)b * nq_tiles(p) + iq) * nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (vis[kt] == 0) continue;  // the same for the whole CTA
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous sK/sVt
    load_tile_bf16<D>(sK, nullptr, k + k0 * p.k_st, p.k_st, tid);
    load_tile_bf16<DC>(nullptr, sVt, v + k0 * p.v_st, p.v_st, tid);
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
    for (int nb = 0; nb < DC / 8; ++nb) {
      o[nb][0] *= corr[0]; o[nb][1] *= corr[0];
      o[nb][2] *= corr[1]; o[nb][3] *= corr[1];
    }

    // O += P·V
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb) {
        const bf* vrow = sVt + (nb * 8 + g) * kPadT + kk * 16 + tig * 2;
        mma_bf16_16816(o[nb], a, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  }

  bf* out = static_cast<bf*>(p.out) + b * p.o_sb + h * p.o_sh + oc * DC;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    bf* orow = out + rows[r] * p.o_st + tig * 2;
#pragma unroll
    for (int nb = 0; nb < DC / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(o[nb][2 * r] * inv, o[nb][2 * r + 1] * inv);
    if (tig == 0 && oc == 0)
      p.lse[(long long)bh * p.Tq + rows[r]] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward: wgmma on TMA-written tiles (hopper.cuh).
// ---------------------------------------------------------------------------
struct Bf16SparseBwdParams {
  CUtensorMap tq, tk, tv, tg;  // [B, H, T, D]: boxes of 64 rows x 64 values
  CUtensorMap tlse, tdelta;    // [1, 1, B*H, Tq] f32: boxes of 64 values
  CUtensorMap tse;             // [1, 1, B, Tq] int32: boxes of 64 values
  const float* lse;
  const float* delta;
  const int* se;
  const int* vis;              // [B, Tq / 64, Tk / 64]
  int lse_pitch, delta_pitch;  // floats between the rows of lse / delta
  bf* dq;
  bf* dk;
  bf* dv;
  int B, H, Tq, Tk;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

__device__ __forceinline__ void seed_keys(const flash::Dropout& d,
                                          uint32_t* key0, uint32_t* key1) {
  *key0 = *key1 = 0;
  if (d.on) {
    const unsigned long long s = static_cast<unsigned long long>(*d.seed);
    *key0 = static_cast<uint32_t>(s);
    *key1 = static_cast<uint32_t>(s >> 32);
  }
}

// Stores a warpgroup's 64 x W f32 accumulator (times `scale`) as bf16 rows
// row0 and row0 + 8 of a [T, D] matrix.
template <int W>
__device__ __forceinline__ void store_rows(bf* dst, long long st,
                                           const float (&acc)[W / 2],
                                           int row0, int t, float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bf* out = dst + (row0 + 8 * hh) * st + 2 * t;
#pragma unroll
    for (int nb = 0; nb < W / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + nb * 8) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * hh] * scale,
                                acc[4 * nb + 2 * hh + 1] * scale);
  }
}

// dq kernel: Q and dO stay; K and V stream through two stages. Byte offsets
// from the 1024-aligned base.
template <int D>
struct SDqLayout {
  static constexpr int kTileB = D / 64 * hopper::kBoxBytes;  // [64][D]
  static constexpr int kStage = 2 * kTileB;                  // K, V
  static constexpr int kBars = 2 * kTileB + 2 * kStage;
  static constexpr size_t kSmem = kBars + 3 * sizeof(uint64_t) + 1024;
};

template <int D>
__device__ __forceinline__ void load_sdq_stage(const Bf16SparseBwdParams& p,
                                               unsigned char* smem,
                                               uint64_t* bars, int j, int kt,
                                               int b, int h) {
  using L = SDqLayout<D>;
  unsigned char* st = smem + 2 * L::kTileB + (j & 1) * L::kStage;
  uint64_t* bar = &bars[j & 1];
  hopper::mbar_expect_tx(bar, 2 * L::kTileB);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load(st + c * hopper::kBoxBytes, &p.tk, bar, c * 64,
                     kt * kTile, h, b);
    hopper::tma_load(st + L::kTileB + c * hopper::kBoxBytes, &p.tv, bar,
                     c * 64, kt * kTile, h, b);
  }
}

// The dq CTA `cta` of the flat (chunk, q tile, b·h) grid.
template <int D, int DC>
__device__ __forceinline__ void sparse_dq_bf16(const Bf16SparseBwdParams& p,
                                               unsigned cta) {
  using L = SDqLayout<D>;
  constexpr int kChunks = D / DC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sG = smem + L::kTileB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // 2 + Q/dO

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = p.Tq / kTile, nk = p.Tk / kTile;
  const Cell cell = cell_of(nq, kChunks, p.H, cta);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int q0 = cell.tile * kTile;
  const int* vis = p.vis + ((long long)b * nq + cell.tile) * nk;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(&bars[2], 2 * L::kTileB);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load(sQ + c * hopper::kBoxBytes, &p.tq, &bars[2], c * 64,
                       q0, h, b);
      hopper::tma_load(sG + c * hopper::kBoxBytes, &p.tg, &bars[2], c * 64,
                       q0, h, b);
    }
  }
  __syncthreads();
  int kt = next_visible(vis, 1, 0, nk);
  int pk = kt;  // thread 0: the tile of the last stage it started
  if (tid == 0) {
    if (pk < nk) {
      load_sdq_stage<D>(p, smem, bars, 0, pk, b, h);
      pk = next_visible(vis, 1, pk + 1, nk);
      if (pk < nk) load_sdq_stage<D>(p, smem, bars, 1, pk, b, h);
    }
  }
  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float lse[2], delta[2];
  int st[2], en[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    lse[hh] = p.lse[(long long)bh * p.lse_pitch + row];
    delta[hh] = p.delta[(long long)bh * p.delta_pitch + row];
    unpack_se(p.se[(long long)b * p.Tq + row], st[hh], en[hh]);
  }
  float dq[DC / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  hopper::mbar_wait(&bars[2], 0);

  for (int j = 0; kt < nk; ++j) {
    const int k0 = kt * kTile;
    const unsigned char* sK = smem + 2 * L::kTileB + (j & 1) * L::kStage;
    const unsigned char* sV = sK + L::kTileB;
    hopper::mbar_wait(&bars[j & 1], (j >> 1) & 1);

    // S = Q·Kᵀ and dP = dO·Vᵀ, all K-major
    hopper::pin(s);
    hopper::pin(dp);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::mma_ss<64, 0>(s, hopper::desc_kmajor(sQ, ks),
                            hopper::desc_kmajor(sK, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::mma_ss<64, 0>(dp, hopper::desc_kmajor(sG, ks),
                            hopper::desc_kmajor(sV, ks), ks > 0);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(s);
    hopper::pin(dp);

    // ds = p·(dp − delta) in place of s; masked p is exactly 0 (selects)
    const uint32_t keep =
        p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop.threshold, bh,
                                          q0 + r0, k0, t)
                  : ~0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = q0 + r0 + 8 * hh;
      const bool ok = (key >= st[hh]) & (key < en[hh]) &
                      (!p.causal | (key <= row));
      float pr = hopper::ex2((s[i] * p.sm_scale - lse[hh]) * hopper::kLog2e);
      pr = ok ? pr : 0.f;
      const float dpv = (keep >> i) & 1u ? dp[i] * drop_scale : 0.f;
      s[i] = pr * (dpv - delta[hh]);
    }

    // dQ += dS·K over this CTA's chunk: dS from registers, K MN-major
    uint32_t a[4][4];
    hopper::acc_to_a(a, s);
    hopper::pin(dq);
    hopper::pin(a);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::mma_rs<DC, 1>(
          dq, a[kk],
          hopper::desc_mnmajor(sK + oc * (DC / 64) * hopper::kBoxBytes, kk),
          1);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(dq);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && pk < nk) {
      pk = next_visible(vis, 1, pk + 1, nk);
      if (pk < nk) load_sdq_stage<D>(p, smem, bars, j + 2, pk, b, h);
    }
    kt = next_visible(vis, 1, kt + 1, nk);
  }
  store_rows<DC>(p.dq + b * p.dq_sb + h * p.dq_sh + oc * DC, p.dq_st, dq,
                 q0 + r0, t, p.sm_scale);
}

// dk/dv kernel: K and V stay; Q, dO and the q tile's lse, delta and se rows
// (256 bytes each) stream through two stages. Byte offsets from the
// 1024-aligned base.
template <int D>
struct SDkvLayout {
  static constexpr int kTileB = D / 64 * hopper::kBoxBytes;  // [64][D]
  static constexpr int kStages = 2 * kTileB;                 // after K, V
  static constexpr int kStage = 2 * kTileB + 1024;  // Q, dO, the rows
  static constexpr int kBars = kStages + 2 * kStage;
  static constexpr size_t kSmem = kBars + 3 * sizeof(uint64_t) + 1024;
};

template <int D>
__device__ __forceinline__ void load_sdkv_stage(const Bf16SparseBwdParams& p,
                                                unsigned char* smem,
                                                uint64_t* bars, int j, int iq,
                                                int bh, int b, int h) {
  using L = SDkvLayout<D>;
  unsigned char* st = smem + L::kStages + (j & 1) * L::kStage;
  uint64_t* bar = &bars[j & 1];
  const int q0 = iq * kTile;
  hopper::mbar_expect_tx(bar, 2 * L::kTileB + 3 * 256);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load(st + c * hopper::kBoxBytes, &p.tq, bar, c * 64, q0, h,
                     b);
    hopper::tma_load(st + L::kTileB + c * hopper::kBoxBytes, &p.tg, bar,
                     c * 64, q0, h, b);
  }
  unsigned char* rows = st + 2 * L::kTileB;
  hopper::tma_load(rows, &p.tlse, bar, q0, bh, 0, 0);
  hopper::tma_load(rows + 256, &p.tdelta, bar, q0, bh, 0, 0);
  hopper::tma_load(rows + 512, &p.tse, bar, q0, b, 0, 0);
}

// The dk/dv CTA `cta` of the flat (chunk, key tile, b·h) grid.
template <int D, int DC>
__device__ __forceinline__ void sparse_dkv_bf16(const Bf16SparseBwdParams& p,
                                                unsigned cta) {
  using L = SDkvLayout<D>;
  constexpr int kChunks = D / DC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::kTileB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // 2 + K/V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = p.Tq / kTile, nk = p.Tk / kTile;
  const Cell cell = cell_of(nk, kChunks, p.H, cta);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int k0 = cell.tile * kTile;
  // the transposed walk: column kt of this batch row's [nq, nk] table
  const int* vis = p.vis + (long long)b * nq * nk + cell.tile;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(&bars[2], 2 * L::kTileB);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load(sK + c * hopper::kBoxBytes, &p.tk, &bars[2], c * 64,
                       k0, h, b);
      hopper::tma_load(sV + c * hopper::kBoxBytes, &p.tv, &bars[2], c * 64,
                       k0, h, b);
    }
  }
  __syncthreads();
  int iq = next_visible(vis, nk, 0, nq);
  int pq = iq;  // thread 0: the q tile of the last stage it started
  if (tid == 0) {
    if (pq < nq) {
      load_sdkv_stage<D>(p, smem, bars, 0, pq, bh, b, h);
      pq = next_visible(vis, nk, pq + 1, nq);
      if (pq < nq) load_sdkv_stage<D>(p, smem, bars, 1, pq, bh, b, h);
    }
  }
  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;

  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  float dk[DC / 2], dv[DC / 2], st_[32], dpt[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st_[i] = dpt[i] = 0.f;
  hopper::mbar_wait(&bars[2], 0);

  for (int j = 0; iq < nq; ++j) {
    const int q0 = iq * kTile;
    const unsigned char* sQ = smem + L::kStages + (j & 1) * L::kStage;
    const unsigned char* sG = sQ + L::kTileB;
    const float* sL = reinterpret_cast<const float*>(sQ + 2 * L::kTileB);
    const float* sD = sL + 64;
    const int* sSe = reinterpret_cast<const int*>(sL + 128);
    hopper::mbar_wait(&bars[j & 1], (j >> 1) & 1);

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, all K-major (row = key, column = query)
    hopper::pin(st_);
    hopper::pin(dpt);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::mma_ss<64, 0>(st_, hopper::desc_kmajor(sK, ks),
                            hopper::desc_kmajor(sQ, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::mma_ss<64, 0>(dpt, hopper::desc_kmajor(sV, ks),
                            hopper::desc_kmajor(sG, ks), ks > 0);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(st_);
    hopper::pin(dpt);

    // p_drop in place of sᵀ, ds in place of dpᵀ; masked p is exactly 0
    const uint32_t keep =
        p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop.threshold, bh,
                                          k0 + r0, q0, lane)
                  : ~0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
      const int key = k0 + r0 + 8 * hh;
      int start, end;
      unpack_se(sSe[c], start, end);
      const bool ok = (key >= start) & (key < end) &
                      (!p.causal | (key <= q0 + c));
      float pr = hopper::ex2((st_[i] * p.sm_scale - sL[c]) * hopper::kLog2e);
      pr = ok ? pr : 0.f;
      const bool kept = (keep >> i) & 1u;
      const float ds = pr * ((kept ? dpt[i] * drop_scale : 0.f) - sD[c]);
      st_[i] = kept ? pr * drop_scale : 0.f;
      dpt[i] = ds;
    }

    // dV += P_dropᵀ·dO and dK += dSᵀ·Q over this CTA's chunk: A from
    // registers, dO and Q MN-major
    uint32_t ap[4][4], ads[4][4];
    hopper::acc_to_a(ap, st_);
    hopper::acc_to_a(ads, dpt);
    hopper::pin(dv);
    hopper::pin(dk);
    hopper::pin(ap);
    hopper::pin(ads);
    hopper::wg_fence();
    constexpr int kChunkOff = DC / 64 * hopper::kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::mma_rs<DC, 1>(dv, ap[kk],
                            hopper::desc_mnmajor(sG + oc * kChunkOff, kk), 1);
      hopper::mma_rs<DC, 1>(dk, ads[kk],
                            hopper::desc_mnmajor(sQ + oc * kChunkOff, kk), 1);
    }
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(dv);
    hopper::pin(dk);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && pq < nq) {
      pq = next_visible(vis, nk, pq + 1, nq);
      if (pq < nq) load_sdkv_stage<D>(p, smem, bars, j + 2, pq, bh, b, h);
    }
    iq = next_visible(vis, nk, iq + 1, nq);
  }

  store_rows<DC>(p.dk + b * p.dk_sb + h * p.dk_sh + oc * DC, p.dk_st, dk,
                 k0 + r0, t, p.sm_scale);
  store_rows<DC>(p.dv + b * p.dv_sb + h * p.dv_sh + oc * DC, p.dv_st, dv,
                 k0 + r0, t, 1.f);
}

// The bf16 backward as one launch: the dk/dv CTAs, then the dq CTAs.
template <int D, int DC>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 1)
sparse_bwd_bf16_kernel(const __grid_constant__ Bf16SparseBwdParams p) {
  const unsigned n_dkv = (unsigned)(p.Tk / kTile) * (p.B * p.H) * (D / DC);
  if (blockIdx.x < n_dkv)
    sparse_dkv_bf16<D, DC>(p, blockIdx.x);
  else
    sparse_dq_bf16<D, DC>(p, blockIdx.x - n_dkv);
}

template <int D>
constexpr size_t smem_bwd_bf16() {
  return SDqLayout<D>::kSmem > SDkvLayout<D>::kSmem ? SDqLayout<D>::kSmem
                                                    : SDkvLayout<D>::kSmem;
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
template <int DC>
size_t smem_dq_f32() {
  return sizeof(float) * (4 * kTile * (DC + 1) + kTile * (kTile + 1) +
                          2 * kTile) + kRangeBytes + kKeepBytes;
}
template <int DC>
size_t smem_dkv_f32() {
  return sizeof(float) * (4 * kTile * (DC + 1) + 2 * kTile * (kTile + 1) +
                          2 * kTile) + kRangeBytes + kKeepBytes;
}
template <int D, int DC>
size_t smem_fwd_bf16() {
  return sizeof(bf) * (2 * kTile * (D + 8) + DC * (kTile + 8)) + kKeepBytes;
}

// Opts a kernel into its dynamic shared memory once per device, then
// launches it on `stream` over `blocks` CTAs of the flat grid.
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, unsigned* configured, const Params& p,
                   unsigned blocks, int threads, size_t smem,
                   cudaStream_t stream) {
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
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// one flag word per (kernel, dtype, head dim): slot = (dtype·4 + D/64 - 1)·3
unsigned configured[24] = {};

template <int D>
int slot_of(int dtype) {
  return (dtype * 4 + D / 64 - 1) * 3;
}

template <int D>
cudaError_t launch_fwd(const SparseParams& p, int dtype, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  const int slot = slot_of<D>(dtype);
  const unsigned tiles = (unsigned)(p.Tq / kTile) * (unsigned)(p.B * p.H);
  if (dtype == 0)
    return launch(sparse_fwd_f32_kernel<D>, &configured[slot], p, tiles, 256,
                  smem_fwd_f32<D>(), s);
  return launch(sparse_fwd_bf16_kernel<D, DC>, &configured[slot], p,
                tiles * (D / DC), 128, smem_fwd_bf16<D, DC>(), s);
}

template <int D>
cudaError_t launch_bwd_f32(const SparseParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  const int slot = slot_of<D>(0);
  const unsigned bh = (unsigned)(p.B * p.H), chunks = D / DC;
  cudaError_t err = launch(sparse_dq_f32_kernel<D, DC>, &configured[slot + 1],
                           p, (unsigned)(p.Tq / kTile) * bh * chunks, 256,
                           smem_dq_f32<DC>(), s);
  if (err != cudaSuccess) return err;
  return launch(sparse_dkv_f32_kernel<D, DC>, &configured[slot + 2], p,
                (unsigned)(p.Tk / kTile) * bh * chunks, 256,
                smem_dkv_f32<DC>(), s);
}

template <int D>
cudaError_t launch_bwd_bf16(const Bf16SparseBwdParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  const unsigned tiles = (unsigned)(p.Tq / kTile + p.Tk / kTile);
  return launch(sparse_bwd_bf16_kernel<D, DC>, &configured[slot_of<D>(1) + 1],
                p, tiles * (unsigned)(p.B * p.H) * (D / DC), 128,
                smem_bwd_bf16<D>(), s);
}

bool shape_ok(int Tq, int Tk, int D, int dtype) {
  return (dtype == 0 || dtype == 1) &&
         (D == 64 || D == 128 || D == 192 || D == 256) && Tq > 0 && Tk > 0 &&
         Tq % kTile == 0 && Tk % kTile == 0 && Tk < (1 << 15);
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

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128, 192, 256}; Tq, Tk
// multiples of 64. Strides are in elements, three per tensor: (batch, head,
// token); the head dim is contiguous. se is [B, Tq] int32, vis
// [B, Tq/64, Tk/64] int32, lse [B*H, Tq] f32. With dropout != 0, `seed`
// points at one int64 on the device and a probability is dropped iff its
// Philox word < `threshold`; kept ones are scaled by `drop_scale`. Returns
// a cudaError_t (0 = launched).
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
  switch (D) {
    case 64: return (int)launch_fwd<64>(p, dtype, s);
    case 128: return (int)launch_fwd<128>(p, dtype, s);
    case 192: return (int)launch_fwd<192>(p, dtype, s);
    default: return (int)launch_fwd<256>(p, dtype, s);
  }
}

// The float32 backward: launches the dq kernel, then the dk/dv kernel, on
// `stream`. lse and delta (= Σ_d dO·out) are [B*H, Tq] f32; strides as in
// the forward, dO's in g_strides. Returns a cudaError_t (0 = launched).
int flash_attention_sparse_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* se, const int* vis,
    void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* g_strides,
    const long long* dq_strides, const long long* dk_strides,
    const long long* dv_strides, float sm_scale, int causal,
    const long long* seed, unsigned threshold, float drop_scale, int dropout,
    void* stream) {
  if (!shape_ok(Tq, Tk, D, 0) || (causal && Tq != Tk))
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
  switch (D) {
    case 64: return (int)launch_bwd_f32<64>(p, s);
    case 128: return (int)launch_bwd_f32<128>(p, s);
    case 192: return (int)launch_bwd_f32<192>(p, s);
    default: return (int)launch_bwd_f32<256>(p, s);
  }
}

// The bfloat16 backward. `tensors` holds the tensor descriptions
// (hopper::kDescLen int64 each) of q, k, v, dO ([B, H, T, D] bf16), lse and
// delta ([1, 1, B*H, Tq] f32) and se ([1, 1, B, Tq] int32) in that order;
// vis as in the forward; output strides are in elements. Dropout as in the
// forward. One launch computes dq, dk and dv. Returns a cudaError_t.
int flash_attention_sparse_bwd_bf16(
    const long long* tensors, const int* vis, void* dq, void* dk, void* dv,
    int B, int H, int Tq, int Tk, int D, long long dq_sb, long long dq_sh,
    long long dq_st, long long dk_sb, long long dk_sh, long long dk_st,
    long long dv_sb, long long dv_sh, long long dv_st, float sm_scale,
    int causal, const long long* seed, unsigned threshold, float drop_scale,
    int dropout, void* stream) {
  if (!shape_ok(Tq, Tk, D, 1) || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  constexpr int n = hopper::kDescLen;
  Bf16SparseBwdParams p;
  CUtensorMap* maps[4] = {&p.tq, &p.tk, &p.tv, &p.tg};
  CUtensorMap* rows[3] = {&p.tlse, &p.tdelta, &p.tse};
  cudaError_t err;
  for (int i = 0; i < 4; ++i)
    if ((err = hopper::make_map(maps[i], tensors + i * n, true, 64, 64)) !=
        cudaSuccess)
      return (int)err;
  // se's int32 values travel as 4-byte elements: TMA copies their bits
  for (int i = 0; i < 3; ++i)
    if ((err = hopper::make_map(rows[i], tensors + (4 + i) * n, false, 64,
                                1)) != cudaSuccess)
      return (int)err;
  const long long* lse = tensors + 4 * n;
  const long long* delta = tensors + 5 * n;
  p.lse = reinterpret_cast<const float*>(lse[0]);
  p.delta = reinterpret_cast<const float*>(delta[0]);
  p.lse_pitch = (int)(lse[5] / 4);  // the byte stride of the rows
  p.delta_pitch = (int)(delta[5] / 4);
  p.se = reinterpret_cast<const int*>(tensors[6 * n]);
  p.vis = vis;
  p.dq = static_cast<bf*>(dq);
  p.dk = static_cast<bf*>(dk);
  p.dv = static_cast<bf*>(dv);
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_st = dq_st;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_st = dk_st;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_st = dv_st;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd_bf16<64>(p, s);
    case 128: return (int)launch_bwd_bf16<128>(p, s);
    case 192: return (int)launch_bwd_bf16<192>(p, s);
    default: return (int)launch_bwd_bf16<256>(p, s);
  }
}

// Dynamic shared memory of the bf16 backward kernel at head dim D, bytes.
int flash_attention_sparse_bwd_bf16_smem(int D) {
  switch (D) {
    case 64: return (int)smem_bwd_bf16<64>();
    case 128: return (int)smem_bwd_bf16<128>();
    case 192: return (int)smem_bwd_bf16<192>();
    case 256: return (int)smem_bwd_bf16<256>();
    default: return 0;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
