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
// 192 and 256. Above 128 a CTA owns one 64-wide chunk of the output's head
// dim (the accumulators of a wider one would not fit in registers beside
// the scores, nor the f32 tiles in shared memory): the chunks are a third
// grid factor and each recomputes the scores over the full head dim.
//
// Every kernel walks only the visible tiles with a ring of two stages one
// visible tile ahead of the math, so a skipped tile costs no load and no
// barrier, and builds the element mask from the row's
// (start, end), the column and the causal test with selects (no branch);
// exp is ex2.approx; dropout bits are drawn in registers for the lane's own
// accumulator elements (keep_bits_rows / keep_bits_cols). Four warps own 16
// rows each of the 64x64 score block, so the accumulators have the wgmma
// layout and these loops are one code whatever the product runs on.
//   bf16 forward: one warpgroup on wgmma over TMA tiles (hopper.cuh), as the
//         dense bf16 forward (flash_attention_fwd.cu): S = Q·Kᵀ with both
//         K-major, then O += P·V with P rounded to bf16 in registers as the
//         A operand (as the TPU kernel casts it) and V read MN-major through
//         the transpose flag, so V is never transposed. Thread 0 starts Q's
//         copy before it scans the tile table, then keeps K and V's chunk of
//         the next visible tile in flight. The rescale of a tile that adds
//         nothing is exactly 1 (a select where the max does not move), so
//         ex2.approx keeps skipping bitwise invisible.
//   bf16 backward: wgmma on TMA tiles, as the dense backward: a dq CTA
//         computes S = Q·Kᵀ and dP = dO·Vᵀ (all K-major), then dQ += dS·K
//         with dS in registers and K read MN-major; a dk/dv CTA computes
//         Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q with
//         Pᵀ and dSᵀ in registers and dO, Q read MN-major. Its stages carry
//         K and V for dq; Q, dO and the tile's lse, delta and se rows for
//         dk/dv.
//   f32 backward: every product in 3xTF32 on mma.sync.m16n8k8 (tf32x3.cuh,
//         the dense f32 backward's design): S and dP in kPartialDepth-column
//         partial sums, dQ, dK and dV into a zeroed partial sum a tile added
//         with one round-to-nearest add (the tensor core's sums round toward
//         zero). Tiles arrive by cp.async in a two-stage ring (4 floats of
//         row padding: conflict-free fragment reads), a step (visible tile,
//         head-dim chunk) ahead of the math; a dk/dv step also brings the q
//         tile's lse, delta and se rows. Above d = 128 the head dim streams
//         through the ring in 64-wide chunks, the CTA's own chunk last.
//   f32 forward: both products in 3xTF32 on mma.sync.m16n8k8, the dense
//         f32 forward's design (flash_attention_fwd.cu) over the visible
//         tiles: S in kPartialDepth-column partial sums, split and summed as
//         the f32 backward's dq CTAs recompute it (above d = 128, those of
//         the last output chunk, whose chunk order is 0, 1, ...), so the lse
//         written here is that of the S they form; then O += P_drop·V, P
//         from the accumulators and V's fragments read from the padded tile
//         as it lies, a tile's product into a zeroed partial sum. Q stays
//         in shared memory; K and V's chunk arrive by cp.async in the
//         two-stage ring, a step (visible tile, head-dim chunk) ahead of the
//         math. Above d = 128 K streams in 64-wide chunks in order, so every
//         chunk CTA of a q tile forms the same S, m and l bit for bit and
//         chunk 0 alone writes the lse. 87,040 bytes of shared memory at
//         d = 64, two CTAs an SM (a third, by a ring of three single
//         tiles, measured no faster on the H100; PERF.md §6).
// Both backwards run as one launch of both kinds of CTA (the dk/dv ones
// first, the dq ones filling the tail): walks are short (~2.4 tiles at the
// NMT shapes), so per-CTA set-up weighs as much as the products.
//
// Bound. Work scales with the visible (i, j) pairs, not with Tq·Tk: 4·d flops
// a pair forward, 10·d backward (three TF32 products each in f32). At the NMT
// shapes (T = 256, d = 64, packed sentences of ~26 tokens) most tiles hold
// few visible pairs, so a perfect kernel would be bound by the bytes of q,
// k, v, out (and dO, dq, dk, dv); a processed tile still costs its full
// 64x64 products here, and a walk of ~2.4 tiles leaves the per-CTA set-up
// (barriers, the first loads) as large as the products. Times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX package
constexpr int kTile = 64;          // q rows and keys per tile
using bf = __nv_bfloat16;

struct SparseParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward only
  const int* se;       // [B, Tq] packed (start << 16) | end
  const int* vis;      // [B, Tq / 64, Tk / 64] tile visibility
  const float* lse_in;  // [B*H, Tq] rows lse_pitch floats apart (backward)
  const float* delta;   // [B*H, Tq] rows delta_pitch floats apart (backward)
  int lse_pitch, delta_pitch;
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
  int n_dkv;  // f32 backward: the launch's first n_dkv CTAs are dk/dv CTAs
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

__device__ __forceinline__ void unpack_se(int se, int& start, int& end) {
  start = static_cast<int>(static_cast<unsigned>(se) >> 16);
  end = se & 0xFFFF;
}

// The first visible tile at or after `i` of a walk of `n` tiles whose bits
// are vis[i * stride]; n or more when there is none.
__device__ __forceinline__ int next_visible(const int* vis, int stride, int i,
                                            int n) {
  while (i < n && __ldg(vis + (long long)i * stride) == 0) ++i;
  return i;
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
        p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop, bh,
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
        p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop, bh,
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
// bf16 forward: wgmma on TMA-written tiles (hopper.cuh), the dense bf16
// forward's design over the visible key tiles.
// ---------------------------------------------------------------------------
struct Bf16SparseFwdParams {
  CUtensorMap tq, tk, tv;  // [B, H, T, D]: boxes of 64 rows x 64 values
  const int* se;           // [B, Tq] rows se_pitch ints apart
  const int* vis;          // [B, Tq / 64, Tk / 64]
  int se_pitch;
  bf* out;
  float* lse;              // [B*H, Tq]
  int B, H, Tq, Tk;
  long long o_sb, o_sh, o_st;
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

// Byte offsets from the 1024-aligned base: Q, then two stages of K and the
// CTA's chunk of V, then the barriers.
template <int D, int DC>
struct SFwdLayout {
  static constexpr int kTileB = D / 64 * hopper::kBoxBytes;   // [64][D]
  static constexpr int kVTile = DC / 64 * hopper::kBoxBytes;  // [64][DC]
  static constexpr int kStage = kTileB + kVTile;
  static constexpr int kBars = kTileB + 2 * kStage;
  static constexpr size_t kSmem = kBars + 3 * sizeof(uint64_t) + 1024;
};

// Thread 0: the copies of key tile kt (K, V's chunk oc) into stage j % 2,
// completing that stage's barrier.
template <int D, int DC>
__device__ __forceinline__ void load_sfwd_stage(const Bf16SparseFwdParams& p,
                                                unsigned char* smem,
                                                uint64_t* bars, int j, int kt,
                                                int b, int h, int oc) {
  using L = SFwdLayout<D, DC>;
  unsigned char* st = smem + L::kTileB + (j & 1) * L::kStage;
  uint64_t* bar = &bars[j & 1];
  hopper::mbar_expect_tx(bar, L::kStage);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load(st + c * hopper::kBoxBytes, &p.tk, bar, c * 64,
                     kt * kTile, h, b);
#pragma unroll
  for (int c = 0; c < DC / 64; ++c)
    hopper::tma_load(st + L::kTileB + c * hopper::kBoxBytes, &p.tv, bar,
                     oc * DC + c * 64, kt * kTile, h, b);
}

// One CTA per (DC-wide output chunk, 64-row q tile, b·h) of the flat grid:
// S over the full head dim, P·V over the chunk (only V's chunk is loaded).
template <int D, int DC>
__global__ void __launch_bounds__(128, D == 64 ? 4 : 1)
sparse_fwd_bf16_kernel(const __grid_constant__ Bf16SparseFwdParams p) {
  using L = SFwdLayout<D, DC>;
  constexpr int kChunks = D / DC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // 2 + Q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = p.Tq / kTile, nk = p.Tk / kTile;
  const Cell cell = cell_of(nq, kChunks, p.H);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int q0 = cell.tile * kTile;
  const int* vis = p.vis + ((long long)b * nq + cell.tile) * nk;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(&bars[2], L::kTileB);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_load(sQ + c * hopper::kBoxBytes, &p.tq, &bars[2], c * 64,
                       q0, h, b);
  }
  __syncthreads();
  int kt = next_visible(vis, 1, 0, nk);
  int pk = kt;  // thread 0: the tile of the last stage it started
  if (tid == 0 && pk < nk) {
    load_sfwd_stage<D, DC>(p, smem, bars, 0, pk, b, h, oc);
    pk = next_visible(vis, 1, pk + 1, nk);
    if (pk < nk) load_sfwd_stage<D, DC>(p, smem, bars, 1, pk, b, h, oc);
  }
  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  int st[2], en[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    unpack_se(p.se[(long long)b * p.se_pitch + q0 + r0 + 8 * hh], st[hh],
              en[hh]);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DC / 2], s[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  hopper::mbar_wait(&bars[2], 0);

  for (int j = 0; kt < nk; ++j) {
    const int k0 = kt * kTile;
    const unsigned char* sK = smem + L::kTileB + (j & 1) * L::kStage;
    hopper::mbar_wait(&bars[j & 1], (j >> 1) & 1);

    // S = Q·Kᵀ, both K-major
    hopper::pin(s);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::mma_ss<64, 0>(s, hopper::desc_kmajor(sQ, ks),
                            hopper::desc_kmajor(sK, ks), ks > 0);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(s);

    // the element mask (selects, no branch); bit i of `ok` is element i
    uint32_t ok = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const bool vis_e = (key >= st[hh]) & (key < en[hh]) &
                         (!p.causal | (key <= q0 + r0 + 8 * hh));
      ok |= (vis_e ? 1u : 0u) << i;
      s[i] = vis_e ? s[i] * p.sm_scale : kNegInf;
      mx[hh] = fmaxf(mx[hh], s[i]);
    }

    // online softmax over the 4 lanes that share a row; a max that does
    // not move rescales by exactly 1
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = m_new == m[hh]
                     ? 1.f
                     : hopper::ex2((m[hh] - m_new) * hopper::kLog2e);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const float e = hopper::ex2((s[i] - m[hh]) * hopper::kLog2e);
      s[i] = (ok >> i) & 1u ? e : 0.f;
      sum[hh] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l[hh] = l[hh] * corr[hh] + sum[hh];
    }
    if (p.drop.on) {  // drop after the row sum: lse is over the undropped p
      const uint32_t keep = flash::keep_bits_rows(
          key0, key1, p.drop, bh, q0 + r0, k0, t);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = (keep >> i) & 1u ? s[i] * p.drop.scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P·V over this CTA's chunk: P from registers, V MN-major
    uint32_t a[4][4];
    hopper::acc_to_a(a, s);
    hopper::pin(o);
    hopper::pin(a);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::mma_rs<DC, 1>(o, a[kk], hopper::desc_mnmajor(sK + L::kTileB, kk),
                            1);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(o);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && pk < nk) {
      pk = next_visible(vis, 1, pk + 1, nk);
      if (pk < nk) load_sfwd_stage<D, DC>(p, smem, bars, j + 2, pk, b, h, oc);
    }
    kt = next_visible(vis, 1, kt + 1, nk);
  }

  bf* out = p.out + b * p.o_sb + h * p.o_sh + oc * DC;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
    const float inv = 1.f / l_safe;
    bf* orow = out + row * p.o_st + 2 * t;
#pragma unroll
    for (int nb = 0; nb < DC / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(o[4 * nb + 2 * hh] * inv,
                                o[4 * nb + 2 * hh + 1] * inv);
    if (t == 0 && oc == 0)
      p.lse[(long long)bh * p.Tq + row] = m[hh] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// f32 forward and backward: 3xTF32 on the tensor cores (mma.sync.m16n8k8,
// tf32x3.cuh), tiles by cp.async, the dense f32 kernels' designs over the
// visible tiles. Four warps; warp w owns rows 16w..16w+15 of the 64x64 score block,
// so accumulator register 4·nb + 2·h + e of lane (g, t) is row 16w + g + 8h,
// column 8·nb + 2t + e: the layout of the bf16 kernels' wgmma accumulators,
// whose element and keep-bit code these kernels share.
// ---------------------------------------------------------------------------

// Shared memory of the f32 backward, in floats. Up to d = 128 (one chunk)
// the CTA's own tiles stay (Q and dO for dq; K and V for dk/dv) and a stage
// of the two-stage ring holds the two streamed tiles (K, V; or Q, dO, with
// the q tile's 64 lse, delta and se values for dk/dv). Above that every
// step streams all four tiles of one 64-wide head-dim chunk.
template <int D, int DC>
struct SF32Layout {
  static constexpr int kChunks = D / DC;
  static constexpr int kTileF = kTile * tf32x3::pitch_f32<DC>();
  static constexpr int kResident = kChunks == 1 ? 2 * kTileF : 0;
  static constexpr int kStage = (kChunks == 1 ? 2 : 4) * kTileF;
  static constexpr int kRows = 3 * kTile;  // lse, delta, se
  static constexpr size_t dq_bytes() {
    return sizeof(float) * (kResident + 2 * kStage);
  }
  static constexpr size_t dkv_bytes() {
    return sizeof(float) * (kResident + 2 * (kStage + kRows));
  }
  static constexpr size_t bytes() {
    return dkv_bytes() > dq_bytes() ? dkv_bytes() : dq_bytes();
  }
};

// A walk over the visible tiles of one row (stride 1) or column (stride nk)
// of the tile table, a step per (tile, head-dim chunk c). The backward takes
// a tile's chunks from the CTA's own chunk oc + 1 on, so the last one, whose
// tiles its output product reads, is oc; the forward takes them in order.
// Every thread walks alike.
struct Walk {
  const int* vis;
  int stride, n, tile, c;
  __device__ __forceinline__ Walk(const int* v, int s, int n_)
      : vis(v), stride(s), n(n_), tile(next_visible(v, s, 0, n_)), c(0) {}
  __device__ __forceinline__ bool more() const { return tile < n; }
  __device__ __forceinline__ void advance(int chunks) {
    if (++c == chunks) {
      c = 0;
      tile = next_visible(vis, stride, tile + 1, n);
    }
  }
};

// Shared memory of the f32 forward, in floats: Q resident ([64][D + 4]),
// then two stages, each K's step chunk and the CTA's chunk of V ([64][DC +
// 4] each: the whole head dim up to d = 128, else 64 columns).
template <int D, int DC>
struct SF32FwdLayout {
  static constexpr int kChunks = D / DC;
  static constexpr int kQ = kTile * tf32x3::pitch_f32<D>();
  static constexpr int kTileF = kTile * tf32x3::pitch_f32<DC>();
  static constexpr int kStage = 2 * kTileF;  // K's chunk, V's chunk
  static constexpr size_t bytes() { return sizeof(float) * (kQ + 2 * kStage); }
};

// One CTA per (DC-wide output chunk, 64-row q tile, b·h) of the flat grid,
// the chunk fastest. It walks the visible key tiles in steps of one K chunk
// (in order: every chunk CTA of a q tile forms the same S, m and l bit for
// bit) over a two-stage cp.async ring, one step ahead of the math; a tile's
// last step also brings V's chunk oc. S = Q·Kᵀ in kPartialDepth-column
// partial sums, split and summed as the f32 backward's dq CTAs recompute it
// (above d = 128, those of the last chunk), so the lse written here is that
// of the S they form; at a tile's
// last step the branch-free element loop, the online softmax (a rescale of
// exactly 1 where the max holds) and O += P_drop·V, P from registers and V
// as it lies (acc_product_tf32), into a zeroed partial added to the
// rescaled O.
template <int D, int DC>
__global__ void __launch_bounds__(128) sparse_fwd_f32_kernel(SparseParams p) {
  using namespace tf32x3;
  using L = SF32FwdLayout<D, DC>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;
  float* stages = smem_f32 + L::kQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = nq_tiles(p), nk = nk_tiles(p);
  const Cell cell = cell_of(nq, kChunks, p.H);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int q0 = cell.tile * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                   q0 * p.q_st;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh +
                   oc * DC;
  const int* vis = p.vis + ((long long)b * nq + cell.tile) * nk;

  // step j: the load walk's (tile, K chunk) into stage j % 2
  auto load_step = [&](int j, const Walk& w) {
    float* st = stages + (j & 1) * L::kStage;
    const int k0 = w.tile * kTile;
    copy_tile<DC>(st, k + k0 * p.k_st + w.c * DC, p.k_st, kTile, tid);
    if (w.c == kChunks - 1)
      copy_tile<DC>(st + L::kTileF, v + k0 * p.v_st, p.v_st, kTile, tid);
  };
  copy_tile<D>(sQ, q, p.q_st, kTile, tid);
  Walk walk(vis, 1, nk), load = walk;
  for (int j = 0; j < 2; ++j) {
    if (load.more()) {
      load_step(j, load);
      load.advance(kChunks);
    }
    cp_async_commit();
  }

  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  int st[2], en[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    unpack_se(p.se[(long long)b * p.Tq + q0 + r0 + 8 * hh], st[hh], en[hh]);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DC / 2], s[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;

  for (int j = 0; walk.more(); ++j) {
    const int k0 = walk.tile * kTile, c = walk.c;
    const float* stg = stages + (j & 1) * L::kStage;
    cp_async_wait<1>();
    __syncthreads();  // step j's tiles have landed, from every thread

    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    product_tf32<DC, pitch_f32<D>(), pitch_f32<DC>()>(s, sQ + c * DC, stg,
                                                      warp * 16, g, t);

    if (c == kChunks - 1) {
      // the element mask (selects, no branch); bit i of `ok` is element i
      uint32_t ok = 0u;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const bool vis_e = (key >= st[hh]) & (key < en[hh]) &
                           (!p.causal | (key <= q0 + r0 + 8 * hh));
        ok |= (vis_e ? 1u : 0u) << i;
        s[i] = vis_e ? s[i] * p.sm_scale : kNegInf;
        mx[hh] = fmaxf(mx[hh], s[i]);
      }

      // online softmax over the 4 lanes that share a row; a max that does
      // not move rescales by exactly 1
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        corr[hh] = m_new == m[hh]
                       ? 1.f
                       : hopper::ex2((m[hh] - m_new) * hopper::kLog2e);
        m[hh] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const float e = hopper::ex2((s[i] - m[hh]) * hopper::kLog2e);
        s[i] = (ok >> i) & 1u ? e : 0.f;
        sum[hh] += s[i];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
        l[hh] = l[hh] * corr[hh] + sum[hh];
      }
      if (p.drop.on) {  // drop after the row sum: lse is over the undropped p
        const uint32_t keep = flash::keep_bits_rows(
            key0, key1, p.drop, bh, q0 + r0, k0, t);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = (keep >> i) & 1u ? s[i] * p.drop.scale : 0.f;
      }
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      // O += P_drop·V over this CTA's chunk of V
      acc_product_tf32<DC>(o, s, stg + L::kTileF, g, t);
    }
    __syncthreads();  // every warp is done with this stage
    if (load.more()) {
      load_step(j + 2, load);
      load.advance(kChunks);
    }
    cp_async_commit();
    walk.advance(kChunks);
  }
  cp_async_wait<0>();

  float l_safe[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_safe[hh] = l[hh] == 0.f ? 1.f : l[hh];
    if (t == 0 && oc == 0)
      p.lse[(long long)bh * p.Tq + q0 + r0 + 8 * hh] =
          m[hh] + logf(l_safe[hh]);
  }
  store_rows_f32<DC>(static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh +
                         oc * DC,
                     p.o_st, o, q0 + r0, p.Tq, t, 1.f / l_safe[0],
                     1.f / l_safe[1]);
}

// A dq CTA: one per (DC-wide output chunk, 64-row q tile, b·h), numbered
// `cta` (the chunk fastest), walks the visible key tiles over a two-stage
// cp.async ring, one step ahead of the math.
template <int D, int DC>
__device__ __forceinline__ void sparse_dq_f32(const SparseParams& p,
                                              unsigned cta) {
  using namespace tf32x3;
  using L = SF32Layout<D, DC>;
  constexpr int kChunks = L::kChunks, kTileF = L::kTileF;
  extern __shared__ __align__(16) float smem_f32[];
  float* stages = smem_f32 + L::kResident;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = nq_tiles(p), nk = nk_tiles(p);
  const Cell cell = cell_of(nq, kChunks, p.H, cta);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int q0 = cell.tile * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                   q0 * p.q_st;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.dout) + b * p.o_sb +
                    h * p.o_sh + q0 * p.o_st;
  const int* vis = p.vis + ((long long)b * nq + cell.tile) * nk;

  // step j: the load walk's (tile, chunk) into stage j % 2
  auto load_step = [&](int j, const Walk& w) {
    float* st = stages + (j & 1) * L::kStage;
    const int k0 = w.tile * kTile, c = (oc + 1 + w.c) % kChunks * DC;
    if (kChunks > 1) {
      copy_tile<DC>(st + 2 * kTileF, q + c, p.q_st, kTile, tid);
      copy_tile<DC>(st + 3 * kTileF, gg + c, p.o_st, kTile, tid);
    }
    copy_tile<DC>(st, k + k0 * p.k_st + c, p.k_st, kTile, tid);
    copy_tile<DC>(st + kTileF, v + k0 * p.v_st + c, p.v_st, kTile, tid);
  };
  if (kChunks == 1) {
    copy_tile<DC>(smem_f32, q, p.q_st, kTile, tid);
    copy_tile<DC>(smem_f32 + kTileF, gg, p.o_st, kTile, tid);
  }
  Walk walk(vis, 1, nk), load = walk;
  for (int j = 0; j < 2; ++j) {
    if (load.more()) {
      load_step(j, load);
      load.advance(kChunks);
    }
    cp_async_commit();
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
    lse[hh] = p.lse_in[(long long)bh * p.lse_pitch + row];
    delta[hh] = p.delta[(long long)bh * p.delta_pitch + row];
    unpack_se(p.se[(long long)b * p.Tq + row], st[hh], en[hh]);
  }
  float dq[DC / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;

  for (int j = 0; walk.more(); ++j) {
    const int k0 = walk.tile * kTile;
    const float* stg = stages + (j & 1) * L::kStage;
    const float* sK = stg;
    const float* sV = stg + kTileF;
    const float* sQ = kChunks == 1 ? smem_f32 : stg + 2 * kTileF;
    const float* sG = sQ + kTileF;
    cp_async_wait<1>();
    __syncthreads();  // step j's tiles have landed, from every thread

    if (walk.c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    }
    // S = Q·Kᵀ and dP = dO·Vᵀ over this chunk of the head dim
    product_tf32<DC>(s, sQ, sK, warp * 16, g, t);
    product_tf32<DC>(dp, sG, sV, warp * 16, g, t);

    if (walk.c == kChunks - 1) {
      // ds = p·(dp − delta) in place of s; masked p is exactly 0 (selects)
      const uint32_t keep =
          p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop,
                                            bh, q0 + r0, k0, t)
                    : ~0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const bool ok = (key >= st[hh]) & (key < en[hh]) &
                        (!p.causal | (key <= q0 + r0 + 8 * hh));
        float pr = hopper::ex2((s[i] * p.sm_scale - lse[hh]) * hopper::kLog2e);
        pr = ok ? pr : 0.f;
        const float dpv = (keep >> i) & 1u ? dp[i] * drop_scale : 0.f;
        s[i] = pr * (dpv - delta[hh]);
      }
      // dQ += dS·K over this CTA's chunk (the step's K is chunk oc)
      acc_product_tf32<DC>(dq, s, sK, g, t);
    }
    __syncthreads();  // every warp is done with this stage
    if (load.more()) {
      load_step(j + 2, load);
      load.advance(kChunks);
    }
    cp_async_commit();
    walk.advance(kChunks);
  }
  cp_async_wait<0>();
  store_rows_f32<DC>(static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
                         oc * DC,
                     p.dq_st, dq, q0 + r0, p.Tq, t, p.sm_scale, p.sm_scale);
}

// A dk/dv CTA: one per (DC-wide output chunk, 64-key tile, b·h), numbered
// `cta`, walks the visible q tiles (column kt of the tile table) over the
// same ring; the last step of a q tile also brings its lse, delta and se.
template <int D, int DC>
__device__ __forceinline__ void sparse_dkv_f32(const SparseParams& p,
                                               unsigned cta) {
  using namespace tf32x3;
  using L = SF32Layout<D, DC>;
  constexpr int kChunks = L::kChunks, kTileF = L::kTileF;
  constexpr int kStage = L::kStage + L::kRows;
  extern __shared__ __align__(16) float smem_f32[];
  float* stages = smem_f32 + L::kResident;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = nq_tiles(p), nk = nk_tiles(p);
  const Cell cell = cell_of(nk, kChunks, p.H, cta);
  const int bh = cell.bh, b = cell.b, h = cell.h, oc = cell.chunk;
  const int k0 = cell.tile * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh +
                   k0 * p.k_st;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh +
                   k0 * p.v_st;
  const float* gg = static_cast<const float*>(p.dout) + b * p.o_sb +
                    h * p.o_sh;
  // the transposed walk: column kt of this batch row's [nq, nk] table
  const int* vis = p.vis + (long long)b * nq * nk + cell.tile;

  auto load_step = [&](int j, const Walk& w) {
    float* st = stages + (j & 1) * kStage;
    const int q0 = w.tile * kTile, c = (oc + 1 + w.c) % kChunks * DC;
    if (kChunks > 1) {
      copy_tile<DC>(st + 2 * kTileF, k + c, p.k_st, kTile, tid);
      copy_tile<DC>(st + 3 * kTileF, v + c, p.v_st, kTile, tid);
    }
    copy_tile<DC>(st, q + q0 * p.q_st + c, p.q_st, kTile, tid);
    copy_tile<DC>(st + kTileF, gg + q0 * p.o_st + c, p.o_st, kTile, tid);
    if (w.c == kChunks - 1) {  // the rows the element loop reads
      float* rows = st + L::kStage;  // lse, delta, then se
      const int i = tid % kTile;
      cp_async4(rows + tid,
                tid < kTile ? p.lse_in + (long long)bh * p.lse_pitch + q0 + i
                            : p.delta + (long long)bh * p.delta_pitch + q0 + i,
                true);
      if (tid < kTile)
        cp_async4(rows + 2 * kTile + i, p.se + (long long)b * p.Tq + q0 + i,
                  true);
    }
  };
  if (kChunks == 1) {
    copy_tile<DC>(smem_f32, k, p.k_st, kTile, tid);
    copy_tile<DC>(smem_f32 + kTileF, v, p.v_st, kTile, tid);
  }
  Walk walk(vis, nk, nq), load = walk;
  for (int j = 0; j < 2; ++j) {
    if (load.more()) {
      load_step(j, load);
      load.advance(kChunks);
    }
    cp_async_commit();
  }

  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  float dk[DC / 2], dv[DC / 2], st_[32], dpt[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; walk.more(); ++j) {
    const int q0 = walk.tile * kTile;
    const float* stg = stages + (j & 1) * kStage;
    const float* sQ = stg;
    const float* sG = stg + kTileF;
    const float* sK = kChunks == 1 ? smem_f32 : stg + 2 * kTileF;
    const float* sV = sK + kTileF;
    const float* sL = stg + L::kStage;
    const float* sD = sL + kTile;
    const int* sSe = reinterpret_cast<const int*>(sD + kTile);
    cp_async_wait<1>();
    __syncthreads();  // step j's tiles have landed, from every thread

    if (walk.c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) st_[i] = dpt[i] = 0.f;
    }
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (row = key, column = query)
    product_tf32<DC>(st_, sK, sQ, warp * 16, g, t);
    product_tf32<DC>(dpt, sV, sG, warp * 16, g, t);

    if (walk.c == kChunks - 1) {
      // p_drop in place of sᵀ, ds in place of dpᵀ; masked p is exactly 0
      const uint32_t keep =
          p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop,
                                            bh, k0 + r0, q0, lane)
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
      // dV += P_dropᵀ·dO and dK += dSᵀ·Q over this CTA's chunk (the step's
      // Q and dO are chunk oc)
      acc_product_tf32<DC>(dv, st_, sG, g, t);
      acc_product_tf32<DC>(dk, dpt, sQ, g, t);
    }
    __syncthreads();  // every warp is done with this stage
    if (load.more()) {
      load_step(j + 2, load);
      load.advance(kChunks);
    }
    cp_async_commit();
    walk.advance(kChunks);
  }
  cp_async_wait<0>();
  store_rows_f32<DC>(static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh +
                         oc * DC,
                     p.dk_st, dk, k0 + r0, p.Tk, t, p.sm_scale, p.sm_scale);
  store_rows_f32<DC>(static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh +
                         oc * DC,
                     p.dv_st, dv, k0 + r0, p.Tk, t, 1.f, 1.f);
}

// The f32 backward as one launch: the dk/dv CTAs, then the dq CTAs.
template <int D, int DC>
__global__ void __launch_bounds__(128) sparse_bwd_f32_kernel(SparseParams p) {
  if ((int)blockIdx.x < p.n_dkv)
    sparse_dkv_f32<D, DC>(p, blockIdx.x);
  else
    sparse_dq_f32<D, DC>(p, blockIdx.x - p.n_dkv);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
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

// one flag word per (kernel, dtype, head dim): slot = (dtype·4 + D/64 - 1)·2,
// + 0 the forward, + 1 the backward
unsigned configured[16] = {};

template <int D>
int slot_of(int dtype) {
  return (dtype * 4 + D / 64 - 1) * 2;
}

// The f32 forward's CTAs: one per (output chunk, q tile, b·h).
template <int D>
unsigned fwd_f32_ctas(int B, int H, int Tq) {
  return (unsigned)(Tq / kTile) * (unsigned)(B * H) *
         (D / hopper::chunk_of<D>());
}

template <int D>
cudaError_t launch_fwd_f32(const SparseParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  return launch(sparse_fwd_f32_kernel<D, DC>, &configured[slot_of<D>(0)], p,
                fwd_f32_ctas<D>(p.B, p.H, p.Tq), 128,
                SF32FwdLayout<D, DC>::bytes(), s);
}

template <int D>
cudaError_t launch_fwd_bf16(const Bf16SparseFwdParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  const unsigned tiles = (unsigned)(p.Tq / kTile) * (unsigned)(p.B * p.H);
  return launch(sparse_fwd_bf16_kernel<D, DC>, &configured[slot_of<D>(1)], p,
                tiles * (D / DC), 128, SFwdLayout<D, DC>::kSmem, s);
}

template <int D>
cudaError_t launch_bwd_f32(SparseParams p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  const unsigned bh = (unsigned)(p.B * p.H) * (D / DC);
  const unsigned n_dkv = (unsigned)(p.Tk / kTile) * bh;
  p.n_dkv = (int)n_dkv;
  return launch(sparse_bwd_f32_kernel<D, DC>, &configured[slot_of<D>(0) + 1],
                p, n_dkv + (unsigned)(p.Tq / kTile) * bh, 128,
                SF32Layout<D, DC>::bytes(), s);
}

template <int D>
cudaError_t launch_bwd_bf16(const Bf16SparseBwdParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  const unsigned tiles = (unsigned)(p.Tq / kTile + p.Tk / kTile);
  return launch(sparse_bwd_bf16_kernel<D, DC>, &configured[slot_of<D>(1) + 1],
                p, tiles * (unsigned)(p.B * p.H) * (D / DC), 128,
                smem_bwd_bf16<D>(), s);
}

bool shape_ok(int Tq, int Tk, int D, int causal) {
  return (D == 64 || D == 128 || D == 192 || D == 256) && Tq > 0 && Tk > 0 &&
         Tq % kTile == 0 && Tk % kTile == 0 && Tk < (1 << 15) &&
         (!causal || Tq == Tk);
}

void set_common(SparseParams& p, const void* q, const void* k, const void* v,
                const int* se, const int* vis, int B, int H, int Tq, int Tk,
                const long long* qs, const long long* ks, const long long* vs,
                float sm_scale, int causal, const long long* seed,
                unsigned threshold, float drop_scale, int dropout, const int* drop_offsets) {
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
  flash::set_offsets(p.drop, H, drop_offsets);
}

}  // namespace

extern "C" {

// The float32 forward (3xTF32). D in {64, 128, 192, 256}; Tq, Tk multiples
// of 64.
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
    int causal, const long long* seed, unsigned threshold, float drop_scale,
    int dropout, const int* drop_offsets, void* stream) {
  if (!shape_ok(Tq, Tk, D, causal)) return (int)cudaErrorInvalidValue;
  SparseParams p;
  set_common(p, q, k, v, se, vis, B, H, Tq, Tk, q_strides, k_strides,
             v_strides, sm_scale, causal, seed, threshold, drop_scale,
             dropout, drop_offsets);
  p.out = out; p.lse = lse;
  p.o_sb = o_strides[0]; p.o_sh = o_strides[1]; p.o_st = o_strides[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_fwd_f32<64>(p, s);
    case 128: return (int)launch_fwd_f32<128>(p, s);
    case 192: return (int)launch_fwd_f32<192>(p, s);
    default: return (int)launch_fwd_f32<256>(p, s);
  }
}

// The bfloat16 forward. `tensors` holds the tensor descriptions
// (hopper::kDescLen int64 each) of q, k, v ([B, H, T, D] bf16) and se
// ([1, 1, B, Tq] int32) in that order; vis as in the f32 forward; out
// strides are in elements; lse is [B*H, Tq] f32. Dropout as in the f32
// forward. Returns a cudaError_t.
int flash_attention_sparse_fwd_bf16(
    const long long* tensors, const int* vis, void* out, float* lse, int B,
    int H, int Tq, int Tk, int D, long long o_sb, long long o_sh,
    long long o_st, float sm_scale, int causal, const long long* seed,
    unsigned threshold, float drop_scale, int dropout, const int* drop_offsets, void* stream) {
  if (!shape_ok(Tq, Tk, D, causal)) return (int)cudaErrorInvalidValue;
  constexpr int n = hopper::kDescLen;
  Bf16SparseFwdParams p;
  CUtensorMap* maps[3] = {&p.tq, &p.tk, &p.tv};
  cudaError_t err;
  for (int i = 0; i < 3; ++i)
    if ((err = hopper::make_map(maps[i], tensors + i * n, true, 64, 64)) !=
        cudaSuccess)
      return (int)err;
  const long long* se = tensors + 3 * n;
  p.se = reinterpret_cast<const int*>(se[0]);
  p.se_pitch = (int)(se[5] / 4);  // the byte stride of the rows
  p.vis = vis;
  p.out = static_cast<bf*>(out);
  p.lse = lse;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
  flash::set_offsets(p.drop, H, drop_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_fwd_bf16<64>(p, s);
    case 128: return (int)launch_fwd_bf16<128>(p, s);
    case 192: return (int)launch_fwd_bf16<192>(p, s);
    default: return (int)launch_fwd_bf16<256>(p, s);
  }
}

// The float32 backward: one launch of dk/dv and dq CTAs on `stream`. lse
// and delta (= Σ_d dO·out) are [B*H, Tq] f32 with rows lse_pitch and
// delta_pitch floats apart; strides as in the forward, dO's in g_strides.
// Returns a cudaError_t (0 = launched).
int flash_attention_sparse_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* se, const int* vis,
    void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    int lse_pitch, int delta_pitch, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* g_strides, const long long* dq_strides,
    const long long* dk_strides, const long long* dv_strides, float sm_scale,
    int causal, const long long* seed, unsigned threshold, float drop_scale,
    int dropout, const int* drop_offsets, void* stream) {
  if (!shape_ok(Tq, Tk, D, causal)) return (int)cudaErrorInvalidValue;
  SparseParams p;
  set_common(p, q, k, v, se, vis, B, H, Tq, Tk, q_strides, k_strides,
             v_strides, sm_scale, causal, seed, threshold, drop_scale,
             dropout, drop_offsets);
  p.dout = dout; p.lse_in = lse; p.delta = delta;
  p.lse_pitch = lse_pitch; p.delta_pitch = delta_pitch;
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
    int dropout, const int* drop_offsets, void* stream) {
  if (!shape_ok(Tq, Tk, D, causal)) return (int)cudaErrorInvalidValue;
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
  flash::set_offsets(p.drop, H, drop_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd_bf16<64>(p, s);
    case 128: return (int)launch_bwd_bf16<128>(p, s);
    case 192: return (int)launch_bwd_bf16<192>(p, s);
    default: return (int)launch_bwd_bf16<256>(p, s);
  }
}

// CTAs of the f32 forward's launch for [B, H, Tq] queries at head dim D:
// one per (64-wide output chunk above d = 128, 64-row q tile, b·h).
unsigned flash_attention_sparse_fwd_ctas(int B, int H, int Tq, int D) {
  switch (D) {
    case 64: return fwd_f32_ctas<64>(B, H, Tq);
    case 128: return fwd_f32_ctas<128>(B, H, Tq);
    case 192: return fwd_f32_ctas<192>(B, H, Tq);
    case 256: return fwd_f32_ctas<256>(B, H, Tq);
    default: return 0;
  }
}

// Dynamic shared memory of the f32 forward at head dim D, bytes.
int flash_attention_sparse_fwd_smem(int D) {
  switch (D) {
    case 64: return (int)SF32FwdLayout<64, 64>::bytes();
    case 128: return (int)SF32FwdLayout<128, 128>::bytes();
    case 192: return (int)SF32FwdLayout<192, 64>::bytes();
    case 256: return (int)SF32FwdLayout<256, 64>::bytes();
    default: return 0;
  }
}

// Dynamic shared memory of the bf16 forward and backward kernels at head
// dim D, bytes.
int flash_attention_sparse_fwd_bf16_smem(int D) {
  switch (D) {
    case 64: return (int)SFwdLayout<64, 64>::kSmem;
    case 128: return (int)SFwdLayout<128, 128>::kSmem;
    case 192: return (int)SFwdLayout<192, 64>::kSmem;
    case 256: return (int)SFwdLayout<256, 64>::kSmem;
    default: return 0;
  }
}

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
