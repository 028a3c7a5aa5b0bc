// Flash-attention backward for Hopper (sm_90a): dq, dk, dv (and optionally
// dbias) of out = softmax(q·kᵀ·scale + bias [, causal]) [, dropout] · v,
// recomputing the probabilities from the forward's lse instead of storing
// the [Tq, Tk] score matrix.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/flash_attention.py:
// _bwd_dq_kernel + _bwd_dkv_kernel (via _flash_bwd_pallas) and
// _bwd_kernel_onepass (via _flash_bwd_pallas_onepass), with delta from
// _bwd_host_prep. The math is theirs:
//   delta = Σ_d dO·out
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
// delta comes first, from one small kernel (flash_bwd_delta_kernel, f32 or
// bf16, at any head dim that is a multiple of 64: the wide kernels of
// flash_attention_wide.cu use it too), as _bwd_host_prep computes it outside
// the TPU kernels. Then the
// TPU's split into dq and dk/dv work (two kernels in bf16; two kinds of CTA
// in one launch in f32), so every output is written by one CTA and two
// calls give the same bits (no atomics):
//   dq kernel:    one CTA per (64-row q tile, b·h) walks the 64-key tiles
//                 and keeps dq in registers;
//   dk/dv kernel: one CTA per (64-key tile, b·h) walks the 64-row q tiles
//                 (from the diagonal on when causal) and keeps dk, dv and
//                 the column sum of ds in registers.
// Both recompute s, p and dp = dO·vᵀ: 7 products instead of 5. The grids
// are the (tile, b·h) pairs flattened onto blockIdx.x. Head dims 64, 128,
// 192 and 256: above 128 a CTA owns one 64-wide chunk of its outputs' head
// dim (a third grid factor, the chunk fastest), recomputing s and dp over
// the full head dim; the f32 kernels then also stream the head dim through
// shared memory in 64-wide chunks (their own chunk last, so the output
// product finds its tiles in the ring), since four 64 x 256 f32 tiles
// would not fit.
//
// Bound. Five products of 2·Tq·Tk·d flops per head (s, dp, dv, dk, dq) over
// the bytes of q, k, v, out, dO, dq, dk, dv, lse and delta: in bf16 about
// 0.4·T flops a byte (50 at T = 128, 200 at T = 512), under the H100's ~295
// flop/byte tensor-core ridge, so a perfect bf16 kernel is memory bound at
// T = 128 and close to the ridge at T = 512; in f32 (0.2·T flops a byte
// against a ~20 flop/byte FMA ridge) it is compute bound on the CUDA cores.
// On the tensor cores in 3xTF32 (three TF32 products per f32 product, 495
// TFLOP/s) its ridge is ~49 flop/byte: compute bound at T = 512, close to
// the memory bound at T = 128.
//
// bf16 design (what it does about the bound). delta comes from one small
// kernel that reads out and dO in bf16 (~12.6 MB at BERT's T = 512). Every
// product is a wgmma with operands as TMA writes them (hopper.cuh), and no
// operand is transposed in shared memory:
//   dq kernel:    S = Q·Kᵀ and dP = dO·Vᵀ (all K-major), then dQ += dS·K
//                 with dS in registers and K read MN-major;
//   dk/dv kernel: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and
//                 dK += dSᵀ·Q with Pᵀ and dSᵀ in registers and dO, Q read
//                 MN-major.
// Thread 0 of the one warpgroup starts TMA copies into a ring of two
// stages, one tile ahead of the math: K, V (and the bias) for the dq
// kernel; Q, dO, lse, delta (and the bias) for the dk/dv kernel. The
// per-query bias arrives as a 64x64 block with its tile, the mask's row once
// per key tile; dropout bits are drawn in registers (keep_bits_rows /
// keep_bits_cols). As in the forward, the element loops have no branch
// (selects; the bias in registers once a tile; ex2.approx), the per-query
// dbias is stored after the loop, and the stages are sized by the bias
// mode, so more CTAs share an SM.
//
// f32 design. Every product (the same five kinds as bf16) runs on the
// tensor cores in 3xTF32 on mma.sync.m16n8k8 (tf32x3.cuh: the split, the
// fragments, the partial sums that the tensor core's round-toward-zero sums
// need: S and dP every kPartialDepth columns, the outputs once a tile).
// mma.sync, not wgmma: tf32 wgmma reads both operands K-major from shared
// memory, and the transposed products (dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO)
// would need transposed tiles; mma.sync reads its B fragments from the
// padded tile as it lies, and takes dS and P from the accumulators as A
// fragments by permuting the depth of the product (frag_a_acc). Four warps
// own 16 rows each of the 64x64 block, so the accumulators have the wgmma
// layout and the element loop, its selects and the register keep bits are
// the bf16 kernels'. The tiles (4 floats of row padding: conflict-free
// fragment reads) arrive by cp.async in a two-stage ring, one step ahead of
// the math; the bias is read from global memory (L1/L2) in the element
// loop. The dk/dv and dq CTAs share one launch (flash_bwd_f32_kernel, dk/dv
// first): at BERT's T = 128 either kind alone is 192 CTAs of four warps for
// 132 SMs. The products are issue-bound (the operand loads, their splits
// and the partial sums take more instructions than the mma they feed), at
// 8 warps an SM (shared memory and registers allow two CTAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX package
constexpr int kTile = 64;          // q rows and keys per tile

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Tq] rows lse_pitch floats apart
  const float* delta;  // [B*H, Tq] rows delta_pitch floats apart
  int lse_pitch, delta_pitch;
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
  int n_dkv;  // f32: the launch's first n_dkv CTAs are dk/dv CTAs
};

// Key tiles a q tile needs: causal rows see no key past their own index.
__device__ __forceinline__ int num_k_tiles(int Tq, int Tk, int causal,
                                           int q0) {
  int n = (Tk + kTile - 1) / kTile;
  if (causal) {
    int last_row = min(q0 + kTile, Tq) - 1;
    n = min(n, last_row / kTile + 1);
  }
  return n;
}

// Zeroes the per-query dbias of the key tiles a causal q tile skips (the
// TPU dq kernel writes zeros for its skipped blocks too).
__device__ __forceinline__ void zero_skipped_dbias(float* dbias, int Tq,
                                                   int Tk, int bh, int q0,
                                                   int n_tiles, int tid,
                                                   int nthreads) {
  const int c0 = n_tiles * kTile, ncols = Tk - c0;
  if (dbias == nullptr || ncols <= 0) return;
  for (int idx = tid; idx < kTile * ncols; idx += nthreads) {
    const int r = idx / ncols, c = idx % ncols;
    if (q0 + r < Tq) dbias[((long long)bh * Tq + q0 + r) * Tk + c0 + c] = 0.f;
  }
}

__device__ __forceinline__ void seed_keys(const flash::Dropout& d,
                                          uint32_t* key0, uint32_t* key1) {
  *key0 = *key1 = 0;
  if (d.on) {
    const unsigned long long s = static_cast<unsigned long long>(*d.seed);
    *key0 = static_cast<uint32_t>(s);
    *key1 = static_cast<uint32_t>(s >> 32);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync.m16n8k8), tiles by cp.async.
// Four warps; warp w owns rows 16w..16w+15 of the 64x64 score block, so
// accumulator register 4·nb + 2·h + e of lane (g, t) is row 16w + g + 8h,
// column 8·nb + 2t + e: the layout of the bf16 kernels' wgmma accumulators,
// whose keep-bit and element code the f32 kernels share.
// ---------------------------------------------------------------------------

// Shared memory of the f32 kernels, in floats. Up to d = 128 (one chunk)
// the CTA's own tiles stay (Q and dO for dq; K and V for dk/dv) and a stage
// of the two-stage ring holds the two streamed tiles (K, V; or Q, dO with
// their 64 lse and 64 delta values). Above that every step streams all
// four tiles of one 64-wide head-dim chunk.
template <int D, int DC>
struct F32Layout {
  static constexpr int kChunks = D / DC;
  static constexpr int kTileF = kTile * pitch_f32<DC>();
  static constexpr int kResident = kChunks == 1 ? 2 * kTileF : 0;
  static constexpr int kStage = (kChunks == 1 ? 2 : 4) * kTileF;
  static constexpr size_t dq_bytes() {
    return sizeof(float) * (kResident + 2 * kStage);
  }
  static constexpr size_t dkv_bytes() {
    return sizeof(float) * (kResident + 2 * (kStage + 2 * kTile));
  }
};

// The head-dim chunk step j of a CTA that owns chunk oc reads: the chunks of
// a tile are taken from oc + 1 on, so the last one (whose tiles the output
// product reads) is oc.
template <int kChunks>
__device__ __forceinline__ int chunk_at(int j, int oc) {
  return (oc + 1 + j % kChunks) % kChunks;
}

// A dq CTA: one per (DC-wide output chunk, 64-row q tile, b·h), numbered
// `cta` (the chunk fastest), walks the key tiles (through the causal
// diagonal) over a two-stage cp.async ring, one step (tile, head-dim
// chunk) ahead of the math.
template <int D, int DC>
__device__ __forceinline__ void dq_f32_cta(const BwdParams& p, int cta) {
  using L = F32Layout<D, DC>;
  constexpr int kChunks = L::kChunks, kTileF = L::kTileF;
  extern __shared__ __align__(16) float smem_f32[];
  float* stages = smem_f32 + L::kResident;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (p.Tq + kTile - 1) / kTile;  // grid: (chunk, tile, b·h)
  const int oc = cta % kChunks, cell = cta / kChunks;
  const int bh = cell / n_q, b = bh / p.H, h = bh % p.H;
  const int q0 = (cell % n_q) * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                   q0 * p.q_st;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.dout) + b * p.g_sb +
                    h * p.g_sh + q0 * p.g_st;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_sb + h * p.b_sh;
  const int n_tiles = num_k_tiles(p.Tq, p.Tk, p.causal, q0);
  const int n_steps = n_tiles * kChunks;
  float* dbias = oc == 0 ? p.dbias : nullptr;  // written by one chunk

  // step j: key tile j / kChunks, head-dim chunk chunk_at(j)
  auto load_step = [&](int j) {
    float* st = stages + (j & 1) * L::kStage;
    const int k0 = j / kChunks * kTile, c = chunk_at<kChunks>(j, oc) * DC;
    if (kChunks > 1) {
      copy_tile<DC>(st + 2 * kTileF, q + c, p.q_st, p.Tq - q0, tid);
      copy_tile<DC>(st + 3 * kTileF, gg + c, p.g_st, p.Tq - q0, tid);
    }
    copy_tile<DC>(st, k + k0 * p.k_st + c, p.k_st, p.Tk - k0, tid);
    copy_tile<DC>(st + kTileF, v + k0 * p.v_st + c, p.v_st, p.Tk - k0, tid);
  };
  if (kChunks == 1) {
    copy_tile<DC>(smem_f32, q, p.q_st, p.Tq - q0, tid);
    copy_tile<DC>(smem_f32 + kTileF, gg, p.g_st, p.Tq - q0, tid);
  }
  load_step(0);
  cp_async_commit();
  if (n_steps > 1) load_step(1);
  cp_async_commit();

  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float lse[2], delta[2];
  long long brow[2];  // bias offsets of the two rows (clamped into Tq)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const bool ok = row < p.Tq;
    lse[hh] = ok ? p.lse[(long long)bh * p.lse_pitch + row] : 0.f;
    delta[hh] = ok ? p.delta[(long long)bh * p.delta_pitch + row] : 0.f;
    brow[hh] = (ok ? row : p.Tq - 1) * p.b_sq;
  }
  float dq[DC / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    const int kt = j / kChunks, k0 = kt * kTile;
    const bool first = j % kChunks == 0, last = j % kChunks == kChunks - 1;
    const float* st = stages + (j & 1) * L::kStage;
    const float* sK = st;
    const float* sV = st + kTileF;
    const float* sQ = kChunks == 1 ? smem_f32 : st + 2 * kTileF;
    const float* sG = sQ + kTileF;
    cp_async_wait<1>();
    __syncthreads();  // step j's tiles have landed, from every thread

    if (first) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    }
    // S = Q·Kᵀ and dP = dO·Vᵀ over this chunk of the head dim
    product_tf32<DC>(s, sQ, sK, warp * 16, g, t);
    product_tf32<DC>(dp, sG, sV, warp * 16, g, t);

    if (last) {
      // ds = p·(dp − delta), in place of s (selects, no branch)
      const uint32_t keep =
          p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop,
                                            bh, q0 + r0, k0, t)
                    : ~0u;
      const int k_left = p.Tk - k0;  // keys of this tile inside Tk
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
        const int row = q0 + r0 + 8 * hh;
        float x = s[i] * p.sm_scale;
        x = bias != nullptr
                ? x + __ldg(bias + brow[hh] + min(k0 + c, p.Tk - 1) * p.b_sk)
                : x;
        x = p.causal && k0 + c > row ? kNegInf : x;
        float pr = hopper::ex2((x - lse[hh]) * hopper::kLog2e);
        pr = row < p.Tq && c < k_left ? pr : 0.f;
        const float dpv = (keep >> i) & 1u ? dp[i] * drop_scale : 0.f;
        s[i] = pr * (dpv - delta[hh]);
      }
      if (dbias != nullptr) {  // the per-query dbias is ds itself
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = q0 + r0 + 8 * ((i >> 1) & 1);
          const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
          if (row < p.Tq && col < p.Tk)
            dbias[((long long)bh * p.Tq + row) * p.Tk + col] = s[i];
        }
      }
      // dQ += dS·K over this CTA's chunk (the step's K is chunk oc)
      acc_product_tf32<DC>(dq, s, sK, g, t);
    }
    __syncthreads();  // every warp is done with this stage
    if (j + 2 < n_steps) load_step(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  zero_skipped_dbias(dbias, p.Tq, p.Tk, bh, q0, n_tiles, tid, 128);
  store_rows_f32<DC>(static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
                         oc * DC,
                     p.dq_st, dq, q0 + r0, p.Tq, t, p.sm_scale, p.sm_scale);
}

// A dk/dv CTA: one per (DC-wide output chunk, 64-key tile, b·h), numbered
// `cta`, walks the q tiles (from the diagonal on when causal) over the
// same ring; a stage also brings the q tile's lse and delta.
template <int D, int DC>
__device__ __forceinline__ void dkv_f32_cta(const BwdParams& p, int cta) {
  using L = F32Layout<D, DC>;
  constexpr int kChunks = L::kChunks, kTileF = L::kTileF;
  constexpr int kStage = L::kStage + 2 * kTile;
  extern __shared__ __align__(16) float smem_f32[];
  float* stages = smem_f32 + L::kResident;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_k = (p.Tk + kTile - 1) / kTile;  // grid: (chunk, tile, b·h)
  const int oc = cta % kChunks, cell = cta / kChunks;
  const int bh = cell / n_k, b = bh / p.H, h = bh % p.H;
  const int k0 = (cell % n_k) * kTile;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh +
                   k0 * p.k_st;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh +
                   k0 * p.v_st;
  const float* gg = static_cast<const float*>(p.dout) + b * p.g_sb +
                    h * p.g_sh;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_sb + h * p.b_sh;
  const int nq = (p.Tq + kTile - 1) / kTile;
  const int iq0 = p.causal ? k0 / kTile : 0;
  const int n_steps = (nq - iq0) * kChunks;  // <= 0: no query sees these keys

  // step j: q tile iq0 + j / kChunks, head-dim chunk chunk_at(j)
  auto load_step = [&](int j) {
    float* st = stages + (j & 1) * kStage;
    const int q0 = (iq0 + j / kChunks) * kTile;
    const int c = chunk_at<kChunks>(j, oc) * DC;
    if (kChunks > 1) {
      copy_tile<DC>(st + 2 * kTileF, k + c, p.k_st, p.Tk - k0, tid);
      copy_tile<DC>(st + 3 * kTileF, v + c, p.v_st, p.Tk - k0, tid);
    }
    copy_tile<DC>(st, q + q0 * p.q_st + c, p.q_st, p.Tq - q0, tid);
    copy_tile<DC>(st + kTileF, gg + q0 * p.g_st + c, p.g_st, p.Tq - q0, tid);
    float* rows = st + L::kStage;  // lse, then delta
    const int i = tid % kTile, row = q0 + i, ok = row < p.Tq;
    const float* src = tid < kTile
        ? p.lse + (long long)bh * p.lse_pitch
        : p.delta + (long long)bh * p.delta_pitch;
    cp_async4(rows + tid, src + (ok ? row : 0), ok);
  };
  if (kChunks == 1) {
    copy_tile<DC>(smem_f32, k, p.k_st, p.Tk - k0, tid);
    copy_tile<DC>(smem_f32 + kTileF, v, p.v_st, p.Tk - k0, tid);
  }
  if (n_steps > 0) load_step(0);
  cp_async_commit();
  if (n_steps > 1) load_step(1);
  cp_async_commit();

  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  long long bkey[2];  // bias offsets of the two keys (clamped into Tk)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    bkey[hh] = min(k0 + r0 + 8 * hh, p.Tk - 1) * p.b_sk;
  float dk[DC / 2], dv[DC / 2], st_[32], dpt[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
  float dbc[2] = {0.f, 0.f};  // column sums of ds for keys r0, r0 + 8

  for (int j = 0; j < n_steps; ++j) {
    const int q0 = (iq0 + j / kChunks) * kTile;
    const bool first = j % kChunks == 0, last = j % kChunks == kChunks - 1;
    const float* st = stages + (j & 1) * kStage;
    const float* sQ = st;
    const float* sG = st + kTileF;
    const float* sK = kChunks == 1 ? smem_f32 : st + 2 * kTileF;
    const float* sV = sK + kTileF;
    const float* sL = st + L::kStage;
    const float* sD = sL + kTile;
    cp_async_wait<1>();
    __syncthreads();  // step j's tiles have landed, from every thread

    if (first) {
#pragma unroll
      for (int i = 0; i < 32; ++i) st_[i] = dpt[i] = 0.f;
    }
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (row = key, column = query)
    product_tf32<DC>(st_, sK, sQ, warp * 16, g, t);
    product_tf32<DC>(dpt, sV, sG, warp * 16, g, t);

    if (last) {
      // p_drop in place of sᵀ, ds in place of dpᵀ (selects, no branch)
      const uint32_t keep =
          p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop,
                                            bh, k0 + r0, q0, lane)
                    : ~0u;
      const int q_left = p.Tq - q0;  // queries of this tile inside Tq
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
        const int key = k0 + r0 + 8 * hh;
        float x = st_[i] * p.sm_scale;
        x = bias != nullptr
                ? x + __ldg(bias + min(q0 + c, p.Tq - 1) * p.b_sq + bkey[hh])
                : x;
        x = p.causal && key > q0 + c ? kNegInf : x;
        float pr = hopper::ex2((x - sL[c]) * hopper::kLog2e);
        pr = c < q_left && key < p.Tk ? pr : 0.f;
        const bool kept = (keep >> i) & 1u;
        const float ds = pr * ((kept ? dpt[i] * drop_scale : 0.f) - sD[c]);
        st_[i] = kept ? pr * drop_scale : 0.f;
        dpt[i] = ds;
        dbc[hh] += ds;
      }
      // dV += P_dropᵀ·dO and dK += dSᵀ·Q over this CTA's chunk (the
      // step's Q and dO are chunk oc)
      acc_product_tf32<DC>(dv, st_, sG, g, t);
      acc_product_tf32<DC>(dk, dpt, sQ, g, t);
    }
    __syncthreads();  // every warp is done with this stage
    if (j + 2 < n_steps) load_step(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (p.dbias_col != nullptr && oc == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 1);
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 2);
      const int key = k0 + r0 + 8 * hh;
      if (t == 0 && key < p.Tk)
        p.dbias_col[(long long)bh * p.Tk + key] = dbc[hh];
    }
  }
  store_rows_f32<DC>(static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh +
                         oc * DC,
                     p.dk_st, dk, k0 + r0, p.Tk, t, p.sm_scale, p.sm_scale);
  store_rows_f32<DC>(static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh +
                         oc * DC,
                     p.dv_st, dv, k0 + r0, p.Tk, t, 1.f, 1.f);
}

// The f32 backward: the dk/dv CTAs (the longer walks) first, then the dq
// CTAs, in one launch, so the two kinds share the card (at T = 128 either
// alone has too few CTAs to fill it).
template <int D, int DC>
__global__ void __launch_bounds__(128) flash_bwd_f32_kernel(BwdParams p) {
  if ((int)blockIdx.x < p.n_dkv)
    dkv_f32_cta<D, DC>(p, blockIdx.x);
  else
    dq_f32_cta<D, DC>(p, blockIdx.x - p.n_dkv);
}

// ---------------------------------------------------------------------------
// bf16: delta, then wgmma on TMA-loaded tiles.
// ---------------------------------------------------------------------------

// Lanes of the delta kernel a row: the largest power of two up to 16 that
// divides the row's 16-byte vectors (bf16: 8, 16, 8, 16 at d = 64 to 256;
// f32: 16).
template <typename T>
__host__ __device__ constexpr int delta_lanes(int D) {
  return (D * (int)sizeof(T) / 16) % 16 == 0 ? 16 : 8;
}

// acc + the dot product of two 16-byte vectors, in order, in f32.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       float acc);
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a, const uint4& b,
                                              float acc) {
  acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const uint4& a,
                                                      const uint4& b,
                                                      float acc) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(pa[j]), y = __bfloat1622float2(pb[j]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// delta[bh, i] = Σ_d dO·out from f32 or bf16 tensors: `lanes` lanes a row,
// nvec 16-byte vectors of each tensor a lane, `lanes` vectors apart, summed
// in f32. The head dim is D, or with D = 0 the run-time d (a multiple of
// 64 above the tuned head dims): the same sum in the same order. The tuned
// head dims keep D fixed: with run-time counts the kernel was slower at
// each of them on the H100.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const T* out, const T* g, float* delta, int H, int T_, int pitch,
    long long rows, int d, long long o_sb, long long o_sh, long long o_st,
    long long g_sb, long long g_sh, long long g_st) {
  constexpr int kPer = 16 / sizeof(T);  // values a vector
  const int lanes = delta_lanes<T>(D ? D : d);
  const int nvec = (D ? D : d) / kPer / lanes;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / lanes;
  const int c = static_cast<int>(idx % lanes) * kPer;
  float acc = 0.f;
  long long bh = 0;
  int i = 0;
  if (row < rows) {
    bh = row / T_;
    i = static_cast<int>(row % T_);
    const long long b = bh / H, h = bh % H;
#pragma unroll
    for (int u = 0; u < nvec; ++u) {
      const int cu = c + u * kPer * lanes;
      acc = dot16<T>(*reinterpret_cast<const uint4*>(
                         out + b * o_sb + h * o_sh + i * o_st + cu),
                     *reinterpret_cast<const uint4*>(
                         g + b * g_sb + h * g_sh + i * g_st + cu),
                     acc);
    }
  }
#pragma unroll
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) delta[bh * pitch + i] = acc;
}

struct Bf16BwdParams {
  CUtensorMap tq, tk, tv, tg;  // [B, H, T, D]: boxes of 64 rows x 64 values
  CUtensorMap tb;              // bias [Bb, Hb, Qb, Tk]: 1 or 64 rows x 64 keys
  CUtensorMap tlse, tdelta;    // [1, 1, B*H, Tq] f32: boxes of 64 values
  const float* lse;
  const float* delta;
  int lse_pitch, delta_pitch;  // floats between the rows of lse / delta
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dbias;      // per-query dbias [B*H, Tq, Tk] or nullptr
  float* dbias_col;  // column-sum dbias [B*H, Tk] or nullptr
  int B, H, Tq, Tk;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  int bias_mode;       // 0 none, 1 one row for all queries, 2 per query
  int bias_b, bias_h;  // 1 = the bias is broadcast over batch / heads
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

// The bias of score (q row, key col) of a 64x64 block from its swizzled
// shared-memory tile ([q][key] bf16).
__device__ __forceinline__ float bias_at(const unsigned char* tile, int row,
                                         int col) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + hopper::swz(row, col)));
}

// Stores a warpgroup's 64 x D f32 accumulator (times `scale`) as bf16 rows
// row0 + r0 and row0 + r0 + 8 of a [T, D] matrix, skipping rows past `limit`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long st,
                                           const float (&acc)[D / 2],
                                           int row0, int limit, int t,
                                           float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= limit) continue;
    __nv_bfloat16* out = dst + row * st + 2 * t;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + nb * 8) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * hh] * scale,
                                acc[4 * nb + 2 * hh + 1] * scale);
  }
}

// dq kernel: Q and dO stay; K, V and the bias slot (sized by the bias
// mode) stream through two stages. Byte offsets from the 1024-aligned base.
template <int D>
struct DqLayout {
  static constexpr int kTile = D / 64 * hopper::kBoxBytes;  // [64][D]
  static __host__ __device__ constexpr int stage(int bias_mode) {
    return 2 * kTile + hopper::bias_slot(bias_mode);
  }
  static __host__ __device__ constexpr int bars(int bias_mode) {
    return 2 * kTile + 2 * stage(bias_mode);
  }
  static constexpr size_t smem(int bias_mode) {
    return bars(bias_mode) + 3 * sizeof(uint64_t) + 1024;
  }
};

template <int D>
__device__ __forceinline__ void load_dq_stage(const Bf16BwdParams& p,
                                         unsigned char* smem, uint64_t* bars,
                                         int kt, int q0, int b, int h) {
  using L = DqLayout<D>;
  unsigned char* st = smem + 2 * L::kTile + (kt & 1) * L::stage(p.bias_mode);
  uint64_t* bar = &bars[kt & 1];
  hopper::mbar_expect_tx(
      bar, 2 * L::kTile + (p.bias_mode == 2 ? hopper::kBoxBytes
                           : p.bias_mode == 1 ? 128 : 0));
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load(st + c * hopper::kBoxBytes, &p.tk, bar, c * 64,
                     kt * kTile, h, b);
    hopper::tma_load(st + L::kTile + c * hopper::kBoxBytes, &p.tv, bar,
                     c * 64, kt * kTile, h, b);
  }
  if (p.bias_mode)
    hopper::tma_load(st + 2 * L::kTile, &p.tb, bar, kt * kTile,
                     p.bias_mode == 2 ? q0 : 0, p.bias_h ? 0 : h,
                     p.bias_b ? 0 : b);
}

template <int D, int DC>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(const __grid_constant__ Bf16BwdParams p) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sG = smem + L::kTile;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + L::bars(p.bias_mode));  // 2 + Q/dO

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (p.Tq + kTile - 1) / kTile;
  // grid: (chunk, q tile, b·h) flat, the chunk fastest
  const int oc = blockIdx.x % (D / DC), cell = blockIdx.x / (D / DC);
  const int bh = cell / n_q, q0 = (cell % n_q) * kTile;
  const int b = bh / p.H, h = bh % p.H;
  const int n_tiles = num_k_tiles(p.Tq, p.Tk, p.causal, q0);
  float* dbias = oc == 0 ? p.dbias : nullptr;  // written by one chunk

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bars[2], 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load(sQ + c * hopper::kBoxBytes, &p.tq, &bars[2], c * 64,
                       q0, h, b);
      hopper::tma_load(sG + c * hopper::kBoxBytes, &p.tg, &bars[2], c * 64,
                       q0, h, b);
    }
    load_dq_stage<D>(p, smem, bars, 0, q0, b, h);
    if (n_tiles > 1) load_dq_stage<D>(p, smem, bars, 1, q0, b, h);
  }
  uint32_t key0, key1;
  seed_keys(p.drop, &key0, &key1);
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const bool ok = row < p.Tq;
    lse[hh] = ok ? p.lse[(long long)bh * p.lse_pitch + row] : 0.f;
    delta[hh] = ok ? p.delta[(long long)bh * p.delta_pitch + row] : 0.f;
  }
  float dq[DC / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  hopper::mbar_wait(&bars[2], 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    const unsigned char* sK =
        smem + 2 * L::kTile + (kt & 1) * L::stage(p.bias_mode);
    const unsigned char* sV = sK + L::kTile;
    const unsigned char* sB = sK + 2 * L::kTile;
    hopper::mbar_wait(&bars[kt & 1], (kt >> 1) & 1);

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

    // ds = p·(dp − delta), in place of s (selects, no branch)
    const uint32_t keep =
        p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop, bh,
                                          q0 + r0, k0, t)
                  : ~0u;
    float bv[32];
    hopper::bias_rows(bv, sB, p.bias_mode, r0, t);
    const int k_left = p.Tk - k0;  // keys of this tile inside Tk
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = q0 + r0 + 8 * hh;
      float x = fmaf(s[i], p.sm_scale, bv[i]);
      x = p.causal && k0 + c > row ? kNegInf : x;
      float pr = hopper::ex2((x - lse[hh]) * hopper::kLog2e);
      pr = row < p.Tq && c < k_left ? pr : 0.f;
      const float dpv = (keep >> i) & 1u ? dp[i] * drop_scale : 0.f;
      s[i] = pr * (dpv - delta[hh]);
    }
    if (dbias != nullptr) {  // the per-query dbias is ds itself
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (row < p.Tq && col < p.Tk)
          dbias[((long long)bh * p.Tq + row) * p.Tk + col] = s[i];
      }
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
    if (tid == 0 && kt + 2 < n_tiles) load_dq_stage<D>(p, smem, bars, kt + 2, q0, b, h);
  }
  zero_skipped_dbias(dbias, p.Tq, p.Tk, bh, q0, n_tiles, tid, 128);
  store_rows<DC>(p.dq + b * p.dq_sb + h * p.dq_sh + oc * DC, p.dq_st, dq,
                 q0 + r0, p.Tq, t, p.sm_scale);
}

// dk/dv kernel: K, V (and the mask's key slice) stay; Q, dO, lse and delta
// (256 bytes each) and the per-query bias block stream through two stages.
// Byte offsets from the 1024-aligned base.
template <int D>
struct DkvLayout {
  static constexpr int kTile = D / 64 * hopper::kBoxBytes;  // [64][D]
  static constexpr int kRowBias = 2 * kTile;                // after K, V
  static constexpr int kStages = kRowBias + 1024;
  static constexpr int kRows = 2 * kTile;                   // lse, delta
  static __host__ __device__ constexpr int stage(int bias_mode) {
    return 2 * kTile + 1024 + (bias_mode == 2 ? hopper::kBoxBytes : 0);
  }
  static __host__ __device__ constexpr int bars(int bias_mode) {
    return kStages + 2 * stage(bias_mode);
  }
  static constexpr size_t smem(int bias_mode) {
    return bars(bias_mode) + 3 * sizeof(uint64_t) + 1024;
  }
};

template <int D>
__device__ __forceinline__ void load_dkv_stage(const Bf16BwdParams& p,
                                          unsigned char* smem, uint64_t* bars,
                                          int j, int q0, int k0, int bh,
                                          int b, int h) {
  using L = DkvLayout<D>;
  unsigned char* st = smem + L::kStages + (j & 1) * L::stage(p.bias_mode);
  uint64_t* bar = &bars[j & 1];
  hopper::mbar_expect_tx(
      bar, 2 * L::kTile + (p.bias_mode == 2 ? hopper::kBoxBytes : 0) + 512);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load(st + c * hopper::kBoxBytes, &p.tq, bar, c * 64, q0, h,
                     b);
    hopper::tma_load(st + L::kTile + c * hopper::kBoxBytes, &p.tg, bar,
                     c * 64, q0, h, b);
  }
  if (p.bias_mode == 2)
    hopper::tma_load(st + L::kRows + 1024, &p.tb, bar, k0, q0,
                     p.bias_h ? 0 : h, p.bias_b ? 0 : b);
  unsigned char* rows = st + L::kRows;
  hopper::tma_load(rows, &p.tlse, bar, q0, bh, 0, 0);
  hopper::tma_load(rows + 256, &p.tdelta, bar, q0, bh, 0, 0);
}

template <int D, int DC>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ Bf16BwdParams p) {
  using L = DkvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::kTile;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + L::bars(p.bias_mode));  // 2 + K/V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_k = (p.Tk + kTile - 1) / kTile;
  // grid: (chunk, key tile, b·h) flat, the chunk fastest
  const int oc = blockIdx.x % (D / DC), cell = blockIdx.x / (D / DC);
  const int bh = cell / n_k, k0 = (cell % n_k) * kTile;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + kTile - 1) / kTile;
  const int iq0 = p.causal ? k0 / kTile : 0;
  const int n_tiles = nq - iq0;  // <= 0: no query sees these keys

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bars[2],
                           2 * L::kTile + (p.bias_mode == 1 ? 128 : 0));
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load(sK + c * hopper::kBoxBytes, &p.tk, &bars[2], c * 64,
                       k0, h, b);
      hopper::tma_load(sV + c * hopper::kBoxBytes, &p.tv, &bars[2], c * 64,
                       k0, h, b);
    }
    if (p.bias_mode == 1)
      hopper::tma_load(smem + L::kRowBias, &p.tb, &bars[2], k0, 0,
                       p.bias_h ? 0 : h, p.bias_b ? 0 : b);
    if (n_tiles > 0) load_dkv_stage<D>(p, smem, bars, 0, iq0 * kTile, k0, bh, b, h);
    if (n_tiles > 1)
      load_dkv_stage<D>(p, smem, bars, 1, (iq0 + 1) * kTile, k0, bh, b, h);
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
  float dbc[2] = {0.f, 0.f};  // column sums of ds for keys r0, r0 + 8
  hopper::mbar_wait(&bars[2], 0);
  float row_bias[2] = {0.f, 0.f};
  if (p.bias_mode == 1)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      row_bias[hh] = bias_at(smem + L::kRowBias, 0, r0 + 8 * hh);

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = (iq0 + j) * kTile;
    const unsigned char* sQ =
        smem + L::kStages + (j & 1) * L::stage(p.bias_mode);
    const unsigned char* sG = sQ + L::kTile;
    const float* sL = reinterpret_cast<const float*>(sQ + L::kRows);
    const float* sD = sL + 64;
    const unsigned char* sB = sQ + L::kRows + 1024;
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

    // p_drop in place of sᵀ, ds in place of dpᵀ (selects, no branch)
    const uint32_t keep =
        p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop, bh,
                                          k0 + r0, q0, lane)
                  : ~0u;
    float bv[32];
    if (p.bias_mode == 2) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        bv[i] = bias_at(sB, (i >> 2) * 8 + 2 * t + (i & 1),
                        r0 + 8 * ((i >> 1) & 1));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) bv[i] = row_bias[(i >> 1) & 1];
    }
    const int q_left = p.Tq - q0;  // queries of this tile inside Tq
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
      const int key = k0 + r0 + 8 * hh;
      float x = fmaf(st_[i], p.sm_scale, bv[i]);
      x = p.causal && key > q0 + c ? kNegInf : x;
      float pr = hopper::ex2((x - sL[c]) * hopper::kLog2e);
      pr = c < q_left && key < p.Tk ? pr : 0.f;
      const bool kept = (keep >> i) & 1u;
      const float ds = pr * ((kept ? dpt[i] * drop_scale : 0.f) - sD[c]);
      st_[i] = kept ? pr * drop_scale : 0.f;
      dpt[i] = ds;
      dbc[hh] += ds;
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
    if (tid == 0 && j + 2 < n_tiles)
      load_dkv_stage<D>(p, smem, bars, j + 2, (iq0 + j + 2) * kTile, k0, bh, b, h);
  }

  if (p.dbias_col != nullptr && oc == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 1);
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 2);
      const int key = k0 + r0 + 8 * hh;
      if (t == 0 && key < p.Tk)
        p.dbias_col[(long long)bh * p.Tk + key] = dbc[hh];
    }
  }
  store_rows<DC>(p.dk + b * p.dk_sb + h * p.dk_sh + oc * DC, p.dk_st, dk,
                 k0 + r0, p.Tk, t, p.sm_scale);
  store_rows<DC>(p.dv + b * p.dv_sb + h * p.dv_sh + oc * DC, p.dv_st, dv,
                 k0 + r0, p.Tk, t, 1.f);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
// Opts a kernel into `max_smem` of dynamic shared memory once per device,
// then launches it with `smem` on `stream` over `blocks` CTAs (tiles x B·H,
// flattened).
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, unsigned* configured, const Params& p,
                   unsigned blocks, int threads, size_t smem,
                   size_t max_smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(*configured & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
    if (err != cudaSuccess) return err;
    *configured |= bit;  // idempotent: a racing second setter is harmless
  }
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// flag words per (dtype, head dim): f32 at D/64 - 1, bf16 at 8 + 2·(D/64 - 1)
unsigned configured[16] = {};

// The CTAs of the dq and dk/dv grids: (chunk, tile, B·H) flattened.
template <int D, typename Params>
void grids(const Params& p, unsigned* nq, unsigned* nk) {
  const unsigned bh = (unsigned)(p.B * p.H) * (D / hopper::chunk_of<D>());
  *nq = (unsigned)((p.Tq + kTile - 1) / kTile) * bh;
  *nk = (unsigned)((p.Tk + kTile - 1) / kTile) * bh;
}

template <int D>
cudaError_t launch_f32(const BwdParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  using L = F32Layout<D, DC>;
  constexpr size_t kSmem = L::dkv_bytes() > L::dq_bytes() ? L::dkv_bytes()
                                                          : L::dq_bytes();
  unsigned nq, nk;
  grids<D>(p, &nq, &nk);
  BwdParams q = p;
  q.n_dkv = (int)nk;
  return launch(flash_bwd_f32_kernel<D, DC>, &configured[D / 64 - 1], q,
                nk + nq, 128, kSmem, kSmem, s);
}

template <int D>
cudaError_t launch_bf16(const Bf16BwdParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  unsigned nq, nk;
  grids<D>(p, &nq, &nk);
  const int slot = 8 + 2 * (D / 64 - 1);
  cudaError_t err = launch(flash_bwd_dq_bf16_kernel<D, DC>, &configured[slot],
                           p, nq, 128, DqLayout<D>::smem(p.bias_mode),
                           DqLayout<D>::smem(2), s);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkv_bf16_kernel<D, DC>, &configured[slot + 1], p,
                nk, 128, DkvLayout<D>::smem(p.bias_mode),
                DkvLayout<D>::smem(2), s);
}

bool head_dim_ok(int D) {
  return D == 64 || D == 128 || D == 192 || D == 256;
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* g, float* delta, int H,
                         int Tq, int D, int pitch, long long rows,
                         const long long (&st)[6], cudaStream_t s) {
  const T* o = static_cast<const T*>(out);
  const T* gg = static_cast<const T*>(g);
  if (D <= 0 || D % 64) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows * delta_lanes<T>(D) + 255) / 256);
#define DELTA(DD)                                                          \
  flash_bwd_delta_kernel<T, DD><<<grid, 256, 0, s>>>(                      \
      o, gg, delta, H, Tq, pitch, rows, D, st[0], st[1], st[2], st[3],     \
      st[4], st[5])
  switch (D) {
    case 64: DELTA(64); break;
    case 128: DELTA(128); break;
    case 192: DELTA(192); break;
    case 256: DELTA(256); break;
    default: DELTA(0);
  }
#undef DELTA
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32. Strides are in elements; the head dim is contiguous, rows and
// bases 16-byte aligned. lse and delta are [B*H, Tq] f32, their rows
// lse_pitch / delta_pitch floats apart. dbias (per query, [B*H, Tq, Tk]
// f32) and dbias_col ([B*H, Tk] f32) may be null. With dropout != 0, `seed`
// points at one int64 on the device and a score is dropped iff its Philox
// word < `threshold`; kept p is scaled by `drop_scale`. Launches the dk/dv
// and dq CTAs (one kernel) on `stream`. Returns a cudaError_t (0 =
// launched).
int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* bias, void* dq,
    void* dk, void* dv, float* dbias, float* dbias_col, int B, int H, int Tq,
    int Tk, int D, int lse_pitch, int delta_pitch, long long q_sb,
    long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long g_sb, long long g_sh,
    long long g_st, long long dq_sb, long long dq_sh, long long dq_st,
    long long dk_sb, long long dk_sh, long long dk_st, long long dv_sb,
    long long dv_sh, long long dv_st, long long b_sb, long long b_sh,
    long long b_sq, long long b_sk, float sm_scale, int causal,
    const long long* seed, unsigned threshold, float drop_scale, int dropout, const int* drop_offsets,
    void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.lse_pitch = lse_pitch; p.delta_pitch = delta_pitch;
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
  flash::set_offsets(p.drop, H, drop_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_f32<64>(p, s);
    case 128: return (int)launch_f32<128>(p, s);
    case 192: return (int)launch_f32<192>(p, s);
    case 256: return (int)launch_f32<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta[bh, i] = Σ_d dO·out into rows `pitch` floats apart, from float32
// (dtype 0) or bfloat16 (dtype 1) out and dO. Strides are in elements;
// 16-byte aligned rows. Returns a cudaError_t.
int flash_attention_bwd_delta(const void* out, const void* g, float* delta,
                              int dtype, int B, int H, int T, int D,
                              int pitch, long long o_sb, long long o_sh,
                              long long o_st, long long g_sb, long long g_sh,
                              long long g_st, void* stream) {
  const long long rows = (long long)B * H * T;
  const long long st[6] = {o_sb, o_sh, o_st, g_sb, g_sh, g_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch_delta<float>(out, g, delta, H, T, D, pitch, rows,
                                         st, s)
                   : launch_delta<__nv_bfloat16>(out, g, delta, H, T, D,
                                                 pitch, rows, st, s));
}

// bfloat16. `tensors` holds the tensor descriptions (hopper::kDescLen int64
// each) of q, k, v, dO, the bias (ignored when bias_mode is 0), lse and
// delta (both [1, 1, B*H, Tq] f32) in that order. Output strides are in
// elements; dbias / dbias_col and dropout as in flash_attention_bwd_f32.
// Launches the dq kernel, then the dk/dv kernel. Returns a cudaError_t.
int flash_attention_bwd_bf16(
    const long long* tensors, void* dq, void* dk, void* dv, float* dbias,
    float* dbias_col, int B, int H, int Tq, int Tk, int D, long long dq_sb,
    long long dq_sh, long long dq_st, long long dk_sb, long long dk_sh,
    long long dk_st, long long dv_sb, long long dv_sh, long long dv_st,
    int bias_mode, float sm_scale, int causal, const long long* seed,
    unsigned threshold, float drop_scale, int dropout, const int* drop_offsets, void* stream) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  constexpr int n = hopper::kDescLen;
  const long long* bias = tensors + 4 * n;
  const long long* lse = tensors + 5 * n;
  const long long* delta = tensors + 6 * n;
  Bf16BwdParams p;
  CUtensorMap* maps[4] = {&p.tq, &p.tk, &p.tv, &p.tg};
  cudaError_t err;
  for (int i = 0; i < 4; ++i)
    if ((err = hopper::make_map(maps[i], tensors + i * n, true, 64, 64)) !=
        cudaSuccess)
      return (int)err;
  if (bias_mode != 0 &&
      (err = hopper::make_map(&p.tb, bias, true, 64,
                              bias_mode == 2 ? 64 : 1)) != cudaSuccess)
    return (int)err;
  if ((err = hopper::make_map(&p.tlse, lse, false, 64, 1)) != cudaSuccess ||
      (err = hopper::make_map(&p.tdelta, delta, false, 64, 1)) != cudaSuccess)
    return (int)err;
  p.lse = reinterpret_cast<const float*>(lse[0]);
  p.delta = reinterpret_cast<const float*>(delta[0]);
  p.lse_pitch = (int)(lse[5] / 4);  // the byte stride of the rows
  p.delta_pitch = (int)(delta[5] / 4);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dbias = dbias;
  p.dbias_col = dbias_col;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_st = dq_st;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_st = dk_st;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_st = dv_st;
  p.bias_mode = bias_mode;
  p.bias_h = bias[3] == 1;  // dims innermost first: (Tk, Qb, Hb, Bb)
  p.bias_b = bias[4] == 1;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
  flash::set_offsets(p.drop, H, drop_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bf16<64>(p, s);
    case 128: return (int)launch_bf16<128>(p, s);
    case 192: return (int)launch_bf16<192>(p, s);
    default: return (int)launch_bf16<256>(p, s);
  }
}

// Dynamic shared memory of a bf16 kernel (0 = dq, 1 = dk/dv) at head dim
// D and a bias mode, in bytes.
int flash_attention_bwd_bf16_smem(int kernel, int D, int bias_mode) {
  switch (D) {
    case 64:
      return (int)(kernel ? DkvLayout<64>::smem(bias_mode)
                          : DqLayout<64>::smem(bias_mode));
    case 128:
      return (int)(kernel ? DkvLayout<128>::smem(bias_mode)
                          : DqLayout<128>::smem(bias_mode));
    case 192:
      return (int)(kernel ? DkvLayout<192>::smem(bias_mode)
                          : DqLayout<192>::smem(bias_mode));
    case 256:
      return (int)(kernel ? DkvLayout<256>::smem(bias_mode)
                          : DqLayout<256>::smem(bias_mode));
    default: return 0;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
