// Flash attention for every head dim d = 64·k above 256, forward and
// backward, dense and block-sparse, f32 and bf16, for Hopper (sm_90a).
//
// Replaces, for those head dims, the TPU kernels of
// paddle_tpu/ops/pallas_kernels/flash_attention.py that _pallas_ok and
// _sparse_pallas_ok send every multiple of 64 to, with no upper limit:
//   dense:  _fwd_kernel / _fwd_kernel_onepass (via _flash_fwd_pallas*),
//           _bwd_dq_kernel + _bwd_dkv_kernel (via _flash_bwd_pallas);
//   sparse: _fwd_kernel_sparse, _bwd_dq_kernel_sparse +
//           _bwd_dkv_kernel_sparse (via _flash_*_pallas_sparse).
// The tuned families (flash_attention_fwd.cu, flash_attention_bwd.cu,
// flash_attention_sparse.cu) keep d = 64, 128, 192 and 256: they hold a
// [64][d] q tile and stages of [64][d] k tiles in shared memory, which at
// d = 512 takes nearly all of the 227 KB an SM gives, and more backward.
// Here shared memory does not grow with d, and the head dim is a run-time
// argument.
//
// Semantics, the same as every other flash family:
//   - dense: scores past Tk take no part; scale, then the additive bias
//     (broadcast through strides), then causal as -1e30; the running max
//     starts at -1e30, a zero row sum divides by 1, lse = m + log(l); causal
//     tiles walk only the tiles they can see.
//   - sparse: query i sees keys start <= k < end of its se = (start << 16) |
//     end (and k <= i under causal); masked probabilities are exactly 0; the
//     walks visit only the 64x64 tiles whose bit of `vis` is set, so a
//     skipped tile is bitwise invisible.
//   - dropout: the keep bit of (bh, i, j) from philox.cuh's counter rule, so
//     the mask equals the plain version's; lse is over the undropped p.
//   - dbias: per query (ds itself, written by the dq CTAs; the wrapper
//     zeroes the tiles a causal walk skips) or the column sum (by the dk
//     CTAs, summed in a fixed order).
//   - delta comes from the dense backward's delta kernel, before the launch.
//   - no atomics: each output element is written by one CTA, so two calls
//     give the same bits. Grids are flat, so B·nh has no 65,535 cap.
//
// Bound. The work the function needs is 4·d flops a (query, key) pair
// forward (S, P·V) and 10·d backward (S, dP, dV, dK, dQ: 2·d each), so at
// d >= 320 the kernels are bound by operations, in f32 three TF32 products
// per product on the tensor cores (3xTF32, 495 TFLOP/s), in bf16 the tensor
// cores' 989 -- except the bf16 forward, whose bytes take a little longer
// than its operations (below). The kernels do more than that, since each
// role forms its scores itself: the f32 backward's dq and dk CTAs form S
// and dP, its dv CTAs S (16·d a pair at d = 512, below); the bf16
// backward's dq and dk CTAs form S and dP and its dv CTAs S once per
// 256-column output chunk (26·d a pair at d = 512, below).
//
// f32 design (wide_fwd_f32_kernel; wide_role_f32_kernel and
// wide_bwd_f32_kernel): every product -- S, P·V; S, dP, dQ, dK, dV -- in
// 3xTF32 on mma.sync.m16n8k8 (tf32x3.cuh: the split, the ldmatrix
// fragments, mma3). The tensor core's sums round toward zero, so S and dP
// sum 8 columns at a time into zeroed sums, added in pairs to the running
// sum (product_pairs: on the CPU model a 512-deep product comes out
// closer to the exact sum than with the tuned kernels' 16-column partial
// sums, tests/test_torch_flash_attention.py; the per-query dbias takes
// dP − delta, where the two cancel), and an output's product takes a
// tile into a zeroed partial sum. A CTA of eight warps owns 32 rows (queries; keys in dk and dv):
// two row groups of 16 rows, each split over four column warps. The four
// warps of a row group split the head dim of S = X·Yᵀ (and dP) by
// 64-column blocks: block j goes to partial group j % 4, the group's
// blocks summed in order; the four partials go through shared memory and
// every warp of the row group adds them in one order,
// S = ((G0 + G1) + G2) + G3, so all four hold the same bits of S, of m and
// l, and of P or dS. Each warp then multiplies P
// (dS, Pᵀ, dSᵀ) from its registers by its own output blocks, those of
// index c, c + 4 (c = its column warp), at most two: a CTA holds 512
// output columns; above d = 512 the output blocks are split into
// ceil(d / 512) chunks, a grid factor, each chunk forming S again. The
// forward and the dq, dk, dv walks split and sum S alike, so the lse the
// forward writes is the one the backward's S gives: dk and dv form Sᵀ =
// K·Qᵀ (and dPᵀ = V·dOᵀ) with each mma3's two cross terms in the other
// order (mma3_order), so that each element's terms are added in the same
// order as in Q·Kᵀ and all four kinds hold the same bits of S.
//   Work a (query, key) pair at d = 512: forward 4d (S once, P·V once),
//   6d where the forward doubles its grid (below); backward 16d: dq CTAs
//   form S, dP and dQ (6d), dk CTAs S, dP and dK (6d), dv CTAs S and dV
//   (4d): a launch each (dk, dq, dv) where one role's CTAs fill 3/4 of
//   the SMs (each role kernel then has its own registers), else one
//   launch of all three. K, V, Q and dO stream through a two-stage
//   cp.async ring, one step ahead of the math: a step brings, for each of
//   the four column warps, one 64-wide head-dim block of the row side (32
//   rows) and of the column side (64 rows) for S or dP, or one output
//   block of the column side (V, K, Q or dO: 64 rows) for the output
//   product, into a [96][260] f32 stage (a pitch of 4 mod 32 floats:
//   ldmatrix without bank conflicts). A tile pair takes ceil(d / 256) S
//   steps (and as many dP steps) and ceil(chunk / 256) output steps; at
//   d = 256·k + 64·m the last step of each kind runs m of the four
//   warps. Shared memory: two stages and the partials (8 warps x 32 x 32
//   floats), 232,448 bytes at every d, one CTA of 8 warps an SM. Keep
//   bits are drawn in registers (flash::keep_bits_rows / keep_bits_cols);
//   lse, delta and se of a dk/dv tile's queries are read through L1.
//   Grid fill: 32-row tiles give B·nh·T/32 CTAs a kind (128 forward at
//   B·nh = 8, T = 512); where that is at most half the SMs and d >= 512,
//   the forward splits its output columns over two CTAs (S formed twice,
//   6d a pair) to fill the card.
//
// bf16 forward (bfw::wide_fwd_bf16_kernel). At d = 512 a perfect kernel is
// bound by bytes (each of q, k, v, out read or written once: 0.005 ms at
// B·nh = 8, T = 512), the operations (4d flops a pair) a little below.
// The design:
//   - runs both products on wgmma from boxes TMA writes (hopper.cuh: 64
//     rows x 64 values, 128-byte swizzle): S with Q and K K-major, then
//     O += P·V with P rounded to bf16 in registers (the RS form) and V's
//     boxes read MN-major, with no transposed copy;
//   - gives a CTA (one warpgroup) 64 queries and a chunk of up to four
//     64-wide output blocks, 256 columns (O is 128 registers a thread,
//     beside S and its partial, 32 each): chunks are ceil(d / 256), so at
//     d = 512 S is formed twice (6d a pair);
//   - sums S one 64-wide head-dim slice at a time, each slice's four k
//     steps into a zeroed partial added in slice order, as the backward
//     sums it (the tensor core's sums round toward zero);
//   - keeps Q's first eight head-dim boxes in shared memory for the walk
//     (64 KB; slices past d = 512 stream with K) and streams K's slices,
//     the bias box and V's boxes through a ring of five 8 KB slots with an
//     mbarrier each, thread 0 issuing each copy five items ahead, just
//     after a product is started: 108,224 bytes of shared memory at every
//     d, so two CTAs share an SM;
//   - has no branch in its element loop (masks, the ragged edge and
//     dropout are selects; keep bits drawn in registers); a max that does
//     not move rescales by exactly 1, so a tile without a visible pair
//     changes no bit and a sparse skip is bitwise invisible.
// On the card it is bound by neither bytes nor operations but by each
// warpgroup's chain: a slice's products, their wait, thread 0's copies and
// the softmax run in turn (removing nearly all K and V copies did not make
// it faster; PERF.md). Two CTAs an SM hide each other's waits, so where the
// (chunk, q tile) cells fill over half the SMs and at most all of them,
// and the walk is eight key tiles or more, a cluster of two CTAs splits
// each walk (from the SM count): rank r takes the key tiles kt ≡ r (mod 2)
// with its own m, l and O, then each puts them into its shared memory and
// rank r writes the output blocks j ≡ r (mod 2), reading the other's over
// distributed shared memory and summing the ranks in rank order, so l, the
// lse and two calls' bits are the same.
// bf16 backward (bwb::wide_bwd_bf16_kernel). It runs the forward's
// machinery three times over, one role a CTA, all in one launch (dk CTAs,
// then dq, then dv, the shorter dv walks filling the tail):
//   - dq: 64 queries, walking their key tiles: S = Q·Kᵀ, then dP = dO·Vᵀ,
//     then dQ += dS·K; dk: 64 keys, walking their q tiles (from the
//     diagonal when causal): Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dK += dSᵀ·Q; dv: Sᵀ,
//     then dV += P_dropᵀ·dO. Each CTA holds a chunk of up to four 64-wide
//     output blocks, 256 columns (128 registers a thread beside the scores
//     and their partial, 32 each, as in the forward); chunks are
//     ceil(d / 256), a grid factor. Work a pair at d = 512: dq 2·(4d) +
//     2d, dk the same, dv 2·(2d) + 2d, so 26d (the first design: 70d;
//     one dk/dv role holding both outputs would need 128-column chunks,
//     30d). P does not stay in registers while dP is formed: each thread
//     puts its 32 values in shared memory and takes them back for dS (16
//     KB a CTA), so no more than the forward's 192 floats are live and
//     ptxas spills nothing.
//   - every product on wgmma from boxes TMA writes (hopper.cuh): S and dP
//     (and their transposes) from K-major boxes, each 64-wide head-dim
//     slice's four k steps into a zeroed partial added in slice order, the
//     forward's sequence, so the dq CTAs' S is the one whose lse the forward
//     wrote; the output products take dS, P_dropᵀ or dSᵀ from registers
//     (rounded to bf16, the RS form) and read K, dO or Q MN-major, with no
//     transposed copy.
//   - one ring of four 16 KB slots, an mbarrier each: an item is a slice's
//     two operand boxes, or two output boxes; thread 0 issues each copy
//     four items ahead, just after a product starts. A tile's first item
//     also brings its head into one of two buffers (by the tile's parity):
//     the bias box (the mask's row, or 64x64 per query) and, for dk and
//     dv, the lse, delta and se of the tile's 64 queries. 101,568 bytes of
//     shared memory at every d: two CTAs an SM.
//   - the element loops have no branch (masks, the ragged edge and dropout
//     are selects, p exactly 0 where masked; keep bits drawn in registers),
//     so a skipped sparse tile, which would add exact zeros, is bitwise
//     invisible; the per-query dbias is ds, written by the dq CTAs of chunk
//     0 (the wrapper zeroes the tiles a causal walk skips), the column-sum
//     dbias the dk CTAs' of chunk 0, summed in walk order; no atomics.
// Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX package
constexpr int kTile = 64;          // queries, keys and head-dim columns

struct WideParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO (backward)
  const void* bias;    // dense: additive bias in the input type, or nullptr
  const int* se;       // sparse: [B, Tq] (start << 16) | end
  const int* vis;      // sparse: [B, nq, nk] tile table
  void* out;           // forward
  float* lse_out;      // forward: [B*H, Tq]
  const float* lse;    // backward: rows lse_pitch floats apart
  const float* delta;  // backward: rows delta_pitch floats apart
  long long lse_pitch, delta_pitch;
  void* dq;
  void* dk;
  void* dv;
  float* dbias;        // per query [B*H, Tq, Tk] or nullptr
  float* dbias_col;    // column sum [B*H, Tk] or nullptr
  int B, H, Tq, Tk, D;
  long long q_s[3], k_s[3], v_s[3], g_s[3];  // (batch, head, token) strides
  long long o_s[3], dq_s[3], dk_s[3], dv_s[3];
  long long b_s[4];                          // bias (batch, head, q, k)
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

__device__ __forceinline__ void unpack_se(int se, int& start, int& end) {
  start = static_cast<int>(static_cast<unsigned>(se) >> 16);
  end = se & 0xFFFF;
}

// ---------------------------------------------------------------------------
// f32: every product in 3xTF32 on mma.sync.m16n8k8 (tf32x3.cuh), a CTA of
// eight warps over 32 rows, tiles by cp.async (the design in the header).
// ---------------------------------------------------------------------------
// Launches `kernel` on a flat grid of `ctas` CTAs of `threads` threads with
// `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), long long ctas, int threads,
                   int smem, cudaStream_t s, Args... args) {
  if (ctas <= 0 || ctas > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)ctas, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

namespace f32w {

using tf32x3::acc_product_tf32;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::ldsm_a;
using tf32x3::ldsm_b2;
using tf32x3::mma3;
using tf32x3::store_rows_f32;

constexpr int kRows = 32;           // rows a CTA owns: two row groups of 16
constexpr int kCols = 64;           // columns of a score tile
constexpr int kBlk = 64;            // head-dim block
constexpr int kGroups = 4;          // column warps of a row group
constexpr int kWarps = 2 * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kOutBlocks = 2;       // output blocks a warp holds
constexpr int kChunkBlocks = kGroups * kOutBlocks;  // 512 columns a CTA
constexpr int kPitch = kGroups * kBlk + 4;          // 260 floats, 4 mod 32
constexpr int kStage = (kCols + kRows) * kPitch;    // floats: Y, then X
constexpr int kXch = kWarps * 32 * 32;              // floats: the partials
constexpr int kSmemBytes = (2 * kStage + kXch) * (int)sizeof(float);

enum Kind { kFwd, kDq, kDk, kDv };

// Starts the copy of `nb` contiguous 64-wide head-dim blocks of ROWS rows
// (`st` floats apart, from src) into a stage at dst; rows past `valid` are
// zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_blocks(float* dst, const float* src,
                                            long long st, int valid, int nb,
                                            int tid) {
  const int per_row = nb * (kBlk / 4);  // 16-byte vectors a row
  for (int i = tid; i < ROWS * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    cp_async16(dst + r * kPitch + c, src + (r < valid ? r : 0) * st + c,
               r < valid);
  }
}

// d += a·b on one 16x8 block in 3xTF32 as tf32x3::mma3 sums it, or, with
// SWAP, with its two cross terms in the other order: small·big, then
// big·small, then big·big. A product of the transposed pair (Sᵀ = K·Qᵀ
// beside S = Q·Kᵀ) then adds each element's terms in the order of the
// other, so the two give the same bits.
template <bool SWAP>
__device__ __forceinline__ void mma3_order(float* d, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  if constexpr (SWAP) {
    tf32x3::mma_tf32(d, as, bb0, bb1);
    tf32x3::mma_tf32(d, ab, bs0, bs1);
    tf32x3::mma_tf32(d, ab, bb0, bb1);
  } else {
    mma3(d, ab, as, bb0, bb1, bs0, bs1);
  }
}

// s += A·Bᵀ for the warp's 16 rows (from r0) over one 64-column head-dim
// block of two stage tiles (a row per M and N index), 16 columns at a time:
// each 8-deep step's three mma (mma3_order) into a zeroed sum, the pair's
// two sums added, then that added to s, both rounding to nearest, so the
// tensor core's round-toward-zero sums span 8 columns. SWAP where A is the
// key side (dk and dv: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ). Register 4·nb + 2h + e of
// lane (g, t) is row r0 + g + 8h, column 8·nb + 2t + e.
template <bool SWAP>
__device__ __forceinline__ void product_pairs(float (&s)[32], const float* sA,
                                              const float* sB, int r0, int g,
                                              int t) {
  const int lane = 4 * g + t;
  const int brow = (lane & 7) + 8 * (lane >> 4);  // column of two blocks
#pragma unroll 1
  for (int k0 = 0; k0 < kBlk; k0 += 16) {
    uint32_t ab[2][4], as[2][4];
    ldsm_a(sA, kPitch, r0, k0, lane, ab[0], as[0]);
    ldsm_a(sA, kPitch, r0, k0 + 8, lane, ab[1], as[1]);
#pragma unroll
    for (int nb = 0; nb < 8; nb += 2) {
      float p0[8], p1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p0[i] = p1[i] = 0.f;
      uint32_t bb[4], bs[4];
      ldsm_b2(sB, kPitch, 8 * nb + brow, k0, lane, bb, bs);
      mma3_order<SWAP>(&p0[0], ab[0], as[0], bb[0], bb[1], bs[0], bs[1]);
      mma3_order<SWAP>(&p0[4], ab[0], as[0], bb[2], bb[3], bs[2], bs[3]);
      ldsm_b2(sB, kPitch, 8 * nb + brow, k0 + 8, lane, bb, bs);
      mma3_order<SWAP>(&p1[0], ab[1], as[1], bb[0], bb[1], bs[0], bs[1]);
      mma3_order<SWAP>(&p1[4], ab[1], as[1], bb[2], bb[3], bs[2], bs[3]);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[4 * nb + i] += p0[i] + p1[i];
    }
  }
}

__device__ __forceinline__ void zero32(float (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
}

// The partial sums of S (or dP) through shared memory, in fragment order
// (every warp of a row group holds the same elements in the same
// registers): put the warp's; then, after a barrier, the row group's sum in
// the fixed order ((G0 + G1) + G2) + G3, group c being column warp c's.
__device__ __forceinline__ void xch_put(float* xch, const float (&a)[32],
                                        int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) xch[(warp * 32 + i) * 32 + lane] = a[i];
}
__device__ __forceinline__ void xch_sum(float (&a)[32], const float* xch,
                                        int rg, int lane) {
  const float* x = xch + rg * kGroups * 1024 + lane;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    a[i] = ((x[i * 32] + x[1024 + i * 32]) + x[2048 + i * 32]) +
           x[3072 + i * 32];
}

// One CTA of kind KIND: rows [r0, r0 + 32) of one (b, h) (queries for the
// forward and dq, keys for dk and dv) and its chunk `oc` of the output
// blocks, walking the column tiles it sees (keys; queries for dk and dv).
// A tile is n_s S steps (then n_s dP steps for dq and dk), then n_o
// output steps; the ring runs two steps ahead over the tiles' steps.
template <int KIND, bool SPARSE>
__device__ __forceinline__ void wide_f32_cta(const WideParams& p, int nch,
                                             int cta) {
  constexpr bool kQRows = KIND == kFwd || KIND == kDq;  // rows are queries
  constexpr bool kDp = KIND == kDq || KIND == kDk;       // dP is formed
  extern __shared__ __align__(16) float smem_f32[];
  float* stages = smem_f32;
  float* xch = smem_f32 + 2 * kStage;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / kGroups, cw = warp % kGroups;
  const int n_rows = kQRows ? p.Tq : p.Tk, n_cols = kQRows ? p.Tk : p.Tq;
  const int n_rt = (n_rows + kRows - 1) / kRows;
  const int oc = cta % nch, cell = cta / nch;  // grid: (chunk, tile, b·h)
  const int bh = cell / n_rt, r0 = (cell % n_rt) * kRows;
  const int b = bh / p.H, h = bh % p.H;
  const int row = r0 + 16 * rg + g;  // this thread's rows: row, row + 8
  const int nblk = p.D / kBlk, bpc = (nblk + nch - 1) / nch;
  const int ob0 = oc * bpc, nob = min(bpc, nblk - ob0);  // output blocks
  const int n_s = (nblk + kGroups - 1) / kGroups;
  const int n_o = (nob + kGroups - 1) / kGroups;
  const int n_sp = n_s * (kDp ? 2 : 1);  // S (and dP) steps a tile
  const int n_per = n_sp + n_o;          // steps a tile

  auto at = [&](const void* base, const long long (&s)[3]) {
    return static_cast<const float*>(base) + b * s[0] + h * s[1];
  };
  const float* q = at(p.q, p.q_s);
  const float* k = at(p.k, p.k_s);
  const float* v = at(p.v, p.v_s);
  const float* gg = KIND == kFwd ? nullptr : at(p.g, p.g_s);
  // S = xs·ysᵀ and dP = xp·ypᵀ (rows the CTA's, columns the tile's), then
  // out += A·z over the CTA's output blocks
  const float *xs, *ys, *xp, *yp, *z;
  long long xs_t, ys_t, xp_t, yp_t, z_t;
  if (kQRows) {
    xs = q; xs_t = p.q_s[2]; ys = k; ys_t = p.k_s[2];
    xp = gg; xp_t = p.g_s[2]; yp = v; yp_t = p.v_s[2];
    z = KIND == kFwd ? v : k;
    z_t = KIND == kFwd ? p.v_s[2] : p.k_s[2];
  } else {
    xs = k; xs_t = p.k_s[2]; ys = q; ys_t = p.q_s[2];
    xp = v; xp_t = p.v_s[2]; yp = gg; yp_t = p.g_s[2];
    z = KIND == kDk ? q : gg;
    z_t = KIND == kDk ? p.q_s[2] : p.g_s[2];
  }

  // the column tiles this CTA visits
  const int n_ct = (n_cols + kCols - 1) / kCols;
  int ct_begin = 0, ct_end = n_ct;
  if (!SPARSE && p.causal) {
    if (kQRows)
      ct_end = min(n_ct, (min(r0 + kRows, p.Tq) - 1) / kCols + 1);
    else
      ct_begin = min(r0 / kCols, n_ct);  // q tiles from the diagonal
  }
  const int nq64 = (p.Tq + 63) / 64, nk64 = (p.Tk + 63) / 64;
  const int* vis = nullptr;
  long long vstep = 0;
  if (SPARSE) {
    vis = kQRows ? p.vis + ((long long)b * nq64 + r0 / 64) * nk64
                 : p.vis + (long long)b * nq64 * nk64 + r0 / 64;
    vstep = kQRows ? 1 : nk64;
  }
  auto next_tile = [&](int ct) {  // the next tile after ct the walk visits
    ++ct;
    if (SPARSE)
      while (ct < ct_end && __ldg(vis + ct * vstep) == 0) ++ct;
    return ct;
  };
  const int first = next_tile(ct_begin - 1);

  // step s of column tile ct into stage st
  auto load = [&](int ct, int s, float* st) {
    const int c0 = ct * kCols;
    if (s < n_sp) {
      const bool dp = s >= n_s;
      const int j0 = kGroups * (dp ? s - n_s : s);  // first head-dim block
      const int nb = min(kGroups, nblk - j0);
      const float* x = dp ? xp : xs;
      const float* y = dp ? yp : ys;
      const long long xt = dp ? xp_t : xs_t, yt = dp ? yp_t : ys_t;
      copy_blocks<kRows>(st + kCols * kPitch, x + r0 * xt + j0 * kBlk, xt,
                         n_rows - r0, nb, tid);
      copy_blocks<kCols>(st, y + c0 * yt + j0 * kBlk, yt, n_cols - c0, nb,
                         tid);
    } else {
      const int j0 = kGroups * (s - n_sp);  // first output block, in chunk
      copy_blocks<kCols>(st, z + c0 * z_t + (ob0 + j0) * kBlk, z_t,
                         n_cols - c0, min(kGroups, nob - j0), tid);
    }
  };
  int lt = first, ls = 0;  // the loader's cursor: tile, step
  auto load_next = [&](float* st) {
    if (lt < ct_end) {
      load(lt, ls, st);
      if (++ls == n_per) {
        ls = 0;
        lt = next_tile(lt);
      }
    }
    cp_async_commit();
  };
  load_next(stages);
  load_next(stages + kStage);

  uint32_t key0 = 0, key1 = 0;
  if (p.drop.on) {
    const unsigned long long sd =
        static_cast<unsigned long long>(*p.drop.seed);
    key0 = static_cast<uint32_t>(sd);
    key1 = static_cast<uint32_t>(sd >> 32);
  }
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_s[0] + h * p.b_s[1];
  // per-row values where rows are queries; for dk and dv, the rows of lse,
  // delta and se that the columns (queries) read
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  int st_r[2] = {0, 0}, en_r[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = row + 8 * hh;
    if (KIND == kDq && rr < p.Tq) {
      lse_r[hh] = p.lse[(long long)bh * p.lse_pitch + rr];
      delta_r[hh] = p.delta[(long long)bh * p.delta_pitch + rr];
    }
    if (SPARSE && kQRows)
      unpack_se(p.se[(long long)b * p.Tq + rr], st_r[hh], en_r[hh]);
  }
  const float* lse_c =
      kQRows ? nullptr : p.lse + (long long)bh * p.lse_pitch;
  const float* delta_c =
      KIND == kDk ? p.delta + (long long)bh * p.delta_pitch : nullptr;
  const int* se_c = SPARSE && !kQRows ? p.se + (long long)b * p.Tq : nullptr;

  float sa[32], pa[32], o[kOutBlocks][32];
  float dbc[2] = {0.f, 0.f};  // dk: column sums of ds for keys row, row + 8
#pragma unroll
  for (int rr = 0; rr < kOutBlocks; ++rr) zero32(o[rr]);

  int j = 0;  // steps taken: step j is in stage j & 1
  for (int ct = first; ct < ct_end; ct = next_tile(ct)) {
    const int c0 = ct * kCols;
    for (int s = 0; s < n_per; ++s, ++j) {
      float* st = stages + (j & 1) * kStage;
      cp_async_wait<1>();
      __syncthreads();  // step j's tiles have landed, from every thread
      if (s < n_s) {  // S: this warp's head-dim block of the step
        if (s == 0) zero32(sa);
        if (kGroups * s + cw < nblk)
          product_pairs<!kQRows>(sa, st + kCols * kPitch + kBlk * cw,
                                 st + kBlk * cw, 16 * rg, g, t);
        if (s == n_s - 1) xch_put(xch, sa, warp, lane);
      } else if (s < n_sp) {  // dP, likewise
        if (s == n_s) zero32(pa);
        if (kGroups * (s - n_s) + cw < nblk)
          product_pairs<!kQRows>(pa, st + kCols * kPitch + kBlk * cw,
                                 st + kBlk * cw, 16 * rg, g, t);
        if (s == n_sp - 1) xch_put(xch, pa, warp, lane);
      } else if (kGroups * (s - n_sp) + cw < nob) {
        // out += A·z over this warp's output block of the step
#pragma unroll
        for (int rr = 0; rr < kOutBlocks; ++rr) {
          if (rr != s - n_sp) continue;
          if constexpr (KIND == kDk)
            acc_product_tf32<kBlk, kPitch>(o[rr], pa, st + kBlk * cw, g, t);
          else
            acc_product_tf32<kBlk, kPitch>(o[rr], sa, st + kBlk * cw, g, t);
        }
      }
      __syncthreads();  // every warp is done with the stage, partials put
      load_next(st);

      if (s == n_s - 1) xch_sum(sa, xch, rg, lane);
      if (kDp && s == n_sp - 1) xch_sum(pa, xch, rg, lane);
      if (s != n_sp - 1) continue;
      if constexpr (KIND == kFwd) {
        // scale, bias, masks; the online softmax; P (dropped) in sa
        float mx[2] = {kNegInf, kNegInf};
        uint32_t seen = 0;  // sparse: bit i = register i is visible
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1, rr = row + 8 * hh;
          const int col = c0 + (i >> 2) * 8 + 2 * t + (i & 1);
          float x = sa[i] * p.sm_scale;
          if (SPARSE) {
            const bool ok = col >= st_r[hh] && col < en_r[hh] &&
                            (!p.causal || col <= rr);
            seen |= ok ? 1u << i : 0u;
            x = ok ? x : kNegInf;
          } else {
            if (bias != nullptr && rr < p.Tq && col < p.Tk)
              x += __ldg(bias + rr * p.b_s[2] + col * p.b_s[3]);
            x = p.causal && col > rr ? kNegInf : x;
            x = col < p.Tk ? x : -INFINITY;
          }
          sa[i] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float m_new = fmaxf(m[hh], mx[hh]);
          // exactly 1 where the max holds: a tile with no visible pair
          // changes no bit
          corr[hh] = m_new == m[hh]
              ? 1.f : hopper::ex2((m[hh] - m_new) * hopper::kLog2e);
          m[hh] = m_new;
        }
        const uint32_t keep =
            p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop,
                                              bh, row, c0, t)
                      : ~0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          float pr = hopper::ex2((sa[i] - m[hh]) * hopper::kLog2e);
          if (SPARSE) pr = (seen >> i) & 1u ? pr : 0.f;
          sum[hh] += pr;  // the row sum is over the undropped p
          sa[i] = (keep >> i) & 1u ? pr * drop_scale : 0.f;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
          sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
          l[hh] = l[hh] * corr[hh] + sum[hh];
        }
#pragma unroll
        for (int rr = 0; rr < kOutBlocks; ++rr)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[rr][i] *= corr[(i >> 1) & 1];
      } else if constexpr (KIND == kDq) {
        // ds = p·(dp − delta) in place of s; the per-query dbias is ds
        const uint32_t keep =
            p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop,
                                              bh, row, c0, t)
                      : ~0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1, rr = row + 8 * hh;
          const int col = c0 + (i >> 2) * 8 + 2 * t + (i & 1);
          float x = sa[i] * p.sm_scale;
          bool ok;
          if (SPARSE) {
            ok = col >= st_r[hh] && col < en_r[hh] &&
                 (!p.causal || col <= rr);
          } else {
            ok = rr < p.Tq && col < p.Tk;
            if (bias != nullptr && ok)
              x += __ldg(bias + rr * p.b_s[2] + col * p.b_s[3]);
            x = p.causal && col > rr ? kNegInf : x;
          }
          const float pr =
              ok ? hopper::ex2((x - lse_r[hh]) * hopper::kLog2e) : 0.f;
          const float dpv = (keep >> i) & 1u ? pa[i] * drop_scale : 0.f;
          sa[i] = pr * (dpv - delta_r[hh]);
          // each element by one warp: n-blocks 2cw and 2cw + 1
          if (!SPARSE && p.dbias != nullptr && oc == 0 && ok &&
              (i >> 3) == cw)
            p.dbias[((long long)bh * p.Tq + rr) * p.Tk + col] = sa[i];
        }
      } else {
        // rows are keys, columns queries: dk: ds in place of dPᵀ; dv:
        // p_drop in place of Sᵀ
        const uint32_t keep =
            p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop,
                                              bh, row, c0, lane)
                      : ~0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1, key = row + 8 * hh;
          const int col = c0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const int qc = min(col, p.Tq - 1);
          float x = sa[i] * p.sm_scale;
          bool ok;
          if (SPARSE) {
            int s0, e0;
            unpack_se(__ldg(se_c + col), s0, e0);
            ok = key >= s0 && key < e0 && (!p.causal || key <= col);
          } else {
            ok = col < p.Tq && key < p.Tk;
            if (bias != nullptr && ok)
              x += __ldg(bias + col * p.b_s[2] + key * p.b_s[3]);
            x = p.causal && key > col ? kNegInf : x;
          }
          const float pr =
              ok ? hopper::ex2((x - __ldg(lse_c + qc)) * hopper::kLog2e)
                 : 0.f;
          const bool kept = (keep >> i) & 1u;
          if constexpr (KIND == kDk) {
            const float ds = pr * ((kept ? pa[i] * drop_scale : 0.f) -
                                   __ldg(delta_c + qc));
            pa[i] = ds;
            dbc[hh] += ds;
          } else {
            sa[i] = kept ? pr * drop_scale : 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // this warp's output blocks: rows row and row + 8, times sc0 and sc1
  auto store = [&](void* base, const long long (&s)[3], float sc0,
                   float sc1) {
    float* dst = static_cast<float*>(base) + b * s[0] + h * s[1];
#pragma unroll
    for (int rr = 0; rr < kOutBlocks; ++rr) {
      const int jl = kGroups * rr + cw;
      if (jl < nob)
        store_rows_f32<kBlk>(dst + (ob0 + jl) * kBlk, s[2], o[rr], row,
                             n_rows, t, sc0, sc1);
    }
  };
  if constexpr (KIND == kFwd) {
    float l_safe[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l_safe[hh] = l[hh] == 0.f ? 1.f : l[hh];
      const int rr = row + 8 * hh;
      if (cw == 0 && t == 0 && oc == 0 && rr < p.Tq)
        p.lse_out[(long long)bh * p.Tq + rr] = m[hh] + logf(l_safe[hh]);
    }
    store(p.out, p.o_s, 1.f / l_safe[0], 1.f / l_safe[1]);
  } else if constexpr (KIND == kDq) {
    store(p.dq, p.dq_s, p.sm_scale, p.sm_scale);
  } else if constexpr (KIND == kDk) {
    store(p.dk, p.dk_s, p.sm_scale, p.sm_scale);
    if (!SPARSE && p.dbias_col != nullptr && oc == 0 && cw == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 1);
        dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 2);
        if (t == 0 && row + 8 * hh < p.Tk)
          p.dbias_col[(long long)bh * p.Tk + row + 8 * hh] = dbc[hh];
      }
    }
  } else {
    store(p.dv, p.dv_s, 1.f, 1.f);
  }
}

template <bool SPARSE>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_f32_kernel(WideParams p, int nch) {
  wide_f32_cta<kFwd, SPARSE>(p, nch, blockIdx.x);
}

// The backward, one role a launch (dk, dq, dv in turn): each role kernel
// gets its own register allocation, which the three bodies inlined in one
// kernel do not (that kernel ran slower where one role fills the card).
template <int KIND, bool SPARSE>
__global__ void __launch_bounds__(kThreads, 1)
wide_role_f32_kernel(WideParams p, int nch) {
  wide_f32_cta<KIND, SPARSE>(p, nch, blockIdx.x);
}

// The backward in one launch, dk CTAs, then dq CTAs, then dv CTAs: where
// one role's CTAs would fill under 3/4 of the SMs, so that three launches
// would leave the card idle.
template <bool SPARSE>
__global__ void __launch_bounds__(kThreads, 1)
wide_bwd_f32_kernel(WideParams p, int nch, int n_dk, int n_dq) {
  const int x = blockIdx.x;
  if (x < n_dk)
    wide_f32_cta<kDk, SPARSE>(p, nch, x);
  else if (x < n_dk + n_dq)
    wide_f32_cta<kDq, SPARSE>(p, nch, x - n_dk);
  else
    wide_f32_cta<kDv, SPARSE>(p, nch, x - n_dk - n_dq);
}

// The current device's SMs (0 where it cannot be read).
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// Output chunks: ceil(d / 512); the forward splits d >= 512 over two when
// its 32-row tiles would fill at most half the SMs.
int chunks(const WideParams& p, bool fwd) {
  const int nblk = p.D / kBlk;
  int nch = (nblk + kChunkBlocks - 1) / kChunkBlocks;
  if (fwd && nch == 1 && nblk >= kChunkBlocks &&
      2ll * ((p.Tq + kRows - 1) / kRows) * p.B * p.H <= sm_count())
    nch = 2;
  return nch;
}

// Row tiles of all (b, h) pairs.
long long tiles(int T, const WideParams& p) {
  return (long long)((T + kRows - 1) / kRows) * p.B * p.H;
}

long long fwd_ctas(const WideParams& p) {
  return tiles(p.Tq, p) * chunks(p, true);
}

long long bwd_ctas(const WideParams& p) {
  return (2 * tiles(p.Tk, p) + tiles(p.Tq, p)) * chunks(p, false);
}

template <bool SPARSE>
cudaError_t run_fwd(const WideParams& p, cudaStream_t s) {
  return launch(wide_fwd_f32_kernel<SPARSE>, fwd_ctas(p), kThreads,
                kSmemBytes, s, p, chunks(p, true));
}

template <bool SPARSE>
cudaError_t run_bwd(const WideParams& p, cudaStream_t s) {
  const int nch = chunks(p, false);
  const long long nk = tiles(p.Tk, p) * nch, nq = tiles(p.Tq, p) * nch;
  if (4 * std::min(nk, nq) < 3ll * sm_count())
    return launch(wide_bwd_f32_kernel<SPARSE>, 2 * nk + nq, kThreads,
                  kSmemBytes, s, p, nch, (int)nk, (int)nq);
  cudaError_t err = launch(wide_role_f32_kernel<kDk, SPARSE>, nk, kThreads,
                           kSmemBytes, s, p, nch);
  if (err == cudaSuccess)
    err = launch(wide_role_f32_kernel<kDq, SPARSE>, nq, kThreads,
                 kSmemBytes, s, p, nch);
  if (err == cudaSuccess)
    err = launch(wide_role_f32_kernel<kDv, SPARSE>, nk, kThreads,
                 kSmemBytes, s, p, nch);
  return err;
}

}  // namespace f32w

// ---------------------------------------------------------------------------
// bf16 forward: one warpgroup a CTA on wgmma, every operand a 64x64 box that
// TMA writes (hopper.cuh); the CTAs of a cluster split the key walk (the
// design in the header).
// ---------------------------------------------------------------------------
namespace bfw {

constexpr int kThreads = 128;     // one warpgroup
constexpr int kBox = hopper::kBoxBytes;
constexpr int kQBoxes = 8;        // Q's head-dim boxes kept resident
constexpr int kRing = 5;          // ring slots, one box each
constexpr int kChunkBlocks = 4;   // output blocks (64 columns) a CTA holds
constexpr int kBarOff = (kQBoxes + kRing) * kBox;  // kRing slot barriers, Q's
constexpr int kRowsOff = kBarOff + 64;             // m, l of the 64 rows
constexpr int kVisOff = kRowsOff + 2 * 64 * 4;     // sparse: tile bits
constexpr int kSmem = kVisOff + 128 + 1024;        // + the swizzle's align

struct Params {
  CUtensorMap tq, tk, tv;  // [B, H, T, D]: boxes of 64 rows x 64 values
  CUtensorMap tb;          // bias [Bb, Hb, Qb, Tk]: 1 or 64 rows x 64 keys
  const int* se;           // sparse: [B, Tq] (start << 16) | end
  const int* vis;          // sparse: [B, Tq / 64, Tk / 64]
  bf* out;
  float* lse;              // [B*H, Tq]
  int B, H, Tq, Tk, D;
  long long o_sb, o_sh, o_st;
  int bias_mode;           // 0 none, 1 one row for all queries, 2 per query
  int bias_b, bias_h;      // 1 = the bias is broadcast over batch / heads
  float sm_scale;
  int causal;
  flash::Dropout drop;
  int nch, split;          // output chunks; CTAs that split one key walk
};

// Output chunks: ceil(d / 256), so that at d = 512 S is formed twice.
inline int chunks(int D) {
  return (D / kTile + kChunkBlocks - 1) / kChunkBlocks;
}

// CTAs that split one walk over the key tiles, a cluster: 2 where that
// puts two CTAs on most SMs in one wave (the cells fill over half the SMs
// and at most all of them) and leaves each CTA four key tiles or more,
// else 1.
inline int split_of(long long cells, int nk, int sms) {
  return 2 * cells > sms && cells <= sms && nk >= 8 ? 2 : 1;
}

inline long long cells(int B, int H, int Tq, int D) {
  return (long long)((Tq + kTile - 1) / kTile) * B * H * chunks(D);
}

// The CTA's place in the flat grid (rank, chunk, q tile, b·h), the rank
// fastest: the `split` CTAs of a cluster share a (chunk, q tile, b·h).
struct Place {
  int rank, oc, tile, bh, b, h;
};
__device__ __forceinline__ Place place_of(const Params& p, int nq) {
  const long long x = blockIdx.x;
  Place c;
  c.rank = static_cast<int>(x % p.split);
  const long long cell = x / p.split;
  c.oc = static_cast<int>(cell % p.nch);
  c.tile = static_cast<int>((cell / p.nch) % nq);
  c.bh = static_cast<int>(cell / ((long long)p.nch * nq));
  c.b = c.bh / p.H;
  c.h = c.bh % p.H;
  return c;
}

// One CTA: queries [q0, q0 + 64) of (b, h), the output blocks [ob0, ob0 +
// nob) of its chunk, the key tiles kt ≡ rank (mod split) it sees. A tile is
// a run of ring items, one box each: per head-dim slice c, Q's box when c
// is past the resident ones, then K's; the bias box (dense, with a bias);
// then V's box of each output block.
template <bool SPARSE>
__global__ void __launch_bounds__(kThreads, 2)
wide_fwd_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* ring = smem + kQBoxes * kBox;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  float* sRows = reinterpret_cast<float*>(smem + kRowsOff);
  uint32_t* sVis = reinterpret_cast<uint32_t*>(smem + kVisOff);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;
  const int nq = (p.Tq + kTile - 1) / kTile, nk = (p.Tk + kTile - 1) / kTile;
  const Place c = place_of(p, nq);
  const int q0 = c.tile * kTile;
  const int nblk = p.D / kTile, bpc = (nblk + p.nch - 1) / p.nch;
  const int ob0 = c.oc * bpc, nob = min(bpc, nblk - ob0);
  const int nqb = min(nblk, kQBoxes);
  const int n_s = nblk + max(0, nblk - kQBoxes);  // S items a tile
  const int n_b = p.bias_mode != 0 ? 1 : 0;
  const int n_it = n_s + n_b + nob;                // items a tile

  int n_k = nk;  // dense causal: the tiles through the diagonal
  if (!SPARSE && p.causal)
    n_k = min(nk, (min(q0 + kTile, p.Tq) - 1) / kTile + 1);
  if (SPARSE) {  // the q tile's row of vis as bits (nk <= 1024)
    const int* vis = p.vis + ((long long)c.b * nq + c.tile) * nk;
    for (int w = warp; w * 32 < nk; w += kThreads / 32) {
      const int kt = w * 32 + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu,
                                          kt < nk && __ldg(vis + kt) != 0);
      if (lane == 0) sVis[w] = bits;
    }
  }
  if (tid == 0) {
    for (int i = 0; i <= kRing; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto seek = [&](int kt) {  // this CTA's first tile from kt on
    if (SPARSE)
      while (kt < n_k && ((sVis[kt >> 5] >> (kt & 31)) & 1u) == 0)
        kt += p.split;
    return kt;
  };
  const int first = seek(c.rank);

  // thread 0 keeps the ring kRing items ahead of the math: item (pt, pi)
  int pt = first, pi = 0, issued = 0;
  auto issue = [&]() {
    const int slot = issued % kRing;
    unsigned char* dst = ring + slot * kBox;
    uint64_t* bar = &bars[slot];
    const int k0 = pt * kTile;
    if (pi < n_s) {
      int cc = pi;
      bool q_box = false;
      if (pi >= kQBoxes) {
        cc = kQBoxes + (pi - kQBoxes) / 2;
        q_box = ((pi - kQBoxes) & 1) == 0;
      }
      hopper::mbar_expect_tx(bar, kBox);
      hopper::tma_load(dst, q_box ? &p.tq : &p.tk, bar, cc * kTile,
                       q_box ? q0 : k0, c.h, c.b);
    } else if (pi < n_s + n_b) {
      hopper::mbar_expect_tx(bar, p.bias_mode == 2 ? kBox : 128);
      hopper::tma_load(dst, &p.tb, bar, k0, p.bias_mode == 2 ? q0 : 0,
                       p.bias_h ? 0 : c.h, p.bias_b ? 0 : c.b);
    } else {
      hopper::mbar_expect_tx(bar, kBox);
      hopper::tma_load(dst, &p.tv, bar, (ob0 + pi - n_s - n_b) * kTile, k0,
                       c.h, c.b);
    }
    ++issued;
    if (++pi == n_it) {
      pi = 0;
      pt = seek(pt + p.split);
    }
  };
  // thread 0: the items after `released`, the items every warp is done
  // with, into the slots they free; called just after a product is
  // started, so the copies are issued while the tensor cores work
  int released = 0;
  auto refill = [&]() {
    if (tid == 0)
      while (pt < n_k && issued < released + kRing) issue();
  };

  if (tid == 0 && first < n_k) {
    hopper::mbar_expect_tx(&bars[kRing], nqb * kBox);
    for (int cc = 0; cc < nqb; ++cc)
      hopper::tma_load(sQ + cc * kBox, &p.tq, &bars[kRing], cc * kTile, q0,
                       c.h, c.b);
  }
  refill();
  uint32_t key0 = 0, key1 = 0;
  if (p.drop.on) {
    const unsigned long long sd =
        static_cast<unsigned long long>(*p.drop.seed);
    key0 = static_cast<uint32_t>(sd);
    key1 = static_cast<uint32_t>(sd >> 32);
  }
  int st[2] = {0, 0}, en[2] = {0, 0};
  if (SPARSE) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      unpack_se(p.se[(long long)c.b * p.Tq + q0 + r0 + 8 * hh], st[hh],
                en[hh]);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kChunkBlocks][32], s[32], part[32];
#pragma unroll
  for (int j = 0; j < kChunkBlocks; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = part[i] = 0.f;
  if (first < n_k) hopper::mbar_wait(&bars[kRing], 0);

  int n = 0;  // the next item to consume
  auto slot_of = [&](int i) {
    hopper::mbar_wait(&bars[i % kRing], (i / kRing) & 1);
    return ring + (i % kRing) * kBox;
  };
  for (int kt = first; kt < n_k; kt = seek(kt + p.split)) {
    const int k0 = kt * kTile;
    // S = Q·Kᵀ one 64-wide head-dim slice at a time: each slice's four k
    // steps into a zeroed partial, added to S in slice order (the tensor
    // core's sums round toward zero; the backward sums S alike)
    for (int cc = 0; cc < nblk; ++cc) {
      const unsigned char* qb = sQ + cc * kBox;
      if (cc >= kQBoxes) qb = slot_of(n++);
      const unsigned char* kb = slot_of(n++);
      hopper::pin(part);
      hopper::wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::mma_ss<64, 0>(part, hopper::desc_kmajor(qb, ks),
                              hopper::desc_kmajor(kb, ks), ks > 0);
      hopper::wg_commit();
      refill();
      hopper::wg_wait_all();
      hopper::pin(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = cc == 0 ? part[i] : s[i] + part[i];
      __syncthreads();  // every warp is done with the slice's boxes
      released = n;
    }
    refill();  // the bias and V boxes, before the softmax needs them

    // scale, bias and masks (selects, no branch); bit i of `ok` = element i
    // is visible (sparse)
    uint32_t ok = ~0u;
    float mx[2] = {kNegInf, kNegInf};
    if (SPARSE) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const bool v = (key >= st[hh]) & (key < en[hh]) &
                       (!p.causal | (key <= q0 + r0 + 8 * hh));
        ok = v ? ok : ok & ~(1u << i);
        s[i] = v ? s[i] * p.sm_scale : kNegInf;
        mx[hh] = fmaxf(mx[hh], s[i]);
      }
    } else {
      float bv[32];
      if (n_b) {
        hopper::bias_rows(bv, slot_of(n), p.bias_mode, r0, t);
        ++n;
      } else {
        hopper::bias_rows(bv, nullptr, 0, r0, t);
      }
      const int k_left = p.Tk - k0;  // keys of this tile inside Tk
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, col = (i >> 2) * 8 + 2 * t + (i & 1);
        float x = fmaf(s[i], p.sm_scale, bv[i]);
        x = p.causal && k0 + col > q0 + r0 + 8 * hh ? kNegInf : x;
        s[i] = col < k_left ? x : -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[i]);
      }
    }

    // online softmax over the 4 lanes that share a row; a max that does
    // not move rescales by exactly 1, so a tile with no visible pair
    // changes no bit
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = m_new == m[hh]
                     ? 1.f : hopper::ex2((m[hh] - m_new) * hopper::kLog2e);
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
          key0, key1, p.drop, c.bh, q0 + r0, k0, t);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = (keep >> i) & 1u ? s[i] * p.drop.scale : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i >> 1) & 1];

    // O += P·V over the chunk's blocks: P (rounded to bf16) from
    // registers, V's boxes MN-major as TMA wrote them
    uint32_t a[4][4];
    hopper::acc_to_a(a, s);
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) hopper::pin(o[j]);
    hopper::pin(a);
    hopper::wg_fence();
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) {
      if (j < nob) {
        const unsigned char* vb = slot_of(n++);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::mma_rs<64, 1>(o[j], a[kk], hopper::desc_mnmajor(vb, kk),
                                1);
      }
    }
    hopper::wg_commit();
    hopper::wg_wait_all();
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) hopper::pin(o[j]);
    __syncthreads();  // every warp is done with the tile's bias and V
    released = n;
    refill();  // the next tile's first boxes
  }

  bf* out = p.out + c.b * p.o_sb + c.h * p.o_sh;
  if (p.split == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      if (row >= p.Tq) continue;
      const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
      const float inv = 1.f / l_safe;
      bf* orow = out + row * p.o_st + ob0 * kTile + 2 * t;
#pragma unroll
      for (int j = 0; j < kChunkBlocks; ++j) {
        if (j >= nob) continue;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * kTile + nb * 8) =
              __floats2bfloat162_rn(o[j][4 * nb + 2 * hh] * inv,
                                    o[j][4 * nb + 2 * hh + 1] * inv);
      }
      if (t == 0 && c.oc == 0)
        p.lse[(long long)c.bh * p.Tq + row] = m[hh] + logf(l_safe);
    }
    return;
  }

  // The cluster's two CTAs combine their walks: each puts its m, l and O
  // (in fragment order, 16 bytes a thread and register group) into its own
  // shared memory, O where Q was; after a cluster barrier, the CTA of rank
  // r finishes output blocks j ≡ r (mod 2), reading both ranks' parts over
  // distributed shared memory. Both sum the ranks in rank order, so l and
  // the lse are the same in each.
  float* sO = reinterpret_cast<float*>(sQ);
#pragma unroll
  for (int j = 0; j < kChunkBlocks; ++j) {
    if (j >= nob) continue;
#pragma unroll
    for (int i4 = 0; i4 < 8; ++i4)
      *reinterpret_cast<float4*>(sO + ((j * 8 + i4) * kThreads + tid) * 4) =
          make_float4(o[j][4 * i4], o[j][4 * i4 + 1], o[j][4 * i4 + 2],
                      o[j][4 * i4 + 3]);
  }
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sRows[r0 + 8 * hh] = m[hh];
      sRows[kTile + r0 + 8 * hh] = l[hh];
    }
  }
  hopper::cluster_sync();

  // every thread reads both ranks' values of its own registers' rows and
  // columns; rank 0's part is added first
  const uint32_t rows0 = hopper::map_rank(sRows, 0);
  const uint32_t rows1 = hopper::map_rank(sRows, 1);
  float e[2][2], l_safe[2];  // [rank][row half]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    const float m0 = hopper::ld_cluster(rows0 + 4 * r);
    const float m1 = hopper::ld_cluster(rows1 + 4 * r);
    const float m_all = fmaxf(m0, m1);
    e[0][hh] = m0 == m_all ? 1.f : hopper::ex2((m0 - m_all) * hopper::kLog2e);
    e[1][hh] = m1 == m_all ? 1.f : hopper::ex2((m1 - m_all) * hopper::kLog2e);
    const float lsum =
        hopper::ld_cluster(rows0 + 4 * (kTile + r)) * e[0][hh] +
        hopper::ld_cluster(rows1 + 4 * (kTile + r)) * e[1][hh];
    l_safe[hh] = lsum == 0.f ? 1.f : lsum;
    if (t == 0 && c.rank == 0 && c.oc == 0 && q0 + r < p.Tq)
      p.lse[(long long)c.bh * p.Tq + q0 + r] = m_all + logf(l_safe[hh]);
  }
  const uint32_t o0 = hopper::map_rank(sO, 0), o1 = hopper::map_rank(sO, 1);
  for (int j = c.rank; j < nob; j += 2) {
    bf* ocol = out + (ob0 + j) * kTile + 2 * t;
#pragma unroll 2
    for (int i4 = 0; i4 < 8; ++i4) {
      const uint32_t at = ((j * 8 + i4) * kThreads + tid) * 16;
      const float4 x = hopper::ld_cluster4(o0 + at);
      const float4 y = hopper::ld_cluster4(o1 + at);
      // registers 4·i4 + 2·hh + {0, 1}: row r0 + 8·hh, columns 8·i4 + 2t
      const int row = q0 + r0;
      if (row < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ocol + row * p.o_st + i4 * 8) =
            __floats2bfloat162_rn(
                (x.x * e[0][0] + y.x * e[1][0]) / l_safe[0],
                (x.y * e[0][0] + y.y * e[1][0]) / l_safe[0]);
      if (row + 8 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ocol + (row + 8) * p.o_st +
                                           i4 * 8) =
            __floats2bfloat162_rn(
                (x.z * e[0][1] + y.z * e[1][1]) / l_safe[1],
                (x.w * e[0][1] + y.w * e[1][1]) / l_safe[1]);
    }
  }
  hopper::cluster_sync();  // no CTA leaves while another reads its memory
}

long long ctas(int B, int H, int Tq, int Tk, int D) {
  const long long n = cells(B, H, Tq, D);
  return n * split_of(n, (Tk + kTile - 1) / kTile, f32w::sm_count());
}

template <bool SPARSE>
cudaError_t run(Params& p, cudaStream_t s) {
  const long long n = cells(p.B, p.H, p.Tq, p.D);
  p.nch = chunks(p.D);
  p.split = split_of(n, (p.Tk + kTile - 1) / kTile, f32w::sm_count());
  if (n * p.split > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  auto kernel = wide_fwd_bf16_kernel<SPARSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * p.split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace bfw

// ---------------------------------------------------------------------------
// bf16 backward: one launch of three roles, dk, dq and dv, each CTA one
// warpgroup on wgmma over a chunk of up to four 64-wide output blocks, every
// operand a 64x64 box that TMA writes into a ring (the design in the
// header).
// ---------------------------------------------------------------------------
namespace bwb {

constexpr int kThreads = 128;     // one warpgroup
constexpr int kBox = hopper::kBoxBytes;
constexpr int kSlot = 2 * kBox;   // a ring item: up to two boxes
constexpr int kRing = 4;          // ring slots
constexpr int kChunkBlocks = 4;   // output blocks (64 columns) a CTA holds
// A tile's head: the bias box (or the mask's row) at 0, then its lse,
// delta and se rows (dk and dv: one value a query of the tile).
constexpr int kHeadRows = kBox;
constexpr int kHead = kBox + 1024;
constexpr int kStashOff = kRing * kSlot;           // P: 64x64 f32
constexpr int kHeadOff = kStashOff + 64 * 64 * 4;  // two heads, by tile parity
constexpr int kBarOff = kHeadOff + 2 * kHead;      // kRing slot barriers
constexpr int kVisOff = kBarOff + 64;              // sparse: tile bits
constexpr int kSmem = kVisOff + 128 + 1024;        // + the swizzle's align

enum Role { kDk, kDq, kDv };

struct Params {
  CUtensorMap tq, tk, tv, tg;  // [B, H, T, D]: boxes of 64 rows x 64 values
  CUtensorMap tb;              // bias [Bb, Hb, Qb, Tk]: 1 or 64 rows x 64 keys
  CUtensorMap tlse, tdelta;    // [1, 1, B*H, Tq] f32: boxes of 64 values
  CUtensorMap tse;             // sparse: [1, 1, B, Tq] int32: boxes of 64
  const float* lse;            // rows lse_pitch floats apart
  const float* delta;          // rows delta_pitch floats apart
  const int* se;               // sparse: rows se_pitch ints apart
  const int* vis;              // sparse: [B, Tq / 64, Tk / 64]
  long long lse_pitch, delta_pitch, se_pitch;
  bf* dq;
  bf* dk;
  bf* dv;
  float* dbias;                // per query [B*H, Tq, Tk] or nullptr
  float* dbias_col;            // column sum [B*H, Tk] or nullptr
  int B, H, Tq, Tk, D;
  long long dq_s[3], dk_s[3], dv_s[3];  // (batch, head, token) strides
  int bias_mode;               // 0 none, 1 a row for all queries, 2 per query
  int bias_b, bias_h;          // 1 = the bias is broadcast over batch / heads
  float sm_scale;
  int causal;
  flash::Dropout drop;
  int nch;                     // output chunks (bfw::chunks)
  long long n_dk, n_dq;        // CTAs of the dk and dq roles; dv's follow
};

// (64-row tiles of T) x B·H
inline long long cells(int B, int H, int T) {
  return (long long)((T + kTile - 1) / kTile) * B * H;
}

// One CTA of role ROLE, numbered `cta` in its role's flat grid (chunk
// fastest, then the row tile, then b·h): rows [row0, row0 + 64) of one
// (b, h) (queries for dq, keys for dk and dv) and the output blocks [ob0,
// ob0 + nob) of its chunk, walking the column tiles it sees. A tile is a
// run of ring items: per head-dim slice c the S operands (X_c, Y_c), then
// (dq, dk) per slice the dP operands, then the output product's boxes, two
// an item; the tile's head arrives with its first item.
template <int ROLE, bool SPARSE>
__device__ __forceinline__ void role_cta(const Params& p, long long cta) {
  constexpr bool kQRows = ROLE == kDq;  // rows are queries
  constexpr bool kDp = ROLE != kDv;     // dP is formed
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* ring = smem;
  float4* stash = reinterpret_cast<float4*>(smem + kStashOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint32_t* sVis = reinterpret_cast<uint32_t*>(smem + kVisOff);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;
  const int n_rows = kQRows ? p.Tq : p.Tk, n_cols = kQRows ? p.Tk : p.Tq;
  const int nrt = (n_rows + kTile - 1) / kTile;
  const int nct = (n_cols + kTile - 1) / kTile;
  const int oc = static_cast<int>(cta % p.nch);
  const long long cell = cta / p.nch;
  const int tile = static_cast<int>(cell % nrt);
  const int bh = static_cast<int>(cell / nrt), b = bh / p.H, h = bh % p.H;
  const int row0 = tile * kTile;
  const int nblk = p.D / kTile, bpc = (nblk + p.nch - 1) / p.nch;
  const int ob0 = oc * bpc, nob = min(bpc, nblk - ob0);
  const int n_s = nblk, n_p = kDp ? nblk : 0, n_o = (nob + 1) / 2;
  const int n_it = n_s + n_p + n_o;  // ring items a tile

  // S = X·Yᵀ, dP = Xp·Ypᵀ (rows the CTA's, columns the tile's), then out +=
  // A·Z over the chunk's blocks (Z's rows the tile's)
  const CUtensorMap* mx = kQRows ? &p.tq : &p.tk;
  const CUtensorMap* my = kQRows ? &p.tk : &p.tq;
  const CUtensorMap* mxp = kQRows ? &p.tg : &p.tv;
  const CUtensorMap* myp = kQRows ? &p.tv : &p.tg;
  const CUtensorMap* mz = ROLE == kDq ? &p.tk : ROLE == kDk ? &p.tq : &p.tg;

  // the column tiles [ct_begin, ct_end) this CTA may visit
  int ct_begin = 0, ct_end = nct;
  if (!SPARSE && p.causal) {
    if (kQRows)
      ct_end = min(nct, (min(row0 + kTile, p.Tq) - 1) / kTile + 1);
    else
      ct_begin = min(tile, nct);  // q tiles from the diagonal
  }
  if (SPARSE) {  // this tile's row (dq) or column (dk, dv) of vis as bits
    for (int w = warp; w * 32 < nct; w += kThreads / 32) {
      const int ct = w * 32 + lane;
      bool on = false;
      if (ct < nct)
        on = __ldg(kQRows ? p.vis + ((long long)b * nrt + tile) * nct + ct
                          : p.vis + ((long long)b * nct + ct) * nrt + tile)
             != 0;
      const uint32_t bits = __ballot_sync(0xffffffffu, on);
      if (lane == 0) sVis[w] = bits;
    }
  }
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto seek = [&](int ct) {  // the first tile from ct on that the walk takes
    if (SPARSE)
      while (ct < ct_end && ((sVis[ct >> 5] >> (ct & 31)) & 1u) == 0) ++ct;
    return ct;
  };
  const int first = seek(ct_begin);
  const int bias_mode = SPARSE ? 0 : p.bias_mode;
  const int head_bytes =
      (bias_mode == 2 ? kBox : bias_mode == 1 ? 128 : 0) +
      (kQRows ? 0 : SPARSE ? 768 : 512);

  // thread 0 keeps the ring kRing items ahead of the math: item (pt, pi) of
  // the pn-th tile of the walk; a tile's first item also brings its head
  // into buffer pn & 1, once every warp is past the first item of the tile
  // before (so done with the tile before that, which used the buffer)
  int pt = first, pi = 0, pn = 0, issued = 0, last_start = -1;
  int released = 0;
  auto issue = [&]() {
    const int slot = issued % kRing;
    unsigned char* dst = ring + slot * kSlot;
    uint64_t* bar = &bars[slot];
    const int c0 = pt * kTile;
    if (pi < n_s + n_p) {
      const bool dp = pi >= n_s;
      const int cc = dp ? pi - n_s : pi;
      hopper::mbar_expect_tx(bar, 2 * kBox + (pi == 0 ? head_bytes : 0));
      hopper::tma_load(dst, dp ? mxp : mx, bar, cc * kTile, row0, h, b);
      hopper::tma_load(dst + kBox, dp ? myp : my, bar, cc * kTile, c0, h, b);
      if (pi == 0) {
        unsigned char* head = smem + kHeadOff + (pn & 1) * kHead;
        if (bias_mode != 0) {
          const int kc = kQRows ? c0 : row0, qr = kQRows ? row0 : c0;
          hopper::tma_load(head, &p.tb, bar, kc, bias_mode == 2 ? qr : 0,
                           p.bias_h ? 0 : h, p.bias_b ? 0 : b);
        }
        if (!kQRows) {
          hopper::tma_load(head + kHeadRows, &p.tlse, bar, c0, bh, 0, 0);
          hopper::tma_load(head + kHeadRows + 256, &p.tdelta, bar, c0, bh, 0,
                           0);
          if (SPARSE)
            hopper::tma_load(head + kHeadRows + 512, &p.tse, bar, c0, b, 0,
                             0);
        }
        last_start = issued;
      }
    } else {
      const int j = 2 * (pi - n_s - n_p), nb = min(2, nob - j);
      hopper::mbar_expect_tx(bar, nb * kBox);
      for (int i = 0; i < nb; ++i)
        hopper::tma_load(dst + i * kBox, mz, bar, (ob0 + j + i) * kTile, c0,
                         h, b);
    }
    ++issued;
    if (++pi == n_it) {
      pi = 0;
      ++pn;
      pt = seek(pt + 1);
    }
  };
  // thread 0: the items after those every warp is done with, into the slots
  // they free; called just after a product is started, so the copies are
  // issued while the tensor cores work
  auto refill = [&]() {
    if (tid == 0)
      while (pt < ct_end && issued < released + kRing &&
             (pi != 0 || released > last_start))
        issue();
  };
  refill();

  uint32_t key0 = 0, key1 = 0;
  if (p.drop.on) {
    const unsigned long long sd =
        static_cast<unsigned long long>(*p.drop.seed);
    key0 = static_cast<uint32_t>(sd);
    key1 = static_cast<uint32_t>(sd >> 32);
  }
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;
  // dq: the lse, delta and se of its own rows
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  int st_r[2] = {0, 0}, en_r[2] = {0, 0};
  if (kQRows) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + r0 + 8 * hh;
      if (row < p.Tq) {
        lse_r[hh] = p.lse[bh * p.lse_pitch + row];
        delta_r[hh] = p.delta[bh * p.delta_pitch + row];
        if (SPARSE) unpack_se(p.se[b * p.se_pitch + row], st_r[hh], en_r[hh]);
      }
    }
  }
  float o[kChunkBlocks][32], s[32], part[32];
#pragma unroll
  for (int j = 0; j < kChunkBlocks; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = part[i] = 0.f;
  float dbc[2] = {0.f, 0.f};  // dk: column sums of ds for its two keys

  int n = 0;  // the next item to consume
  auto slot_of = [&](int i) {
    hopper::mbar_wait(&bars[i % kRing], (i / kRing) & 1);
    return ring + (i % kRing) * kSlot;
  };
  // acc = X·Yᵀ over the head dim, one 64-wide slice an item: each slice's
  // four k steps into a zeroed partial, added in slice order (the tensor
  // core's sums round toward zero; the forward sums S alike)
  auto scores = [&](float (&acc)[32]) {
    for (int cc = 0; cc < nblk; ++cc) {
      const unsigned char* sl = slot_of(n++);
      hopper::pin(part);
      hopper::wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::mma_ss<64, 0>(part, hopper::desc_kmajor(sl, ks),
                              hopper::desc_kmajor(sl + kBox, ks), ks > 0);
      hopper::wg_commit();
      refill();
      hopper::wg_wait_all();
      hopper::pin(part);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = cc == 0 ? part[i] : acc[i] + part[i];
      __syncthreads();  // every warp is done with the slice's boxes
      released = n;
    }
    refill();
  };
  // out += A·Z over the chunk's blocks: A (rounded to bf16) from registers,
  // Z's boxes MN-major as TMA wrote them
  auto output = [&](const float (&a_acc)[32]) {
    uint32_t a[4][4];
    hopper::acc_to_a(a, a_acc);
    const unsigned char* zs[kChunkBlocks / 2];
#pragma unroll
    for (int i = 0; i < kChunkBlocks / 2; ++i)
      zs[i] = i < n_o ? slot_of(n + i) : nullptr;
    n += n_o;
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) hopper::pin(o[j]);
    hopper::pin(a);
    hopper::wg_fence();
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) {
      if (j < nob) {
        const unsigned char* zb = zs[j / 2] + (j % 2) * kBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::mma_rs<64, 1>(o[j], a[kk], hopper::desc_mnmajor(zb, kk), 1);
      }
    }
    hopper::wg_commit();
    refill();
    hopper::wg_wait_all();
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) hopper::pin(o[j]);
    __syncthreads();  // every warp is done with the tile's boxes
    released = n;
    refill();  // the next tile's first items
  };

  int jt = 0;  // the walk's tiles so far
  for (int ct = first; ct < ct_end; ct = seek(ct + 1), ++jt) {
    const int c0 = ct * kTile;
    const unsigned char* head = smem + kHeadOff + (jt & 1) * kHead;
    const float* h_lse = reinterpret_cast<const float*>(head + kHeadRows);
    const float* h_delta = h_lse + 64;
    const int* h_se = reinterpret_cast<const int*>(h_lse + 128);
    scores(s);  // S (dq), Sᵀ = K·Qᵀ (dk, dv); the head has landed

    // p = exp(s − lse) where visible, else exactly 0 (selects, no branch);
    // bit i of `ok` = element i is visible
    uint32_t ok = 0;
    if constexpr (kQRows) {
      float bv[32];
      hopper::bias_rows(bv, head, bias_mode, r0, t);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, row = row0 + r0 + 8 * hh;
        const int key = c0 + (i >> 2) * 8 + 2 * t + (i & 1);
        bool v;
        float x;
        if (SPARSE) {
          v = (key >= st_r[hh]) & (key < en_r[hh]) &
              (!p.causal | (key <= row));
          x = s[i] * p.sm_scale;
        } else {
          v = (row < p.Tq) & (key < p.Tk);
          x = fmaf(s[i], p.sm_scale, bv[i]);
          x = p.causal && key > row ? kNegInf : x;
        }
        const float e = hopper::ex2((x - lse_r[hh]) * hopper::kLog2e);
        s[i] = v ? e : 0.f;
        ok |= v ? 1u << i : 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, cq = (i >> 2) * 8 + 2 * t + (i & 1);
        const int key = row0 + r0 + 8 * hh, qq = c0 + cq;
        bool v;
        float x;
        if (SPARSE) {
          int start, end;
          unpack_se(h_se[cq], start, end);
          v = (key >= start) & (key < end) & (!p.causal | (key <= qq));
          x = s[i] * p.sm_scale;
        } else {
          v = (qq < p.Tq) & (key < p.Tk);
          const float bias =
              bias_mode == 0 ? 0.f
              : __bfloat162float(*reinterpret_cast<const bf*>(
                    head + hopper::swz(bias_mode == 2 ? cq : 0,
                                       r0 + 8 * hh)));
          x = fmaf(s[i], p.sm_scale, bias);
          x = p.causal && key > qq ? kNegInf : x;
        }
        const float e = hopper::ex2((x - h_lse[cq]) * hopper::kLog2e);
        s[i] = v ? e : 0.f;
        ok |= v ? 1u << i : 0u;
      }
    }
    // keep bits of the lane's 32 elements
    uint32_t keep = ~0u;
    if (p.drop.on)
      keep = kQRows ? flash::keep_bits_rows(key0, key1, p.drop, bh,
                                            row0 + r0, c0, t)
                    : flash::keep_bits_cols(key0, key1, p.drop, bh,
                                            row0 + r0, c0, lane);

    if constexpr (ROLE == kDv) {
      // dV += P_dropᵀ·dO
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = (keep >> i) & 1u ? s[i] * drop_scale : 0.f;
      output(s);
    } else {
      // p waits in shared memory (each thread its own 32 values) while dP
      // takes its registers
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4)
        stash[i4 * kThreads + tid] = make_float4(
            s[4 * i4], s[4 * i4 + 1], s[4 * i4 + 2], s[4 * i4 + 3]);
      scores(s);  // dP (dq), dPᵀ = V·dOᵀ (dk)
      // ds = p·(dp_drop − delta) in place of dp
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4) {
        const float4 pr = stash[i4 * kThreads + tid];
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * i4 + e, hh = (i >> 1) & 1;
          const float dpv = (keep >> i) & 1u ? s[i] * drop_scale : 0.f;
          const float delta =
              kQRows ? delta_r[hh] : h_delta[(i >> 2) * 8 + 2 * t + (i & 1)];
          s[i] = pv[e] * (dpv - delta);
        }
      }
      if constexpr (ROLE == kDq) {
        // the per-query dbias is ds itself, written by chunk 0
        if (!SPARSE && p.dbias != nullptr && oc == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = row0 + r0 + 8 * ((i >> 1) & 1);
            const int key = c0 + (i >> 2) * 8 + 2 * t + (i & 1);
            if ((ok >> i) & 1u)
              p.dbias[((long long)bh * p.Tq + row) * p.Tk + key] = s[i];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) dbc[(i >> 1) & 1] += s[i];
      }
      output(s);  // dQ += dS·K; dK += dSᵀ·Q
    }
  }

  // the chunk's output blocks: rows past the tensor's end are not stored
  bf* dst = ROLE == kDq ? p.dq : ROLE == kDk ? p.dk : p.dv;
  const long long* st = ROLE == kDq ? p.dq_s : ROLE == kDk ? p.dk_s : p.dv_s;
  const float scale = ROLE == kDv ? 1.f : p.sm_scale;
  dst += b * st[0] + h * st[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + r0 + 8 * hh;
    if (row >= n_rows) continue;
    bf* orow = dst + row * st[2] + ob0 * kTile + 2 * t;
#pragma unroll
    for (int j = 0; j < kChunkBlocks; ++j) {
      if (j >= nob) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * kTile + nb * 8) =
            __floats2bfloat162_rn(o[j][4 * nb + 2 * hh] * scale,
                                  o[j][4 * nb + 2 * hh + 1] * scale);
    }
  }
  if (ROLE == kDk && !SPARSE && p.dbias_col != nullptr && oc == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 1);
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 2);
      const int key = row0 + r0 + 8 * hh;
      if (t == 0 && key < p.Tk)
        p.dbias_col[(long long)bh * p.Tk + key] = dbc[hh];
    }
  }
}

// The dk CTAs, then the dq CTAs, then the dv CTAs (whose walks are about
// half as long) in one launch.
template <bool SPARSE>
__global__ void __launch_bounds__(kThreads, 2)
wide_bwd_bf16_kernel(const __grid_constant__ Params p) {
  const long long x = blockIdx.x;
  if (x < p.n_dk)
    role_cta<kDk, SPARSE>(p, x);
  else if (x < p.n_dk + p.n_dq)
    role_cta<kDq, SPARSE>(p, x - p.n_dk);
  else
    role_cta<kDv, SPARSE>(p, x - p.n_dk - p.n_dq);
}

long long ctas(int B, int H, int Tq, int Tk, int D) {
  return (2 * cells(B, H, Tk) + cells(B, H, Tq)) * bfw::chunks(D);
}

template <bool SPARSE>
cudaError_t run(Params& p, cudaStream_t s) {
  p.nch = bfw::chunks(p.D);
  p.n_dk = cells(p.B, p.H, p.Tk) * p.nch;
  p.n_dq = cells(p.B, p.H, p.Tq) * p.nch;
  return launch(wide_bwd_bf16_kernel<SPARSE>, 2 * p.n_dk + p.n_dq, kThreads,
                kSmem, s, p);
}

}  // namespace bwb

void copy3(long long (&dst)[3], const long long* src) {
  for (int i = 0; i < 3; ++i) dst[i] = src[i];
}

void set_dropout(WideParams& p, const long long* seed, unsigned threshold,
                 float drop_scale, int dropout, const int* drop_offsets) {
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
  flash::set_offsets(p.drop, p.H, drop_offsets);
}

// D a multiple of 64, dtype 0 = f32 or 1 = bf16; sparse needs Tq, Tk
// multiples of 64 and the tables.
bool args_ok(const WideParams& p, int dtype, int sparse) {
  if (p.D <= 0 || p.D % kTile || (dtype != 0 && dtype != 1)) return false;
  if (sparse && (p.Tq % kTile || p.Tk % kTile || p.se == nullptr ||
                 p.vis == nullptr))
    return false;
  return p.B > 0 && p.H > 0 && p.Tq > 0 && p.Tk > 0;
}

}  // namespace

extern "C" {

// float32 forward. strides: q, k, v, out (batch, head, token) in elements,
// then the bias's (batch, head, q, k); the head dim is contiguous and every
// row 16-byte aligned. sparse = 0: the dense mask (bias may be null;
// causal); sparse = 1: se [B, Tq] and vis [B, Tq/64, Tk/64] (no bias). lse
// is [B*H, Tq] f32. With dropout != 0, `seed` points at one int64 on the
// device and a score is dropped iff its Philox word < `threshold`; kept p is
// scaled by `drop_scale`. Returns a cudaError_t (0 = launched).
int flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                             const void* bias, const int* se, const int* vis,
                             void* out, float* lse, int B, int H, int Tq,
                             int Tk, int D, const long long* strides,
                             float sm_scale, int causal, int sparse,
                             const long long* seed, unsigned threshold,
                             float drop_scale, int dropout, const int* drop_offsets, void* stream) {
  WideParams p = {};
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.se = se; p.vis = vis;
  p.out = out; p.lse_out = lse;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  copy3(p.q_s, strides); copy3(p.k_s, strides + 3); copy3(p.v_s, strides + 6);
  copy3(p.o_s, strides + 9);
  for (int i = 0; i < 4; ++i) p.b_s[i] = strides[12 + i];
  p.sm_scale = sm_scale;
  p.causal = causal;
  set_dropout(p, seed, threshold, drop_scale, dropout, drop_offsets);
  if (!args_ok(p, 0, sparse)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(sparse ? f32w::run_fwd<true>(p, s)
                      : f32w::run_fwd<false>(p, s));
}

// bfloat16 forward. `tensors` holds the tensor descriptions (hopper::
// kDescLen int64 each) of q, k, v and the bias (ignored when bias_mode is
// 0) in that order; out strides are in elements. sparse = 0: the dense
// mask, bias_mode 0 none, 1 one row for every query, 2 a row per query
// (causal); sparse = 1: se [B, Tq] and vis [B, Tq/64, Tk/64] (bias_mode
// 0). lse and dropout as in flash_attention_wide_fwd. Returns a
// cudaError_t.
int flash_attention_wide_fwd_bf16(const long long* tensors, const int* se,
                                  const int* vis, void* out, float* lse,
                                  int B, int H, int Tq, int Tk, int D,
                                  long long o_sb, long long o_sh,
                                  long long o_st, int bias_mode,
                                  float sm_scale, int causal, int sparse,
                                  const long long* seed, unsigned threshold,
                                  float drop_scale, int dropout, const int* drop_offsets,
                                  void* stream) {
  WideParams w = {};
  w.se = se; w.vis = vis; w.B = B; w.H = H; w.Tq = Tq; w.Tk = Tk; w.D = D;
  if (!args_ok(w, 1, sparse) || bias_mode < 0 || bias_mode > 2 ||
      (sparse && bias_mode != 0))
    return (int)cudaErrorInvalidValue;
  bfw::Params p;
  const long long* bias = tensors + 3 * hopper::kDescLen;
  cudaError_t err;
  for (int i = 0; i < 3; ++i) {
    CUtensorMap* map = i == 0 ? &p.tq : i == 1 ? &p.tk : &p.tv;
    err = hopper::make_map(map, tensors + i * hopper::kDescLen, true, 64, 64);
    if (err != cudaSuccess) return (int)err;
  }
  if (bias_mode != 0 &&
      (err = hopper::make_map(&p.tb, bias, true, 64,
                              bias_mode == 2 ? 64 : 1)) != cudaSuccess)
    return (int)err;
  p.se = se; p.vis = vis;
  p.out = static_cast<bf*>(out);
  p.lse = lse;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
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
  return (int)(sparse ? bfw::run<true>(p, s) : bfw::run<false>(p, s));
}

// float32 backward on `stream`: a launch each of the dk, dq and dv CTAs,
// or one launch of all three on smaller grids (f32w::run_bwd). strides: q,
// k, v, dO, dq, dk, dv (batch, head, token) in elements, then the bias's
// four. lse and delta rows are lse_pitch / delta_pitch floats apart (delta
// from the dense backward's delta kernel). dbias (per query, [B*H, Tq, Tk]
// f32, zeroed by the caller where a causal walk skips) and dbias_col
// ([B*H, Tk] f32) may be null; dense only. Masks and dropout as in
// flash_attention_wide_fwd. Returns a cudaError_t.
int flash_attention_wide_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             long long lse_pitch, const float* delta,
                             long long delta_pitch, const void* bias,
                             const int* se, const int* vis, void* dq,
                             void* dk, void* dv, float* dbias,
                             float* dbias_col, int B, int H, int Tq, int Tk,
                             int D, const long long* strides, float sm_scale,
                             int causal, int sparse, const long long* seed,
                             unsigned threshold, float drop_scale,
                             int dropout, const int* drop_offsets, void* stream) {
  WideParams p = {};
  p.q = q; p.k = k; p.v = v; p.g = dout; p.bias = bias; p.se = se;
  p.vis = vis; p.lse = lse; p.lse_pitch = lse_pitch; p.delta = delta;
  p.delta_pitch = delta_pitch; p.dq = dq; p.dk = dk; p.dv = dv;
  p.dbias = dbias; p.dbias_col = dbias_col;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  copy3(p.q_s, strides); copy3(p.k_s, strides + 3); copy3(p.v_s, strides + 6);
  copy3(p.g_s, strides + 9); copy3(p.dq_s, strides + 12);
  copy3(p.dk_s, strides + 15); copy3(p.dv_s, strides + 18);
  for (int i = 0; i < 4; ++i) p.b_s[i] = strides[21 + i];
  p.sm_scale = sm_scale;
  p.causal = causal;
  set_dropout(p, seed, threshold, drop_scale, dropout, drop_offsets);
  if (!args_ok(p, 0, sparse)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(sparse ? f32w::run_bwd<true>(p, s)
                      : f32w::run_bwd<false>(p, s));
}

// bfloat16 backward on `stream`: one launch of the dk, dq and dv CTAs.
// `tensors` holds the tensor descriptions (hopper::kDescLen int64 each) of
// q, k, v, dO ([B, H, T, D]), the bias (ignored when bias_mode is 0), lse
// and delta ([1, 1, B*H, Tq] f32, rows by their pitch; delta from the dense
// backward's delta kernel) and se ([1, 1, B, Tq] int32; ignored when sparse
// is 0) in that order; dq, dk, dv strides are in elements. sparse = 0: the
// dense mask, bias_mode as in flash_attention_wide_fwd_bf16, dbias and
// dbias_col as in flash_attention_wide_bwd; sparse = 1: se and vis [B,
// Tq/64, Tk/64] (bias_mode 0, no dbias). Dropout as in
// flash_attention_wide_fwd. Returns a cudaError_t.
int flash_attention_wide_bwd_bf16(
    const long long* tensors, const int* vis, void* dq, void* dk, void* dv,
    float* dbias, float* dbias_col, int B, int H, int Tq, int Tk, int D,
    long long dq_sb, long long dq_sh, long long dq_st, long long dk_sb,
    long long dk_sh, long long dk_st, long long dv_sb, long long dv_sh,
    long long dv_st, int bias_mode, float sm_scale, int causal, int sparse,
    const long long* seed, unsigned threshold, float drop_scale, int dropout, const int* drop_offsets,
    void* stream) {
  constexpr int n = hopper::kDescLen;
  const long long* bias = tensors + 4 * n;
  const long long* lse = tensors + 5 * n;
  const long long* delta = tensors + 6 * n;
  const long long* se = tensors + 7 * n;
  WideParams w = {};
  w.se = sparse ? reinterpret_cast<const int*>(se[0]) : nullptr;
  w.vis = vis; w.B = B; w.H = H; w.Tq = Tq; w.Tk = Tk; w.D = D;
  if (!args_ok(w, 1, sparse) || bias_mode < 0 || bias_mode > 2 ||
      (sparse && (bias_mode != 0 || dbias != nullptr ||
                  dbias_col != nullptr)))
    return (int)cudaErrorInvalidValue;
  bwb::Params p;
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
  // se's int32 values travel as 4-byte elements: TMA copies their bits
  if ((err = hopper::make_map(&p.tlse, lse, false, 64, 1)) != cudaSuccess ||
      (err = hopper::make_map(&p.tdelta, delta, false, 64, 1)) !=
          cudaSuccess ||
      (sparse && (err = hopper::make_map(&p.tse, se, false, 64, 1)) !=
                     cudaSuccess))
    return (int)err;
  p.lse = reinterpret_cast<const float*>(lse[0]);
  p.delta = reinterpret_cast<const float*>(delta[0]);
  p.se = w.se;
  p.vis = vis;
  p.lse_pitch = lse[5] / 4;  // the byte stride of the rows
  p.delta_pitch = delta[5] / 4;
  p.se_pitch = se[5] / 4;
  p.dq = static_cast<bf*>(dq);
  p.dk = static_cast<bf*>(dk);
  p.dv = static_cast<bf*>(dv);
  p.dbias = dbias;
  p.dbias_col = dbias_col;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.dq_s[0] = dq_sb; p.dq_s[1] = dq_sh; p.dq_s[2] = dq_st;
  p.dk_s[0] = dk_sb; p.dk_s[1] = dk_sh; p.dk_s[2] = dk_st;
  p.dv_s[0] = dv_sb; p.dv_s[1] = dv_sh; p.dv_s[2] = dv_st;
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
  return (int)(sparse ? bwb::run<true>(p, s) : bwb::run<false>(p, s));
}

// Dynamic shared memory of a CTA of the forward (bwd = 0) or the
// backward's kernels (bwd = 1), dtype 0 = f32 or 1 = bf16, the same at every
// head dim.
int flash_attention_wide_smem(int dtype, int bwd) {
  if (dtype == 0) return f32w::kSmemBytes;
  return bwd ? bwb::kSmem : bfw::kSmem;
}

// CTAs of the forward (bwd = 0) or of the backward's launches (bwd = 1) at
// a shape, on the current device; -1 for arguments the entries refuse.
long long flash_attention_wide_ctas(int bwd, int dtype, int B, int H, int Tq,
                                    int Tk, int D) {
  WideParams p = {};
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  if (!args_ok(p, dtype, 0)) return -1;
  if (dtype == 0) return bwd ? f32w::bwd_ctas(p) : f32w::fwd_ctas(p);
  return bwd ? bwb::ctas(B, H, Tq, Tk, D) : bfw::ctas(B, H, Tq, Tk, D);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
