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
//     zeroes the tiles a causal walk skips) or the column sum (by the dk/dv
//     CTAs, summed in a fixed order).
//   - delta comes from the dense backward's delta kernel, before the launch.
//   - no atomics: each output element is written by one CTA, so two calls
//     give the same bits. Grids are flat, so B·nh has no 65,535 cap.
//
// Bound. The work is 4·d flops a (query, key) pair forward and 10·d
// backward, so at d >= 320 the kernels are bound by operations, in f32
// three TF32 products per product on the tensor cores (3xTF32, 495
// TFLOP/s), in bf16 the tensor cores' 989 -- except the bf16 forward, whose
// bytes take a little longer than its operations (below).
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
// bf16 backward (wide_dq_kernel, wide_dkv_kernel), the first version: a CTA
// owns 64 queries (64 keys in dk/dv) and one 64-wide chunk of its output's
// head dim; the chunks are a grid factor. It forms the scores S = Q·Kᵀ (and
// dP = dO·Vᵀ) by walking the head dim in 64-wide slices through four
// [64][72] operand tiles in shared memory, taken in order, so the sums run
// in one order whatever d is; every chunk of a tile recomputes the same
// scores bit for bit, and loads only its chunk of K (dq) or of dO and Q
// (dk/dv) for the second product (about 42 KB of shared memory a CTA).
// Products: C[16 rows x 64] += A[16 x 64]·B[64 x 64]ᵀ with A and B
// row-major in shared memory, in the m16n8k16 accumulator layout (lane
// (g, t) of warp w holds rows 16w + g and 16w + g + 8, columns 8·nb + 2t
// and 8·nb + 2t + 1) on mma.sync.m16n8k16, bf16 in, f32 accumulate, each
// head-dim slice of S and dP summed into a partial that is added once
// (slice_product). The second operands of dS·K, Pᵀ·dO and dSᵀ·Q are stored
// transposed as they are loaded, and P or dS (rounded to bf16, as the TPU
// kernels round them) go through shared memory as the A operand. It
// recomputes the scores once per output chunk (d/64 times) and runs no copy
// ahead of the math. Times are in PERF.md.

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
constexpr int kThreads = 128;      // 4 warps of 16 rows

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

// Operand tiles: bf16 rows of 72 values (144 bytes, on the 16-byte grid):
// conflict-free for the fragment reads below.
template <typename T> struct Pitch;
template <> struct Pitch<bf> { static constexpr int kValue = kTile + 8; };

template <typename T>
__host__ __device__ constexpr int tile_elems() {
  return kTile * Pitch<T>::kValue;
}

// Dynamic shared memory: four operand tiles, the keep bytes of a 64x64 tile,
// and four rows of 64 per-query values (lse, delta, start, end).
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * tile_elems<T>() * (int)sizeof(T) + kTile * flash::kKeepPitch +
         4 * kTile * 4;
}

__device__ __forceinline__ float to_f(bf x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf from_f<bf>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [0, 64) x columns [0, 64) of a row-major T matrix (rows `st` apart,
// `rows` of them valid, the rest zero) into a tile; transposed (dst[c][r])
// when TRANS.
template <typename T, bool TRANS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int rows, int tid) {
  constexpr int kPer = 16 / sizeof(T), kVec = kTile / kPer;
  constexpr int P = Pitch<T>::kValue;
  for (int i = tid; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * kPer;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) x = *reinterpret_cast<const uint4*>(src + r * st + c);
    const T* xe = reinterpret_cast<const T*>(&x);
    if (TRANS) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[(c + e) * P + r] = xe[e];
    } else {
      *reinterpret_cast<uint4*>(dst + r * P + c) = x;
    }
  }
}

__device__ __forceinline__ uint32_t ld_u32(const bf* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// c[16 rows from r0 - g, 64 columns] += A[rows][0..64)·B[0..64)[0..64)ᵀ:
// lane (g, t) accumulates rows r0, r0 + 8 (r0 = 16·warp + g) and columns
// 8·nb + 2t + {0, 1}, over k in order.
__device__ __forceinline__ void product(float (&c)[8][4], const bf* A,
                                        const bf* B, int r0, int t) {
  constexpr int P = Pitch<bf>::kValue;
  const int g = r0 & 7;
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    const int col = ks * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(A + r0 * P + col),
                           ld_u32(A + (r0 + 8) * P + col),
                           ld_u32(A + r0 * P + col + 8),
                           ld_u32(A + (r0 + 8) * P + col + 8)};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const bf* brow = B + (nb * 8 + g) * P + col;
      mma_bf16_16816(c[nb], a, ld_u32(brow), ld_u32(brow + 8));
    }
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
}

// c += the product of one 64-wide head-dim slice (S, dP over the slices),
// summed into a partial first and added with one round-to-nearest FADD:
// the tensor core rounds its f32 sums toward zero, and at d = 512 a chain
// of 32 such k steps drifts further from the plain version's sums than
// the backward's tolerance allows (the per-query dbias).
__device__ __forceinline__ void slice_product(float (&c)[8][4], const bf* A,
                                              const bf* B, int r0, int t) {
  float part[8][4];
  zero(part);
  product(part, A, B, r0, t);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] += part[nb][e];
}

// Stores the thread's accumulator elements, rounded to T, into a tile:
// element (row, col) of the fragment at dst[row][col].
template <typename T>
__device__ __forceinline__ void store_frag(T* dst, const float (&c)[8][4],
                                           int r0, int t) {
  constexpr int P = Pitch<T>::kValue;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[(r0 + 8 * (e >> 1)) * P + nb * 8 + 2 * t + (e & 1)] =
          from_f<T>(c[nb][e]);
}

// Stores rows r0, r0 + 8 (of `rows` valid) of a 64-column output chunk,
// times `scale`, rounded to T.
template <typename T>
__device__ __forceinline__ void store_out(T* dst, long long st,
                                          const float (&c)[8][4], int r0,
                                          int t, int rows, float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= rows) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dst[r * st + nb * 8 + 2 * t + e] =
            from_f<T>(c[nb][2 * hh + e] * scale);
  }
}

__device__ __forceinline__ void unpack_se(int se, int& start, int& end) {
  start = static_cast<int>(static_cast<unsigned>(se) >> 16);
  end = se & 0xFFFF;
}

// A flat grid index as (chunk, tile, bh): the chunks of one tile are
// neighbours, so they read its operands while they are in L2.
struct Cell {
  int chunk, tile, bh, b, h;
};

__device__ __forceinline__ Cell cell_of(int ntiles, int nch, int H) {
  const long long x = blockIdx.x;
  Cell c;
  c.chunk = static_cast<int>(x % nch);
  c.tile = static_cast<int>((x / nch) % ntiles);
  c.bh = static_cast<int>(x / ((long long)nch * ntiles));
  c.b = c.bh / H;
  c.h = c.bh % H;
  return c;
}

__device__ __forceinline__ int ntiles(int T) { return (T + kTile - 1) / kTile; }

// Key tiles a dense causal q tile sees.
__device__ __forceinline__ int dense_k_tiles(const WideParams& p, int q0) {
  int n = ntiles(p.Tk);
  if (p.causal) n = min(n, (min(q0 + kTile, p.Tq) - 1) / kTile + 1);
  return n;
}

struct Smem {
  unsigned char* raw;
  template <typename T> __device__ __forceinline__ T* tile(int i) const {
    return reinterpret_cast<T*>(raw) + i * tile_elems<T>();
  }
  template <typename T> __device__ __forceinline__ uint8_t* keep() const {
    return raw + 4 * tile_elems<T>() * sizeof(T);
  }
  template <typename T> __device__ __forceinline__ float* rows(int i) const {
    return reinterpret_cast<float*>(keep<T>() + kTile * flash::kKeepPitch) +
           i * kTile;
  }
};

// ---------------------------------------------------------------------------
// dq: a CTA owns 64 queries and dq columns [64·chunk, +64).
// ---------------------------------------------------------------------------
template <typename T, bool SPARSE>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(WideParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm{smem_raw};
  T* sQ = sm.tile<T>(0);   // Q slice, then dS
  T* sK = sm.tile<T>(1);   // K slice, then Kᵀ chunk
  T* sG = sm.tile<T>(2);   // dO slice
  T* sV = sm.tile<T>(3);   // V slice
  uint8_t* sKeep = sm.keep<T>();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;
  const int nq = ntiles(p.Tq), nk = ntiles(p.Tk), nch = p.D / kTile;
  const Cell cell = cell_of(nq, nch, p.H);
  const int q0 = cell.tile * kTile, oc = cell.chunk * kTile, bh = cell.bh;
  const T* q = static_cast<const T*>(p.q) + cell.b * p.q_s[0] +
               cell.h * p.q_s[1] + q0 * p.q_s[2];
  const T* gg = static_cast<const T*>(p.g) + cell.b * p.g_s[0] +
                cell.h * p.g_s[1] + q0 * p.g_s[2];
  const T* k = static_cast<const T*>(p.k) + cell.b * p.k_s[0] +
               cell.h * p.k_s[1];
  const T* v = static_cast<const T*>(p.v) + cell.b * p.v_s[0] +
               cell.h * p.v_s[1];
  const T* bias = p.bias == nullptr ? nullptr
      : static_cast<const T*>(p.bias) + cell.b * p.b_s[0] +
        cell.h * p.b_s[1];
  float* dbias = cell.chunk == 0 ? p.dbias : nullptr;  // written by one chunk
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;

  int row[2], st[2] = {0, 0}, en[2] = {0, 0};
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + r0 + 8 * hh;
    const bool ok = row[hh] < p.Tq;
    lse[hh] = ok ? p.lse[(long long)bh * p.lse_pitch + row[hh]] : 0.f;
    delta[hh] = ok ? p.delta[(long long)bh * p.delta_pitch + row[hh]] : 0.f;
    if (SPARSE) unpack_se(p.se[(long long)cell.b * p.Tq + row[hh]], st[hh],
                          en[hh]);
  }
  float dq[8][4], s[8][4], dp[8][4];
  zero(dq);

  const int n_k = SPARSE ? nk : dense_k_tiles(p, q0);
  const int* vis = SPARSE ? p.vis + ((long long)cell.b * nq + cell.tile) * nk
                          : nullptr;
  for (int kt = 0; kt < n_k; ++kt) {
    if (SPARSE && __ldg(vis + kt) == 0) continue;  // the same for the CTA
    const int k0 = kt * kTile;
    zero(s);
    zero(dp);
    for (int d0 = 0; d0 < p.D; d0 += kTile) {
      __syncthreads();
      load_tile<T, false>(sQ, q + d0, p.q_s[2], p.Tq - q0, tid);
      load_tile<T, false>(sK, k + k0 * p.k_s[2] + d0, p.k_s[2], p.Tk - k0,
                          tid);
      load_tile<T, false>(sG, gg + d0, p.g_s[2], p.Tq - q0, tid);
      load_tile<T, false>(sV, v + k0 * p.v_s[2] + d0, p.v_s[2], p.Tk - k0,
                          tid);
      __syncthreads();
      slice_product(s, sQ, sK, r0, t);   // S = Q·Kᵀ
      slice_product(dp, sG, sV, r0, t);  // dP = dO·Vᵀ
    }
    __syncthreads();
    load_tile<T, true>(sK, k + k0 * p.k_s[2] + oc, p.k_s[2], p.Tk - k0, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid,
                                         kThreads);
    __syncthreads();

    // ds = p·(dp − delta) in place of s
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, cl = nb * 8 + 2 * t + (e & 1), col = k0 + cl;
        float x = s[nb][e] * p.sm_scale;
        bool ok;
        if (SPARSE) {
          ok = col >= st[hh] && col < en[hh] && (!p.causal || col <= row[hh]);
        } else {
          ok = row[hh] < p.Tq && col < p.Tk;
          if (bias != nullptr && ok)
            x += to_f(bias[row[hh] * p.b_s[2] + col * p.b_s[3]]);
          if (p.causal && col > row[hh]) x = kNegInf;
        }
        const float pr = ok ? expf(x - lse[hh]) : 0.f;
        const bool keep = !p.drop.on ||
            sKeep[(r0 + 8 * hh) * flash::kKeepPitch + cl];
        const float dpv = keep ? dp[nb][e] * drop_scale : 0.f;
        s[nb][e] = pr * (dpv - delta[hh]);
        if (!SPARSE && dbias != nullptr && ok)  // per query: ds itself
          dbias[((long long)bh * p.Tq + row[hh]) * p.Tk + col] = s[nb][e];
      }
    __syncwarp();
    store_frag<T>(sQ, s, r0, t);  // dS, rounded to T
    __syncwarp();
    product(dq, sQ, sK, r0, t);   // dQ += dS·K over this chunk
  }
  store_out<T>(static_cast<T*>(p.dq) + cell.b * p.dq_s[0] +
                   cell.h * p.dq_s[1] + q0 * p.dq_s[2] + oc,
               p.dq_s[2], dq, r0, t, p.Tq - q0, p.sm_scale);
}

// ---------------------------------------------------------------------------
// dk/dv: a CTA owns 64 keys and dk, dv columns [64·chunk, +64); its
// fragments are Sᵀ and dPᵀ (rows keys, columns queries).
// ---------------------------------------------------------------------------
template <typename T, bool SPARSE>
__global__ void __launch_bounds__(kThreads) wide_dkv_kernel(WideParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm{smem_raw};
  T* sA = sm.tile<T>(0);   // K slice, then Pᵀ
  T* sB = sm.tile<T>(1);   // Q slice, then dOᵀ chunk
  T* sC = sm.tile<T>(2);   // V slice, then dSᵀ
  T* sD = sm.tile<T>(3);   // dO slice, then Qᵀ chunk
  uint8_t* sKeep = sm.keep<T>();
  float* sLse = sm.rows<T>(0);
  float* sDelta = sm.rows<T>(1);
  int* sStart = reinterpret_cast<int*>(sm.rows<T>(2));
  int* sEnd = reinterpret_cast<int*>(sm.rows<T>(3));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;
  const int nq = ntiles(p.Tq), nk = ntiles(p.Tk), nch = p.D / kTile;
  const Cell cell = cell_of(nk, nch, p.H);
  const int k0 = cell.tile * kTile, oc = cell.chunk * kTile, bh = cell.bh;
  const T* q = static_cast<const T*>(p.q) + cell.b * p.q_s[0] +
               cell.h * p.q_s[1];
  const T* gg = static_cast<const T*>(p.g) + cell.b * p.g_s[0] +
                cell.h * p.g_s[1];
  const T* k = static_cast<const T*>(p.k) + cell.b * p.k_s[0] +
               cell.h * p.k_s[1] + k0 * p.k_s[2];
  const T* v = static_cast<const T*>(p.v) + cell.b * p.v_s[0] +
               cell.h * p.v_s[1] + k0 * p.v_s[2];
  const T* bias = p.bias == nullptr ? nullptr
      : static_cast<const T*>(p.bias) + cell.b * p.b_s[0] +
        cell.h * p.b_s[1];
  const float drop_scale = p.drop.on ? p.drop.scale : 1.f;

  int key[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) key[hh] = k0 + r0 + 8 * hh;
  float dk[8][4], dv[8][4], st[8][4], dpt[8][4];
  float dbc[2] = {0.f, 0.f};
  zero(dk);
  zero(dv);

  // dense causal: q tiles before the key tile see none of its keys
  const int iq0 = (!SPARSE && p.causal) ? min(cell.tile, nq) : 0;
  const int* vis = SPARSE ? p.vis + (long long)cell.b * nq * nk + cell.tile
                          : nullptr;
  for (int iq = iq0; iq < nq; ++iq) {
    if (SPARSE && __ldg(vis + (long long)iq * nk) == 0) continue;
    const int q0 = iq * kTile;
    zero(st);
    zero(dpt);
    for (int d0 = 0; d0 < p.D; d0 += kTile) {
      __syncthreads();
      load_tile<T, false>(sA, k + d0, p.k_s[2], p.Tk - k0, tid);
      load_tile<T, false>(sB, q + q0 * p.q_s[2] + d0, p.q_s[2], p.Tq - q0,
                          tid);
      load_tile<T, false>(sC, v + d0, p.v_s[2], p.Tk - k0, tid);
      load_tile<T, false>(sD, gg + q0 * p.g_s[2] + d0, p.g_s[2], p.Tq - q0,
                          tid);
      __syncthreads();
      slice_product(st, sA, sB, r0, t);   // Sᵀ = K·Qᵀ
      slice_product(dpt, sC, sD, r0, t);  // dPᵀ = V·dOᵀ
    }
    __syncthreads();
    load_tile<T, true>(sB, gg + q0 * p.g_s[2] + oc, p.g_s[2], p.Tq - q0, tid);
    load_tile<T, true>(sD, q + q0 * p.q_s[2] + oc, p.q_s[2], p.Tq - q0, tid);
    if (tid < kTile) {
      const int qq = q0 + tid;
      const bool ok = qq < p.Tq;
      sLse[tid] = ok ? p.lse[(long long)bh * p.lse_pitch + qq] : 0.f;
      sDelta[tid] = ok ? p.delta[(long long)bh * p.delta_pitch + qq] : 0.f;
      int s0 = 0, e0 = 0;
      if (SPARSE) unpack_se(p.se[(long long)cell.b * p.Tq + qq], s0, e0);
      sStart[tid] = s0;
      sEnd[tid] = e0;
    }
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid,
                                         kThreads);
    __syncthreads();

#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, ql = nb * 8 + 2 * t + (e & 1), qq = q0 + ql;
        const int kk = key[hh];
        float x = st[nb][e] * p.sm_scale;
        bool ok;
        if (SPARSE) {
          ok = kk >= sStart[ql] && kk < sEnd[ql] && (!p.causal || kk <= qq);
        } else {
          ok = qq < p.Tq && kk < p.Tk;
          if (bias != nullptr && ok)
            x += to_f(bias[qq * p.b_s[2] + kk * p.b_s[3]]);
          if (p.causal && kk > qq) x = kNegInf;
        }
        const float pr = ok ? expf(x - sLse[ql]) : 0.f;
        const bool keep = !p.drop.on ||
            sKeep[ql * flash::kKeepPitch + r0 + 8 * hh];
        const float dpv = keep ? dpt[nb][e] * drop_scale : 0.f;
        const float ds = pr * (dpv - sDelta[ql]);
        dbc[hh] += ds;
        st[nb][e] = keep ? pr * drop_scale : 0.f;  // Pᵀ, dropped
        dpt[nb][e] = ds;                          // dSᵀ
      }
    __syncwarp();
    store_frag<T>(sA, st, r0, t);
    store_frag<T>(sC, dpt, r0, t);
    __syncwarp();
    product(dv, sA, sB, r0, t);  // dV += Pᵀ·dO over this chunk
    product(dk, sC, sD, r0, t);  // dK += dSᵀ·Q over this chunk
  }
  const int rows = p.Tk - k0;
  store_out<T>(static_cast<T*>(p.dk) + cell.b * p.dk_s[0] +
                   cell.h * p.dk_s[1] + k0 * p.dk_s[2] + oc,
               p.dk_s[2], dk, r0, t, rows, p.sm_scale);
  store_out<T>(static_cast<T*>(p.dv) + cell.b * p.dv_s[0] +
                   cell.h * p.dv_s[1] + k0 * p.dv_s[2] + oc,
               p.dv_s[2], dv, r0, t, rows, 1.f);
  if (!SPARSE && p.dbias_col != nullptr && cell.chunk == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 1);
      dbc[hh] += __shfl_xor_sync(0xffffffffu, dbc[hh], 2);
      if (t == 0 && key[hh] < p.Tk)
        p.dbias_col[(long long)bh * p.Tk + key[hh]] = dbc[hh];
    }
  }
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
            p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop.threshold,
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
            p.drop.on ? flash::keep_bits_rows(key0, key1, p.drop.threshold,
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
            p.drop.on ? flash::keep_bits_cols(key0, key1, p.drop.threshold,
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
          key0, key1, p.drop.threshold, c.bh, q0 + r0, k0, t);
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

// bf16 CTAs of one backward kernel whose rows are T tokens: a 64-row tile
// and a 64-wide output chunk each, for every (b, h).
long long bf16_ctas(const WideParams& p, int T) {
  return (long long)((T + kTile - 1) / kTile) * p.B * p.H * (p.D / kTile);
}

template <typename T, bool SPARSE>
cudaError_t run_bwd(const WideParams& p, cudaStream_t s) {
  cudaError_t err = launch(wide_dkv_kernel<T, SPARSE>, bf16_ctas(p, p.Tk),
                           kThreads, smem_bytes<T>(), s, p);
  if (err != cudaSuccess) return err;
  return launch(wide_dq_kernel<T, SPARSE>, bf16_ctas(p, p.Tq), kThreads,
                smem_bytes<T>(), s, p);
}

void copy3(long long (&dst)[3], const long long* src) {
  for (int i = 0; i < 3; ++i) dst[i] = src[i];
}

void set_dropout(WideParams& p, const long long* seed, unsigned threshold,
                 float drop_scale, int dropout) {
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
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
                             float drop_scale, int dropout, void* stream) {
  WideParams p = {};
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.se = se; p.vis = vis;
  p.out = out; p.lse_out = lse;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  copy3(p.q_s, strides); copy3(p.k_s, strides + 3); copy3(p.v_s, strides + 6);
  copy3(p.o_s, strides + 9);
  for (int i = 0; i < 4; ++i) p.b_s[i] = strides[12 + i];
  p.sm_scale = sm_scale;
  p.causal = causal;
  set_dropout(p, seed, threshold, drop_scale, dropout);
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
                                  float drop_scale, int dropout,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(sparse ? bfw::run<true>(p, s) : bfw::run<false>(p, s));
}

// Backward on `stream`: f32 a launch each of the dk, dq and dv CTAs, or one
// launch of all three on smaller grids (f32w::run_bwd); bf16 the dk/dv
// kernel, then the dq kernel. strides: q, k, v, dO, dq, dk, dv (batch,
// head, token) in elements, then the bias's
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
                             int causal, int sparse, int dtype,
                             const long long* seed, unsigned threshold,
                             float drop_scale, int dropout, void* stream) {
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
  set_dropout(p, seed, threshold, drop_scale, dropout);
  if (!args_ok(p, dtype, sparse)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(sparse ? f32w::run_bwd<true>(p, s)
                        : f32w::run_bwd<false>(p, s));
  return (int)(sparse ? run_bwd<bf, true>(p, s) : run_bwd<bf, false>(p, s));
}

// Dynamic shared memory of a CTA of the forward (bwd = 0) or the
// backward's kernels (bwd = 1), dtype 0 = f32 or 1 = bf16, the same at every
// head dim.
int flash_attention_wide_smem(int dtype, int bwd) {
  if (dtype == 0) return f32w::kSmemBytes;
  return bwd ? smem_bytes<bf>() : bfw::kSmem;
}

// CTAs of the forward (bwd = 0) or of the backward's launches (bwd = 1;
// bf16: the dk/dv and dq kernels together) at a shape, on the current
// device; -1 for arguments the entries refuse.
long long flash_attention_wide_ctas(int bwd, int dtype, int B, int H, int Tq,
                                    int Tk, int D) {
  WideParams p = {};
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  if (!args_ok(p, dtype, 0)) return -1;
  if (dtype == 0) return bwd ? f32w::bwd_ctas(p) : f32w::fwd_ctas(p);
  return bwd ? bf16_ctas(p, Tq) + bf16_ctas(p, Tk)
             : bfw::ctas(B, H, Tq, Tk, D);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
