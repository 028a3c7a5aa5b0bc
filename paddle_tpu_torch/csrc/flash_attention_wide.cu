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
//
// Design: shared memory that does not grow with d. A CTA owns 64 queries (64
// keys in dk/dv) and one 64-wide chunk of its output's head dim; the chunks
// are a grid factor (the tuned kernels' chunk rule above d = 128, carried
// to any d). It forms the scores S = Q·Kᵀ (and dP = dO·Vᵀ) by walking the
// head dim in 64-wide slices through four [64][64] operand tiles in shared
// memory, taken in order, so the sums run in one order whatever d is; every
// chunk of a tile recomputes the same scores and online softmax bit for
// bit, and loads only its chunk of V (dq: of K; dk/dv: of dO and Q) for the
// second product. Shared memory is about 72 KB a CTA in f32 and 42 KB in
// bf16 at every d; the head dim is a runtime argument.
//   Products: one primitive, C[16 rows x 64] += A[16 x 64]·B[64 x 64]ᵀ with
//   A and B row-major in shared memory, in the m16n8k16 accumulator layout
//   (lane (g, t) of warp w holds rows 16w + g and 16w + g + 8, columns
//   8·nb + 2t and 8·nb + 2t + 1). bf16: mma.sync.m16n8k16, bf16 in, f32
//   accumulate, each head-dim slice of S and dP summed into a partial that
//   is added once (slice_product). f32: the same elements by FMA on the
//   CUDA cores, so the f32 parity of the other families holds with no
//   TF32. The second operands
//   of P·V, dS·K, Pᵀ·dO and dSᵀ·Q are stored transposed as they are loaded,
//   and P or dS (rounded to the input type, as the TPU kernels round them)
//   go through shared memory as the A operand.
//
// Semantics, the same as every other flash family:
//   - dense: scores past Tk take no part; scale, then the additive bias
//     (broadcast through strides), then causal as -1e30; the running max
//     starts at -1e30, a zero row sum divides by 1, lse = m + log(l); causal
//     q tiles walk only the key tiles they can see.
//   - sparse: query i sees keys start <= k < end of its se = (start << 16) |
//     end (and k <= i under causal); masked probabilities are exactly 0; the
//     walks visit only the 64x64 tiles whose bit of `vis` is set, so a
//     skipped tile is bitwise invisible.
//   - dropout: the keep bit of (bh, i, j) from philox.cuh's counter rule, so
//     the mask equals the plain version's; lse is over the undropped p.
//   - dbias: per query (ds itself, written by chunk 0 of the dq CTAs; the
//     wrapper zeroes the tiles a causal walk skips) or the column sum (chunk
//     0 of the dk/dv CTAs, summed in a fixed order).
//   - delta comes from the dense backward's delta kernel, before the launch.
//   - no atomics: each output element is written by one CTA, so two calls
//     give the same bits. Grids are flat, so B·nh has no 65,535 cap.
//
// Bound. The work is 4·d flops a (query, key) pair forward and 10·d
// backward, so at d >= 320 the kernels are bound by operations. This first
// version recomputes the scores once per output chunk (d/64 times), runs no
// copy ahead of the math and, in f32, loads from shared memory about once
// per two FMAs: it is far from that bound. Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

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

// Operand tiles: f32 rows of 65 floats, bf16 rows of 72 values (144 bytes,
// on the 16-byte grid): both conflict-free for the fragment reads below.
template <typename T> struct Pitch;
template <> struct Pitch<float> { static constexpr int kValue = kTile + 1; };
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
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
    } else if (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * P + c) = x;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[r * P + c + e] = xe[e];
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
__device__ __forceinline__ void product(float (&c)[8][4], const float* A,
                                        const float* B, int r0, int t) {
  constexpr int P = Pitch<float>::kValue;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float a0 = A[r0 * P + k], a1 = A[(r0 + 8) * P + k];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float b0 = B[(nb * 8 + 2 * t) * P + k];
      const float b1 = B[(nb * 8 + 2 * t + 1) * P + k];
      c[nb][0] = fmaf(a0, b0, c[nb][0]);
      c[nb][1] = fmaf(a0, b1, c[nb][1]);
      c[nb][2] = fmaf(a1, b0, c[nb][2]);
      c[nb][3] = fmaf(a1, b1, c[nb][3]);
    }
  }
}

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

// c += the product of one 64-wide head-dim slice (S, dP over the slices).
// f32 sums into c directly, in the order of one pass over d. bf16 sums the
// slice into a partial first and adds it with one round-to-nearest FADD:
// the tensor core rounds its f32 sums toward zero, and at d = 512 a chain
// of 32 such k steps drifts further from the plain version's sums than
// the backward's tolerance allows (the per-query dbias).
__device__ __forceinline__ void slice_product(float (&c)[8][4],
                                              const float* A, const float* B,
                                              int r0, int t) {
  product(c, A, B, r0, t);
}

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
// Forward: a CTA owns 64 queries and output columns [64·chunk, +64).
// ---------------------------------------------------------------------------
template <typename T, bool SPARSE>
__global__ void __launch_bounds__(kThreads) wide_fwd_kernel(WideParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm{smem_raw};
  T* sA = sm.tile<T>(0);   // Q slice, then P
  T* sB = sm.tile<T>(1);   // K slice, then Vᵀ chunk
  uint8_t* sKeep = sm.keep<T>();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;
  const int nq = ntiles(p.Tq), nk = ntiles(p.Tk), nch = p.D / kTile;
  const Cell cell = cell_of(nq, nch, p.H);
  const int q0 = cell.tile * kTile, oc = cell.chunk * kTile, bh = cell.bh;
  const T* q = static_cast<const T*>(p.q) + cell.b * p.q_s[0] +
               cell.h * p.q_s[1] + q0 * p.q_s[2];
  const T* k = static_cast<const T*>(p.k) + cell.b * p.k_s[0] +
               cell.h * p.k_s[1];
  const T* v = static_cast<const T*>(p.v) + cell.b * p.v_s[0] +
               cell.h * p.v_s[1] + oc;
  const T* bias = p.bias == nullptr ? nullptr
      : static_cast<const T*>(p.bias) + cell.b * p.b_s[0] +
        cell.h * p.b_s[1];

  int row[2], st[2] = {0, 0}, en[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + r0 + 8 * hh;
    if (SPARSE) unpack_se(p.se[(long long)cell.b * p.Tq + row[hh]], st[hh],
                          en[hh]);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[8][4], s[8][4];
  zero(o);

  const int n_k = SPARSE ? nk : dense_k_tiles(p, q0);
  const int* vis = SPARSE ? p.vis + ((long long)cell.b * nq + cell.tile) * nk
                          : nullptr;
  for (int kt = 0; kt < n_k; ++kt) {
    if (SPARSE && __ldg(vis + kt) == 0) continue;  // the same for the CTA
    const int k0 = kt * kTile;
    zero(s);
    for (int d0 = 0; d0 < p.D; d0 += kTile) {
      __syncthreads();  // the previous tiles are consumed
      load_tile<T, false>(sA, q + d0, p.q_s[2], p.Tq - q0, tid);
      load_tile<T, false>(sB, k + k0 * p.k_s[2] + d0, p.k_s[2], p.Tk - k0,
                          tid);
      __syncthreads();
      slice_product(s, sA, sB, r0, t);
    }
    __syncthreads();  // every warp is done with the Q and K slices
    load_tile<T, true>(sB, v + k0 * p.v_s[2], p.v_s[2], p.Tk - k0, tid);
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid,
                                         kThreads);
    __syncthreads();

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, col = k0 + nb * 8 + 2 * t + (e & 1);
        float x = s[nb][e] * p.sm_scale;
        if (SPARSE) {
          const bool ok = col >= st[hh] && col < en[hh] &&
                          (!p.causal || col <= row[hh]);
          x = ok ? x : kNegInf;
        } else {
          if (bias != nullptr && row[hh] < p.Tq && col < p.Tk)
            x += to_f(bias[row[hh] * p.b_s[2] + col * p.b_s[3]]);
          if (p.causal && col > row[hh]) x = kNegInf;
          if (col >= p.Tk) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float pr = expf(s[nb][e] - m[hh]);
        if (SPARSE) {
          const int col = k0 + nb * 8 + 2 * t + (e & 1);
          const bool ok = col >= st[hh] && col < en[hh] &&
                          (!p.causal || col <= row[hh]);
          pr = ok ? pr : 0.f;
        }
        sum[hh] += pr;  // the row sum is over the undropped p
        if (p.drop.on)
          pr = sKeep[(r0 + 8 * hh) * flash::kKeepPitch + nb * 8 + 2 * t +
                     (e & 1)] ? pr * p.drop.scale : 0.f;
        s[nb][e] = pr;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l[hh] = l[hh] * corr[hh] + sum[hh];
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      o[nb][0] *= corr[0]; o[nb][1] *= corr[0];
      o[nb][2] *= corr[1]; o[nb][3] *= corr[1];
    }
    // P (rounded to T) into the Q slice's tile: each warp writes and reads
    // only its own 16 rows
    __syncwarp();
    store_frag<T>(sA, s, r0, t);
    __syncwarp();
    product(o, sA, sB, r0, t);
  }

  T* out = static_cast<T*>(p.out) + cell.b * p.o_s[0] + cell.h * p.o_s[1] +
           q0 * p.o_s[2] + oc;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
    const int r = r0 + 8 * hh;
    if (q0 + r >= p.Tq) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[r * p.o_s[2] + nb * 8 + 2 * t + e] =
            from_f<T>(o[nb][2 * hh + e] / l_safe);
    if (t == 0 && cell.chunk == 0)
      p.lse_out[(long long)bh * p.Tq + q0 + r] = m[hh] + logf(l_safe);
  }
}

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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const WideParams& p, int ntile,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)ntile * p.B * p.H * (p.D / kTile);
  if (ctas <= 0 || ctas > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, bool SPARSE>
cudaError_t run_fwd(const WideParams& p, cudaStream_t s) {
  return launch(wide_fwd_kernel<T, SPARSE>, smem_bytes<T>(), p,
                (p.Tq + kTile - 1) / kTile, s);
}

template <typename T, bool SPARSE>
cudaError_t run_bwd(const WideParams& p, cudaStream_t s) {
  cudaError_t err = launch(wide_dkv_kernel<T, SPARSE>, smem_bytes<T>(), p,
                           (p.Tk + kTile - 1) / kTile, s);
  if (err != cudaSuccess) return err;
  return launch(wide_dq_kernel<T, SPARSE>, smem_bytes<T>(), p,
                (p.Tq + kTile - 1) / kTile, s);
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

// Forward. strides: q, k, v, out (batch, head, token) in elements, then the
// bias's (batch, head, q, k); the head dim is contiguous and every row
// 16-byte aligned. sparse = 0: the dense mask (bias may be null; causal);
// sparse = 1: se [B, Tq] and vis [B, Tq/64, Tk/64] (no bias). lse is
// [B*H, Tq] f32. With dropout != 0, `seed` points at one int64 on the
// device and a score is dropped iff its Philox word < `threshold`; kept p is
// scaled by `drop_scale`. Returns a cudaError_t (0 = launched).
int flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                             const void* bias, const int* se, const int* vis,
                             void* out, float* lse, int B, int H, int Tq,
                             int Tk, int D, const long long* strides,
                             float sm_scale, int causal, int sparse,
                             int dtype, const long long* seed,
                             unsigned threshold, float drop_scale,
                             int dropout, void* stream) {
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
  if (!args_ok(p, dtype, sparse)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(sparse ? run_fwd<float, true>(p, s)
                        : run_fwd<float, false>(p, s));
  return (int)(sparse ? run_fwd<bf, true>(p, s) : run_fwd<bf, false>(p, s));
}

// Backward: the dk/dv kernel, then the dq kernel, on `stream`. strides: q,
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
    return (int)(sparse ? run_bwd<float, true>(p, s)
                        : run_bwd<float, false>(p, s));
  return (int)(sparse ? run_bwd<bf, true>(p, s) : run_bwd<bf, false>(p, s));
}

// Dynamic shared memory of a CTA of each kernel (dtype 0 = f32, 1 = bf16).
int flash_attention_wide_smem(int dtype) {
  return dtype == 0 ? smem_bytes<float>() : smem_bytes<bf>();
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
