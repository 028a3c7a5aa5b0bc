// Flash-attention forward for Hopper (sm_90a): out = softmax(q·kᵀ·scale +
// bias [, causal]) [, dropout] · v, and lse = the row log-sum-exp, without
// materializing the [Tq, Tk] score matrix.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/flash_attention.py:
// _fwd_kernel (via _flash_fwd_pallas) and _fwd_kernel_onepass (via
// _flash_fwd_pallas_onepass). Edge semantics follow them exactly: masked
// scores are -1e30 (not -inf), the running max starts at -1e30, a row whose
// sum is 0 divides by 1, lse = m + log(l). Keys past the ragged end of Tk
// take no part at all. Accumulation and lse are f32; out has the input type.
// Attention dropout (philox.cuh) drops p after the row sum is taken, so lse
// is over the undropped p, as in the TPU kernel; kept p is scaled by
// 1 / (1 - rate) before p·v.
//
// One CTA owns a 64-row q tile of one (batch, head) and walks the 64-key
// tiles in a loop, keeping the running max and sum in f32 registers: the
// loop takes the place of the TPU grid's sequential K axis. The grid is the
// (q tile, batch·head) pairs flattened onto blockIdx.x, so B·nh has no
// 65,535 cap. q, k, v and out are addressed through (batch, head, token)
// strides with a contiguous head dim, so the packed [B, T, nh·d] layout --
// and the q/k/v thirds of a fused qkv projection -- are read in place.
//
// Bound. The work is 4·B·nh·Tq·Tk·d flops over the bytes of q, k, v, out,
// lse and the bias: about T/2 flops a byte in bf16 (64 at T = 128, 256 at
// T = 512), under the H100's ~295 flop/byte tensor-core ridge, so a perfect
// bf16 kernel is memory bound; in f32 (T/4 flops a byte against a ~20
// flop/byte ridge for 67 TFLOP/s of FMA) it is compute bound.
//
// bf16 design (what it does about the bound). The products run on wgmma
// with operands in shared memory as TMA writes them (hopper.cuh): S = Q·Kᵀ
// with both K-major, then O += P·V with P converted to bf16 in registers as
// the A operand and V read MN-major through the transpose flag, so V is
// never transposed. Thread 0 of the one warpgroup starts TMA copies into a
// ring of two stages (K, V and the bias rows of a key tile each) with
// mbarriers, one key tile ahead of the math, so the next tile's bytes
// arrive while this one is computed; TMA zero-fills rows past Tk and Tq.
// The bias comes with the tile: the 64-key slice of the mask for a bias
// shared by the queries, a 64x64 block for a per-query one; no score reads
// device memory. Dropout keep bits are drawn in registers for the lane's
// own accumulator elements (flash::keep_bits_rows). The score loop has no
// branch: the ragged edge, the causal mask and dropout are selects and the
// bias comes into registers once a tile; exp is ex2.approx. With products
// this cheap, that per-element work is what bounds a CTA, so it is kept
// lean, and the stages are sized by the bias mode (no per-query slot for
// the mask) so that more CTAs share an SM and hide each other's latency.
// 64-row tiles keep the grid at 192 CTAs for BERT's T = 128 (B·nh = 96).
// Head dims 64, 128, 192 and 256. Above 128 the O accumulator would not fit
// in registers beside S, so a CTA owns one 64-wide chunk of the head dim
// (a third grid factor): it computes S and the softmax over the full head
// dim, as every chunk of its q tile does bit for bit, and loads only its
// chunk of V.
//   f32: 256 threads, a 4x4 register tile each, FMA on the CUDA cores; TF32
//        would lose the f32 parity the tests hold it to. At d = 256 its
//        tiles take 218 KB of the 227 KB a CTA may have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the JAX package
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;  // nullptr = no bias; same dtype as q
  void* out;
  float* lse;        // [B*H, Tq]
  int B, H, Tq, Tk;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  long long b_sb, b_sh, b_sq, b_sk;
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

// Score of (row, col) after scale, bias and the masks; -inf past Tk.
__device__ __forceinline__ float finish_score(const FwdParams& p, float acc,
                                              const float* bias, int row,
                                              int col) {
  if (col >= p.Tk) return -INFINITY;
  float s = acc * p.sm_scale;
  if (bias != nullptr && row < p.Tq) s += bias[row * p.b_sq + col * p.b_sk];
  if (p.causal && col > row) s = kNegInf;
  return s;
}

// Key tiles a q tile needs: causal rows see no key past their own index.
__device__ __forceinline__ int num_k_tiles(int Tq, int Tk, int causal,
                                           int q0) {
  int n = (Tk + kBlockK - 1) / kBlockK;
  if (causal) {
    int last_row = min(q0 + kBlockQ, Tq) - 1;
    n = min(n, last_row / kBlockK + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256)
flash_fwd_f32_kernel(FwdParams p) {
  constexpr int kPad = D + 1;   // odd row pitch: conflict-free column reads
  constexpr int kPitchP = kBlockK + 1;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                   // [64][D+1]
  float* sK = sQ + kBlockQ * kPad;        // [64][D+1]
  float* sV = sK + kBlockK * kPad;        // [64][D]
  float* sP = sV + kBlockK * D;           // [64][65]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sP + kBlockQ * kPitchP);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n_q = (p.Tq + kBlockQ - 1) / kBlockQ;  // grid: (tile, b·h) flat
  const int bh = blockIdx.x / n_q;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (blockIdx.x % n_q) * kBlockQ;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_sb + h * p.b_sh;

  constexpr int kVec = D / 4;  // float4 per row
  for (int i = tid; i < kBlockQ * kVec; i += 256) {
    int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Tq)
      x = *reinterpret_cast<const float4*>(q + (q0 + r) * p.q_st + c);
    float* dst = sQ + r * kPad + c;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = num_k_tiles(p.Tq, p.Tk, p.causal, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's sK/sV/sP are consumed
    for (int i = tid; i < kBlockK * kVec; i += 256) {
      int r = i / kVec, c = (i % kVec) * 4;
      float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
      if (k0 + r < p.Tk) {
        xk = *reinterpret_cast<const float4*>(k + (k0 + r) * p.k_st + c);
        xv = *reinterpret_cast<const float4*>(v + (k0 + r) * p.v_st + c);
      }
      float* dk = sK + r * kPad + c;
      dk[0] = xk.x; dk[1] = xk.y; dk[2] = xk.z; dk[3] = xk.w;
      *reinterpret_cast<float4*>(sV + r * D + c) = xv;
    }
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 256);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * kPad + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = finish_score(p, s[i][j], bias, row, k0 + tx + 16 * j);
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
        const float e = expf(s[i][j] - m_new);
        sum += e;  // the row sum is over the undropped p
        float pv = e;
        if (p.drop.on)
          pv = sKeep[(ty * 4 + i) * flash::kKeepPitch + tx + 16 * j]
                   ? e * p.drop.scale : 0.f;
        sP[(ty * 4 + i) * kPitchP + tx + 16 * j] = pv;
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
    for (int kk = 0; kk < kBlockK; ++kk) {
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
    if (row >= p.Tq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[row * p.o_st + tx + 16 * j] = acc[i][j] / l_safe;
    if (tx == 0) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-loaded tiles.
// ---------------------------------------------------------------------------
struct Bf16FwdParams {
  CUtensorMap tq, tk, tv;  // [B, H, T, D]: boxes of 64 rows x 64 values
  CUtensorMap tb;          // bias [Bb, Hb, Qb, Tk]: 1 or 64 rows x 64 keys
  __nv_bfloat16* out;
  float* lse;              // [B*H, lse_pitch]
  int B, H, Tq, Tk, lse_pitch;
  long long o_sb, o_sh, o_st;
  int bias_mode;           // 0 none, 1 one row for all queries, 2 per query
  int bias_b, bias_h;      // 1 = the bias is broadcast over batch / heads
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

// Byte offsets from the 1024-aligned base: Q, then two stages of K, the
// CTA's chunk of V and the bias slot (sized by the bias mode, so a call
// without a per-query bias leaves room for more CTAs on an SM), then the
// barriers.
template <int D, int DC>
struct FwdLayout {
  static constexpr int kTile = D / 64 * hopper::kBoxBytes;    // [64][D]
  static constexpr int kVTile = DC / 64 * hopper::kBoxBytes;  // [64][DC]
  static __host__ __device__ constexpr int stage(int bias_mode) {
    return kTile + kVTile + hopper::bias_slot(bias_mode);
  }
  static __host__ __device__ constexpr int bars(int bias_mode) {
    return kTile + 2 * stage(bias_mode);
  }
  static constexpr size_t smem(int bias_mode) {
    return bars(bias_mode) + 3 * sizeof(uint64_t) + 1024;
  }
};

// Thread 0: the copies of key tile kt (K, V's chunk oc, the bias rows) into
// stage kt % 2, completing that stage's barrier.
template <int D, int DC>
__device__ __forceinline__ void load_kv_stage(const Bf16FwdParams& p,
                                         unsigned char* smem, uint64_t* bars,
                                         int kt, int q0, int b, int h,
                                         int oc) {
  using L = FwdLayout<D, DC>;
  unsigned char* st = smem + L::kTile + (kt & 1) * L::stage(p.bias_mode);
  uint64_t* bar = &bars[kt & 1];
  const uint32_t bias_bytes =
      p.bias_mode == 2 ? hopper::kBoxBytes : p.bias_mode == 1 ? 128 : 0;
  hopper::mbar_expect_tx(bar, L::kTile + L::kVTile + bias_bytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load(st + c * hopper::kBoxBytes, &p.tk, bar, c * 64,
                     kt * kBlockK, h, b);
#pragma unroll
  for (int c = 0; c < DC / 64; ++c)
    hopper::tma_load(st + L::kTile + c * hopper::kBoxBytes, &p.tv, bar,
                     oc * DC + c * 64, kt * kBlockK, h, b);
  if (p.bias_mode)
    hopper::tma_load(st + L::kTile + L::kVTile, &p.tb, bar, kt * kBlockK,
                     p.bias_mode == 2 ? q0 : 0, p.bias_h ? 0 : h,
                     p.bias_b ? 0 : b);
}

template <int D, int DC>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __grid_constant__ Bf16FwdParams p) {
  using L = FwdLayout<D, DC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_base(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + L::bars(p.bias_mode));  // 2 + Q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (p.Tq + kBlockQ - 1) / kBlockQ;
  // grid: (chunk, q tile, b·h) flat, the chunk fastest
  const int oc = blockIdx.x % (D / DC), cell = blockIdx.x / (D / DC);
  const int bh = cell / n_q, q0 = (cell % n_q) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const int n_tiles = num_k_tiles(p.Tq, p.Tk, p.causal, q0);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bars[2], L::kTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_load(sQ + c * hopper::kBoxBytes, &p.tq, &bars[2], c * 64,
                       q0, h, b);
    load_kv_stage<D, DC>(p, smem, bars, 0, q0, b, h, oc);
    if (n_tiles > 1) load_kv_stage<D, DC>(p, smem, bars, 1, q0, b, h, oc);
  }
  uint32_t key0 = 0, key1 = 0;
  if (p.drop.on) {
    const unsigned long long sd = static_cast<unsigned long long>(*p.drop.seed);
    key0 = static_cast<uint32_t>(sd);
    key1 = static_cast<uint32_t>(sd >> 32);
  }

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DC / 2], s[32];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  hopper::mbar_wait(&bars[2], 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const unsigned char* st = smem + L::kTile + (kt & 1) * L::stage(p.bias_mode);
    const unsigned char* sB = st + L::kTile + L::kVTile;
    hopper::mbar_wait(&bars[kt & 1], (kt >> 1) & 1);

    // S = Q·Kᵀ, both K-major
    hopper::pin(s);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::mma_ss<64, 0>(s, hopper::desc_kmajor(sQ, ks),
                            hopper::desc_kmajor(st, ks), ks > 0);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(s);

    // scale, bias and masks (selects, no branch); the tile's row max
    float bv[32];
    hopper::bias_rows(bv, sB, p.bias_mode, r0, t);
    const int k_left = p.Tk - k0;  // keys of this tile inside Tk
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = q0 + r0 + 8 * ((i >> 1) & 1);
      float x = fmaf(s[i], p.sm_scale, bv[i]);
      x = p.causal && k0 + c > row ? kNegInf : x;
      s[i] = c < k_left ? x : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }

    // online softmax over the 4 lanes that share a row
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = hopper::ex2((m[hh] - m_new) * hopper::kLog2e);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = hopper::ex2((s[i] - m[(i >> 1) & 1]) * hopper::kLog2e);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l[hh] = l[hh] * corr[hh] + sum[hh];
    }
    if (p.drop.on) {  // drop after the row sum: lse is over the undropped p
      const uint32_t keep = flash::keep_bits_rows(
          key0, key1, p.drop.threshold, bh, q0 + r0, k0, t);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = (keep >> i) & 1u ? s[i] * p.drop.scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P·V: P from registers, V MN-major
    uint32_t a[4][4];
    hopper::acc_to_a(a, s);
    hopper::pin(o);
    hopper::pin(a);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::mma_rs<DC, 1>(o, a[kk],
                            hopper::desc_mnmajor(st + L::kTile, kk), 1);
    hopper::wg_commit();
    hopper::wg_wait_all();
    hopper::pin(o);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && kt + 2 < n_tiles)
      load_kv_stage<D, DC>(p, smem, bars, kt + 2, q0, b, h, oc);
  }

  __nv_bfloat16* out = p.out + b * p.o_sb + h * p.o_sh + oc * DC;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (row >= p.Tq) continue;
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = out + row * p.o_st + 2 * t;
#pragma unroll
    for (int nb = 0; nb < DC / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(o[4 * nb + 2 * hh] * inv,
                                o[4 * nb + 2 * hh + 1] * inv);
    if (t == 0 && oc == 0)
      p.lse[(long long)bh * p.lse_pitch + row] = m[hh] + logf(l_safe);
  }
}

template <int D>
size_t smem_bytes_f32() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1)) +
         kBlockQ * flash::kKeepPitch;
}

// Opts a kernel into `max_smem` of dynamic shared memory once per device,
// then launches it with `smem` on `stream` over the flat (chunk, q tile,
// B·H) grid.
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, unsigned* configured, const Params& p,
                   int threads, size_t smem, size_t max_smem,
                   cudaStream_t stream, unsigned chunks = 1) {
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
  const unsigned blocks = (unsigned)((p.Tq + kBlockQ - 1) / kBlockQ) *
                          (unsigned)(p.B * p.H) * chunks;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// one flag word per (dtype, head dim): index D / 64 - 1, bf16 from 4
unsigned configured[8] = {};

template <int D>
cudaError_t launch_f32(const FwdParams& p, cudaStream_t s) {
  return launch(flash_fwd_f32_kernel<D>, &configured[D / 64 - 1], p, 256,
                smem_bytes_f32<D>(), smem_bytes_f32<D>(), s);
}

template <int D>
cudaError_t launch_bf16(const Bf16FwdParams& p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  using L = FwdLayout<D, DC>;
  return launch(flash_fwd_bf16_kernel<D, DC>, &configured[3 + D / 64], p, 128,
                L::smem(p.bias_mode), L::smem(2), s, D / DC);
}

template <int D>
int smem_bf16(int bias_mode) {
  return (int)FwdLayout<D, hopper::chunk_of<D>()>::smem(bias_mode);
}

}  // namespace

extern "C" {

// float32. Strides are in elements; the head dim is contiguous. With
// dropout != 0, `seed` points at one int64 on the device and a score is
// dropped iff its Philox word < `threshold`; kept p is scaled by
// `drop_scale`. Returns a cudaError_t (0 = launched).
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            const void* bias, void* out, float* lse, int B,
                            int H, int Tq, int Tk, int D, long long q_sb,
                            long long q_sh, long long q_st, long long k_sb,
                            long long k_sh, long long k_st, long long v_sb,
                            long long v_sh, long long v_st, long long o_sb,
                            long long o_sh, long long o_st, long long b_sb,
                            long long b_sh, long long b_sq, long long b_sk,
                            float sm_scale, int causal, const long long* seed,
                            unsigned threshold, float drop_scale, int dropout,
                            void* stream) {
  FwdParams p;
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.out = out; p.lse = lse;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.b_sb = b_sb; p.b_sh = b_sh; p.b_sq = b_sq; p.b_sk = b_sk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.scale = drop_scale;
  p.drop.on = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_f32<64>(p, s);
    case 128: return (int)launch_f32<128>(p, s);
    case 192: return (int)launch_f32<192>(p, s);
    case 256: return (int)launch_f32<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bfloat16. `tensors` holds the tensor descriptions (hopper::kDescLen int64
// each) of q, k, v and the bias (ignored when bias_mode is 0) in that
// order; out strides are in elements; lse rows are lse_pitch floats apart.
// Dropout as in flash_attention_fwd_f32. Returns a cudaError_t.
int flash_attention_fwd_bf16(const long long* tensors, void* out, float* lse,
                             int lse_pitch, int B, int H, int Tq, int Tk,
                             int D, long long o_sb, long long o_sh,
                             long long o_st, int bias_mode, float sm_scale,
                             int causal, const long long* seed,
                             unsigned threshold, float drop_scale,
                             int dropout, void* stream) {
  if (D != 64 && D != 128 && D != 192 && D != 256)
    return (int)cudaErrorInvalidValue;
  Bf16FwdParams p;
  const long long* bias = tensors + 3 * hopper::kDescLen;
  cudaError_t err;
  if ((err = hopper::make_map(&p.tq, tensors, true, 64, 64)) != cudaSuccess ||
      (err = hopper::make_map(&p.tk, tensors + hopper::kDescLen, true, 64,
                              64)) != cudaSuccess ||
      (err = hopper::make_map(&p.tv, tensors + 2 * hopper::kDescLen, true, 64,
                              64)) != cudaSuccess)
    return (int)err;
  if (bias_mode != 0 &&
      (err = hopper::make_map(&p.tb, bias, true, 64,
                              bias_mode == 2 ? 64 : 1)) != cudaSuccess)
    return (int)err;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.lse_pitch = lse_pitch;
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
  switch (D) {
    case 64: return (int)launch_bf16<64>(p, s);
    case 128: return (int)launch_bf16<128>(p, s);
    case 192: return (int)launch_bf16<192>(p, s);
    default: return (int)launch_bf16<256>(p, s);
  }
}

// Dynamic shared memory of the bf16 kernel at head dim D and a bias mode,
// in bytes.
int flash_attention_fwd_bf16_smem(int D, int bias_mode) {
  switch (D) {
    case 64: return smem_bf16<64>(bias_mode);
    case 128: return smem_bf16<128>(bias_mode);
    case 192: return smem_bf16<192>(bias_mode);
    case 256: return smem_bf16<256>(bias_mode);
    default: return 0;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
