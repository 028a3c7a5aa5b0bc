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
// bf16 kernel is memory bound. In f32 the products run in 3xTF32 (three
// TF32 products per f32 product at 495 TFLOP/s, a ~49 flop/byte ridge for
// T/4 flops a byte): compute bound at T = 512, close to the ridge at
// T = 128.
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
//
// f32 design. Both products run in 3xTF32 on mma.sync.m16n8k8
// (tf32x3.cuh), the f32 backward's design: S = Q·Kᵀ in kPartialDepth-column
// partial sums, split and summed as the backward recomputes it, so the lse
// written here matches its S; O += P·V with P taken from the accumulators
// as A fragments and V's B fragments read from the padded tile as it lies
// (tf32 wgmma would need V K-major), a key tile's product into a zeroed
// partial sum added to the rescaled O (the tensor core's sums round toward
// zero). Four warps own 16 rows each of the 64-row q tile, so the element
// loop, its selects and the register keep bits are the bf16 kernel's. Q
// stays in shared memory; K, V's chunk and the bias rows (or the 64x64
// per-query block) arrive by cp.async in a two-stage ring, one step ahead
// of the math, and ldmatrix reads Q and K. Head dims 64 to 256: above 128
// a CTA owns one 64-wide chunk of O, as in bf16, and K streams through the
// ring in 64-wide chunks of the head dim (a step each), as in the f32
// backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"
#include "tf32x3.cuh"

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
  int bias_mode;     // set by launch_f32
  float sm_scale;
  int causal;
  flash::Dropout drop;
};

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
// f32: 3xTF32 on the tensor cores (mma.sync.m16n8k8), tiles by cp.async.
// Four warps; warp w owns rows 16w..16w+15 of the 64-row q tile, so S's
// register 4·nb + 2·h + e of lane (g, t) is row 16w + g + 8h, key
// 8·nb + 2t + e: the bf16 kernel's wgmma layout, whose element loop and
// register keep bits this kernel shares.
// ---------------------------------------------------------------------------
using namespace tf32x3;

constexpr int kF32BiasPitch = 72;  // floats: conflict-free paired reads

// Shared memory, in floats: Q resident ([64][D + 4]); then two stages, each
// K ([64][KW + 4]: the whole head dim up to d = 128, else one 64-wide
// chunk of it a step), the CTA's chunk of V ([64][DC + 4]) and the bias
// (mode 1: the tile's 64 keys of a row shared by every query; mode 2: a
// [64][64] block, pitch kF32BiasPitch).
template <int D, int DC>
struct F32FwdLayout {
  static constexpr int kKW = D <= 128 ? D : 64;
  static constexpr int kSteps = D / kKW;  // steps a key tile
  static constexpr int kQ = kBlockQ * pitch_f32<D>();
  static constexpr int kK = kBlockK * pitch_f32<kKW>();
  static constexpr int kV = kBlockK * pitch_f32<DC>();
  static __host__ __device__ constexpr int bias(int mode) {
    return mode == 2 ? kBlockQ * kF32BiasPitch : mode == 1 ? kBlockK : 0;
  }
  static __host__ __device__ constexpr int stage(int mode) {
    return kK + kV + bias(mode);
  }
  static constexpr size_t smem(int mode) {
    return sizeof(float) * (kQ + 2 * stage(mode));
  }
};

// One CTA per (DC-wide output chunk, 64-row q tile, b·h), numbered by the
// flat grid, the chunk fastest. It walks the key tiles (through the causal
// diagonal) in steps of one K chunk over a two-stage cp.async ring, one step
// ahead of the math: S = Q·Kᵀ over the full head dim in kPartialDepth-column
// partial sums (the f32 backward's split and order, so the lse written here
// is the one its recomputed S gives), then at a tile's last step the
// branch-free element loop, the online softmax and O += P·V, P from
// registers and V as it lies (acc_product_tf32), into a zeroed partial
// added to the rescaled O.
template <int D, int DC>
__global__ void __launch_bounds__(128)
flash_fwd_f32_kernel(FwdParams p) {
  using L = F32FwdLayout<D, DC>;
  constexpr int kKW = L::kKW, kSteps = L::kSteps;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;
  float* stages = smem_f32 + L::kQ;
  const int bias_mode = p.bias_mode;
  const int stage_len = L::stage(bias_mode);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (p.Tq + kBlockQ - 1) / kBlockQ;
  const int oc = blockIdx.x % (D / DC), cell = blockIdx.x / (D / DC);
  const int bh = cell / n_q, q0 = (cell % n_q) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                   q0 * p.q_st;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh +
                   oc * DC;
  const float* bias = p.bias == nullptr ? nullptr
      : static_cast<const float*>(p.bias) + b * p.b_sb + h * p.b_sh;
  const int n_tiles = num_k_tiles(p.Tq, p.Tk, p.causal, q0);
  const int n_steps = n_tiles * kSteps;

  // step j: key tile j / kSteps, K chunk j % kSteps; the last step of a
  // tile also brings V's chunk and the bias
  auto load_step = [&](int j) {
    float* st = stages + (j & 1) * stage_len;
    const int k0 = j / kSteps * kBlockK, c = j % kSteps;
    copy_tile<kKW>(st, k + k0 * p.k_st + c * kKW, p.k_st, p.Tk - k0, tid);
    if (c != kSteps - 1) return;
    copy_tile<DC>(st + L::kK, v + k0 * p.v_st, p.v_st, p.Tk - k0, tid);
    float* sb = st + L::kK + L::kV;
    if (bias_mode == 1) {
      if (tid < kBlockK) {
        const bool ok = k0 + tid < p.Tk;
        cp_async4(sb + tid, bias + (ok ? k0 + tid : 0) * p.b_sk, ok);
      }
    } else if (bias_mode == 2) {
#pragma unroll 4
      for (int i = tid; i < kBlockQ * kBlockK; i += kThreads) {
        const int r = i / kBlockK, c2 = i % kBlockK;
        const bool ok = q0 + r < p.Tq && k0 + c2 < p.Tk;
        cp_async4(sb + r * kF32BiasPitch + c2,
                  bias + (ok ? (q0 + r) * p.b_sq + (k0 + c2) * p.b_sk : 0),
                  ok);
      }
    }
  };
  copy_tile<D>(sQ, q, p.q_st, p.Tq - q0, tid);
  load_step(0);
  cp_async_commit();
  if (n_steps > 1) load_step(1);
  cp_async_commit();

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

  for (int j = 0; j < n_steps; ++j) {
    const int c = j % kSteps, k0 = j / kSteps * kBlockK;
    const float* st = stages + (j & 1) * stage_len;
    cp_async_wait<1>();
    __syncthreads();  // step j's tiles have landed, from every thread

    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    product_tf32<kKW, pitch_f32<D>(), pitch_f32<kKW>()>(
        s, sQ + c * kKW, st, warp * 16, g, t);

    if (c == kSteps - 1) {
      // scale, bias and masks (selects, no branch); the tile's row max
      const float* sb = st + L::kK + L::kV;
      const int k_left = p.Tk - k0;  // keys of this tile inside Tk
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, col = (i >> 2) * 8 + 2 * t + (i & 1);
        const int row = q0 + r0 + 8 * hh;
        const float bv = bias_mode == 2
            ? sb[(r0 + 8 * hh) * kF32BiasPitch + col]
            : bias_mode == 1 ? sb[col] : 0.f;
        float x = fmaf(s[i], p.sm_scale, bv);
        x = p.causal && k0 + col > row ? kNegInf : x;
        s[i] = col < k_left ? x : -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[i]);
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
            key0, key1, p.drop, bh, q0 + r0, k0, t);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = (keep >> i) & 1u ? s[i] * p.drop.scale : 0.f;
      }
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      // O += P·V over this CTA's chunk of V
      acc_product_tf32<DC>(o, s, st + L::kK, g, t);
    }
    __syncthreads();  // every warp is done with this stage
    if (j + 2 < n_steps) load_step(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float l_safe[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_safe[hh] = l[hh] == 0.f ? 1.f : l[hh];
    const int row = q0 + r0 + 8 * hh;
    if (t == 0 && oc == 0 && row < p.Tq)
      p.lse[(long long)bh * p.Tq + row] = m[hh] + logf(l_safe[hh]);
  }
  store_rows_f32<DC>(static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh +
                         oc * DC,
                     p.o_st, o, q0 + r0, p.Tq, t, 1.f / l_safe[0],
                     1.f / l_safe[1]);
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
          key0, key1, p.drop, bh, q0 + r0, k0, t);
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

// f32: the bias mode from the bias strides (a row shared by every query
// when the query stride is 0 or there is one query).
template <int D>
cudaError_t launch_f32(FwdParams p, cudaStream_t s) {
  constexpr int DC = hopper::chunk_of<D>();
  using L = F32FwdLayout<D, DC>;
  p.bias_mode = p.bias == nullptr ? 0 : p.b_sq == 0 || p.Tq == 1 ? 1 : 2;
  return launch(flash_fwd_f32_kernel<D, DC>, &configured[D / 64 - 1], p, 128,
                L::smem(p.bias_mode), L::smem(2), s, D / DC);
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
                            unsigned threshold, float drop_scale, int dropout, const int* drop_offsets,
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
                             int dropout, const int* drop_offsets, void* stream) {
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
  flash::set_offsets(p.drop, H, drop_offsets);
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
