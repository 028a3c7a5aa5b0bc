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
// Design. One CTA owns a 64-row q tile of one (batch, head) and walks the
// K/V tiles (64 keys each) in a loop, keeping the running max and sum in f32
// registers: the loop takes the place of the TPU grid's sequential K axis.
// q, k, v and out are addressed through (batch, head, token) strides with a
// contiguous head dim, so the packed [B, T, nh·d] layout -- and the q/k/v
// thirds of a fused qkv projection -- are read in place, with no head
// fold/unfold copies. The bias is addressed through four strides (0 on a
// broadcast dim), so the BERT mask [B, 1, Tk] is read per batch rather than
// broadcast over heads in memory. Any Tq and Tk: the ragged tile edge is
// masked in the kernel.
//   bf16: 4 warps, 16 q rows each; q·kᵀ and p·v on the tensor cores through
//         mma.sync m16n8k16 (bf16 in, f32 accumulate). p is rounded to bf16
//         before p·v, as the TPU kernel casts p to v's dtype.
//   f32:  256 threads, a 4x4 register tile each, FMA on the CUDA cores; TF32
//         would lose the f32 parity the tests hold it to.
//
// Bound. The work is 4·B·nh·Tq·Tk·d flops over the bytes of q, k, v, out,
// lse and the bias: about T/2 flops a byte in bf16 (64 at T = 128, 256 at
// T = 512), under the H100's ~295 flop/byte tensor-core ridge, so a perfect
// bf16 kernel is memory bound; in f32 (T/4 flops a byte against a ~20
// flop/byte ridge for 67 TFLOP/s of FMA) it is compute bound. This first
// kernel uses mma.sync, not wgmma/TMA/warp specialisation, so it stays far
// from either roof; its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Score of (row, col) after scale, bias and the masks; -inf past Tk.
template <typename T>
__device__ __forceinline__ float finish_score(const FwdParams& p, float acc,
                                              const T* bias, int row, int col) {
  if (col >= p.Tk) return -INFINITY;
  float s = acc * p.sm_scale;
  if (bias != nullptr && row < p.Tq)
    s += to_float(bias[row * p.b_sq + col * p.b_sk]);
  if (p.causal && col > row) s = kNegInf;
  return s;
}

// Last K tile a q tile needs: causal rows see no key past their own index.
__device__ __forceinline__ int num_k_tiles(const FwdParams& p, int q0) {
  int n = (p.Tk + kBlockK - 1) / kBlockK;
  if (p.causal) {
    int last_row = min(q0 + kBlockQ, p.Tq) - 1;
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
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;

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

  const int n_tiles = num_k_tiles(p, q0);
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
// bf16: tensor cores through mma.sync.m16n8k16.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
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

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(FwdParams p) {
  constexpr int kPadQK = D + 8;          // row pitch (elements) of sQ, sK
  constexpr int kPadVt = kBlockK + 8;    // row pitch of the transposed V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][D+8]
  __nv_bfloat16* sK = sQ + kBlockQ * kPadQK;                         // [64][D+8]
  __nv_bfloat16* sVt = sK + kBlockK * kPadQK;                        // [D][72]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sVt + D * kPadVt);     // [64][68]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // mma group id, thread in group
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* bias = p.bias == nullptr ? nullptr
      : static_cast<const __nv_bfloat16*>(p.bias) + b * p.b_sb + h * p.b_sh;

  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < kBlockQ * kVec; i += 128) {
    int r = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Tq)
      x = *reinterpret_cast<const uint4*>(q + (q0 + r) * p.q_st + c);
    *reinterpret_cast<uint4*>(sQ + r * kPadQK + c) = x;
  }
  __syncthreads();

  // this warp's 16 q rows as mma A fragments, for every 16-wide d step
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + tig * 2;
    qf[ks][0] = ld_u32(sQ + r0 * kPadQK + c);
    qf[ks][1] = ld_u32(sQ + (r0 + 8) * kPadQK + c);
    qf[ks][2] = ld_u32(sQ + r0 * kPadQK + c + 8);
    qf[ks][3] = ld_u32(sQ + (r0 + 8) * kPadQK + c + 8);
  }

  // rows (q0 + r0) and (q0 + r0 + 8): index 0 and 1 below
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  const int rows[2] = {q0 + r0, q0 + r0 + 8};

  const int n_tiles = num_k_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous sK/sVt
    for (int i = tid; i < kBlockK * kVec; i += 128) {
      int r = i / kVec, c = (i % kVec) * 8;
      uint4 xk = make_uint4(0u, 0u, 0u, 0u), xv = xk;
      if (k0 + r < p.Tk) {
        xk = *reinterpret_cast<const uint4*>(k + (k0 + r) * p.k_st + c);
        xv = *reinterpret_cast<const uint4*>(v + (k0 + r) * p.v_st + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kPadQK + c) = xk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * kPadVt + r] = ve[e];
    }
    if (p.drop.on) flash::fill_keep_tile(sKeep, p.drop, bh, q0, k0, tid, 128);
    __syncthreads();

    // S = Q·Kᵀ for 16 rows x 64 keys: 8 n-blocks of 8 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const __nv_bfloat16* krow = sK + (nb * 8 + g) * kPadQK + tig * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_bf16_16816(s[nb], qf[ks], ld_u32(krow + ks * 16),
                       ld_u32(krow + ks * 16 + 8));
    }

    // online softmax; element e of an n-block is row (e / 2), key tig*2+e%2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + tig * 2 + (e & 1);
        s[nb][e] = finish_score(p, s[nb][e], bias, rows[e >> 1], col);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
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
    for (int nb = 0; nb < kBlockK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
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
      for (int nb = 0; nb < kBlockK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row_l = r0 + 8 * (e >> 1), col_l = nb * 8 + tig * 2 + (e & 1);
          s[nb][e] = sKeep[row_l * flash::kKeepPitch + col_l]
                         ? s[nb][e] * p.drop.scale : 0.f;
        }
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb][0] *= corr[0]; o[nb][1] *= corr[0];
      o[nb][2] *= corr[1]; o[nb][3] *= corr[1];
    }

    // O += P·V: the S accumulators of n-blocks 2kk and 2kk+1 are exactly
    // the A fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const __nv_bfloat16* vrow = sVt + (nb * 8 + g) * kPadVt + kk * 16 + tig * 2;
        mma_bf16_16816(o[nb], a, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Tq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = out + rows[r] * p.o_st + tig * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      __nv_bfloat162 val = __floats2bfloat162_rn(o[nb][2 * r] * inv,
                                                 o[nb][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) = val;
    }
    if (tig == 0) p.lse[(long long)bh * p.Tq + rows[r]] = m[r] + logf(l_safe);
  }
}

template <int D>
size_t smem_bytes_f32() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1)) +
         kBlockQ * flash::kKeepPitch;
}

template <int D>
size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * (2 * kBlockQ * (D + 8) + D * (kBlockK + 8)) +
         kBlockQ * flash::kKeepPitch;
}

// Opts a kernel into its dynamic shared memory once per device, then
// launches it on `stream`.
template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned* configured, const FwdParams& p,
                   int threads, size_t smem, cudaStream_t stream) {
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
  dim3 grid((p.Tq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

unsigned configured_f32_64 = 0, configured_f32_128 = 0;
unsigned configured_bf16_64 = 0, configured_bf16_128 = 0;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous. With dropout != 0, `seed` points at one int64 on the device
// and a score is dropped iff its Philox word < `threshold`; kept p is scaled
// by `drop_scale`. Returns a cudaError_t (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, float* lse, int B, int H,
                        int Tq, int Tk, int D, long long q_sb, long long q_sh,
                        long long q_st, long long k_sb, long long k_sh,
                        long long k_st, long long v_sb, long long v_sh,
                        long long v_st, long long o_sb, long long o_sh,
                        long long o_st, long long b_sb, long long b_sh,
                        long long b_sq, long long b_sk, float sm_scale,
                        int causal, int dtype, const long long* seed,
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
  if (dtype == 0 && D == 64)
    return launch(flash_fwd_f32_kernel<64>, &configured_f32_64, p, 256,
                  smem_bytes_f32<64>(), s);
  if (dtype == 0 && D == 128)
    return launch(flash_fwd_f32_kernel<128>, &configured_f32_128, p, 256,
                  smem_bytes_f32<128>(), s);
  if (dtype == 1 && D == 64)
    return launch(flash_fwd_bf16_kernel<64>, &configured_bf16_64, p, 128,
                  smem_bytes_bf16<64>(), s);
  if (dtype == 1 && D == 128)
    return launch(flash_fwd_bf16_kernel<128>, &configured_bf16_128, p, 128,
                  smem_bytes_bf16<128>(), s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
