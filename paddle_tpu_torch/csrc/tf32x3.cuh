// f32 products on Hopper's tensor cores in 3xTF32, shared by the f32 flash
// forwards and backwards (flash_attention_fwd.cu, flash_attention_bwd.cu,
// flash_attention_sparse.cu, flash_attention_wide.cu) and the f32 1x1-conv
// GEMM with statistics (K4, fused_bn.cu).
//
// One TF32 product keeps ~11 bits and breaks the f32 parity (2e-5), and FMA
// on the CUDA cores is bound by its shared-memory operand reads at under
// half of the 67 TFLOP/s. So every f32 product runs on the tensor cores in
// 3xTF32, as CUTLASS's fast-f32 GEMMs do: each f32 operand is split into
// big = x rounded to TF32 and small = x − big, and big·small + small·big,
// then big·big, are summed (f32 accumulate): the error of an f32 product,
// at three times TF32's work. No cvt: the split is integer and FP32 work.
// The flash kernels multiply with mma.sync.m16n8k8, whose B fragments can
// be read from a tile as it lies whichever way the product runs; K4, whose
// operands are both K-major, with wgmma (the last section).
//
// The tensor core rounds each of its sums toward zero: an error of up to an
// ulp of the running sum per instruction, which piles up along a product's
// depth. So products sum into zeroed partial sums that one round-to-nearest
// add puts into their accumulator: along a long depth every kPartialDepth
// columns, an output of a flash tile once a tile (the CPU model
// paddle_tpu_torch/ops/kernels/tf32x3.py emulates both, and the tests hold
// the kernels' designs within a quarter of the f32 parity with it).
//
// Fragments. mma.sync.m16n8k8 (tf32) reads A (16 x 8) as lane (g, t) =
// (lane / 4, lane % 4) holding rows g, g + 8 at depths t, t + 4 (so does
// wgmma, a warp's 16 rows, from registers), and B (8 x 8) as depths t,
// t + 4 of column g; its accumulator holds rows g, g + 8 at columns 2t,
// 2t + 1. An operand stored a row per M or N index
// with the depth contiguous (K-major) is read by ldmatrix: one 8 x 4-float
// block a matrix, lane i holding word i % 4 of row i / 4, which is the
// fragment layout. Tiles are f32 with a row pitch of 4 (mod 32) floats, so
// ldmatrix's 8 rows and the paired reads below hit 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

constexpr int kRows = 64;      // rows of a flash tile
constexpr int kThreads = 128;  // threads of a flash CTA (four warps)
constexpr int kPartialDepth = 16;

// Row pitch, in floats, of an f32 tile W values wide: 4 floats of padding
// put ldmatrix's rows and the fragment reads of a warp on 32 distinct banks.
template <int W>
__host__ __device__ constexpr int pitch_f32() {
  return W + 4;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  cp_async16(hopper::smem_u32(dst), src, valid);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of a 64-row tile of W columns of a [T, D] f32 matrix (row
// stride `st`) into shared memory with pitch_f32<W>(), by the 128 threads of
// a flash CTA; rows past `valid` are zero-filled.
template <int W>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long st, int valid, int tid) {
  constexpr int kVec = W / 4, kPitch = pitch_f32<W>();
#pragma unroll
  for (int i = tid; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    cp_async16(dst + r * kPitch + c, src + (r < valid ? r : 0) * st + c,
               r < valid);
  }
}

// x = big + small: big is x rounded to TF32 (nearest, ties away, as
// cvt.rna rounds, but on the integer pipe: cvt runs at a sixteenth of the
// FP32 rate), small = x − big exactly; the tensor core reads small's top 11
// bits, so big + small carries x to within 2^-21·|x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
template <int N>
__device__ __forceinline__ void split_all(const uint32_t (&x)[N],
                                          uint32_t (&big)[N],
                                          uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// Four 8 x 4-float blocks by ldmatrix; lane i gives the address of row
// i % 8 of block i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(row)));
}

// The A fragment of rows r0..r0 + 15 at depths k..k + 7 of a K-major tile
// with pitch P, split.
__device__ __forceinline__ void ldsm_a(const float* s, int P, int r0, int k,
                                       int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  uint32_t x[4];
  ldsm_x4(x, s + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * P + k +
                 4 * (lane >> 4));
  split_all(x, big, small);
}

// The B fragments of two 8-column blocks at depths k..k + 7 of a K-major
// tile with pitch P (a row per output column), split: registers 0-1 are
// block 0's, 2-3 block 1's. `row` is the tile row of this lane's column:
// (row of column lane % 8 of block lane / 16).
__device__ __forceinline__ void ldsm_b2(const float* s, int P, int row, int k,
                                        int lane, uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  uint32_t x[4];
  ldsm_x4(x, s + row * P + k + 4 * ((lane >> 3) & 1));
  split_all(x, big, small);
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b on one 16x8 block, 8 deep, in 3xTF32: the two cross terms
// first, then big·big, as CUTLASS's fast-f32 warp MMA sums them
// (small·small, ~2^-22 relative, is dropped). b = (b0, b1) of the block.
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bb0, bb1);
}

// The A fragment of 16x8 block kb of an accumulator, with the depth
// permuted: slot t is depth 8kb + 2t and slot t + 4 depth 8kb + 2t + 1, so
// the accumulator's registers (columns 2t, 2t + 1) are the A fragment as
// they stand. A product sums the same terms in any order of its depth; the
// B operand (acc_product_tf32) is read with the same permutation.
__device__ __forceinline__ void frag_a_acc(const float (&acc)[32], int kb,
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split_tf32(acc[4 * kb], big[0], small[0]);
  split_tf32(acc[4 * kb + 2], big[1], small[1]);
  split_tf32(acc[4 * kb + 1], big[2], small[2]);
  split_tf32(acc[4 * kb + 3], big[3], small[3]);
}

// s += A·Bᵀ for the warp's 16 rows (from r0) of a 64-row block, over the W
// columns of two tiles stored a row per M and N index (pitches PA, PB),
// kPartialDepth columns at a time into partial sums. Register 4·nb + 2h + e
// of lane (g, t) is row r0 + g + 8h, column 8·nb + 2t + e.
template <int W, int PA = pitch_f32<W>(), int PB = pitch_f32<W>()>
__device__ __forceinline__ void product_tf32(float (&s)[32], const float* sA,
                                             const float* sB, int r0, int g,
                                             int t) {
  const int lane = 4 * g + t;
  const int brow = (lane & 7) + 8 * (lane >> 4);  // column of two blocks
#pragma unroll 1
  for (int k0 = 0; k0 < W; k0 += kPartialDepth) {
    float ps[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) ps[i] = 0.f;
#pragma unroll
    for (int k = k0; k < k0 + kPartialDepth; k += 8) {
      uint32_t ab[4], as[4];
      ldsm_a(sA, PA, r0, k, lane, ab, as);
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t bb[4], bs[4];
        ldsm_b2(sB, PB, 8 * nb + brow, k, lane, bb, bs);
        mma3(&ps[4 * nb], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma3(&ps[4 * nb + 4], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += ps[i];
  }
}

// o += A·B for the warp's 16 rows: A the 16x64 accumulator `a` (depth = its
// 64 columns), B a 64-row tile of W columns stored a row per depth (pitch
// P, pitch_f32<W>() unless given); 64 output columns at a time, each into a
// partial sum first. The output columns are paired: blocks 2j and 2j + 1 of
// o are columns 16j + 2c and 16j + 2c + 1 (c = the block's column), so a
// lane reads each B pair with one 8-byte load and holds four adjacent
// columns of each of its rows: register 4·nb + 2h + e of lane (g, t) is row
// g + 8h, column 16·(nb / 2) + 4t + 2e + nb % 2 (store_rows_f32).
template <int W, int P = pitch_f32<W>()>
__device__ __forceinline__ void acc_product_tf32(float (&o)[W / 2],
                                                 const float (&a)[32],
                                                 const float* sB, int g,
                                                 int t) {
#pragma unroll
  for (int n0 = 0; n0 < W / 8; n0 += 8) {
    float po[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) po[i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      uint32_t ab[4], as[4];
      frag_a_acc(a, kb, ab, as);
      const float* x = sB + (8 * kb + 2 * t) * P + 8 * n0 + 2 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 lo = *reinterpret_cast<const float2*>(x + 16 * j);
        const float2 hi = *reinterpret_cast<const float2*>(x + 16 * j + P);
        uint32_t bb[4], bs[4];
        split_tf32(lo.x, bb[0], bs[0]);
        split_tf32(hi.x, bb[1], bs[1]);
        split_tf32(lo.y, bb[2], bs[2]);
        split_tf32(hi.y, bb[3], bs[3]);
        mma3(&po[8 * j], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma3(&po[8 * j + 4], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[4 * n0 + i] += po[i];
  }
}

// Stores a warp's 16 x W f32 accumulator of acc_product_tf32 as rows row0
// (times scale0) and row0 + 8 (times scale1) of a [T, D] matrix whose rows
// start on the 16-byte grid, in 16-byte vectors, skipping rows past `limit`.
template <int W>
__device__ __forceinline__ void store_rows_f32(float* dst, long long st,
                                               const float (&acc)[W / 2],
                                               int row0, int limit, int t,
                                               float scale0, float scale1) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const float sc = hh ? scale1 : scale0;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < W / 16; ++j) {
      const float* a = acc + 8 * j + 2 * hh;
      *reinterpret_cast<float4*>(dst + row * st + 16 * j + 4 * t) =
          make_float4(a[0] * sc, a[4] * sc, a[1] * sc, a[5] * sc);
    }
  }
}

// wgmma (warpgroup) form, for K-major operands on both sides: D (m64 x 64
// f32, 32 registers a thread, the layout of hopper.cuh's accumulators) +=
// A·B over one 8-deep step, A from registers (mma.m16n8k8's A fragment of
// the warp's 16 rows), B through a descriptor of a 128-byte-swizzled
// [64][32] tf32 box (hopper::desc_kmajor: step ks starts 32·(ks % 4)
// bytes into box ks / 4); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// wgmma.wait_group N: at most N committed groups still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Byte offset of the 16-byte chunk c4 (4 tf32 values) of row r of a
// 128-byte-swizzled [rows][32] tf32 box, as wgmma reads it.
__device__ __forceinline__ uint32_t swz_tf32(int r, int c4) {
  return r * 128 + (((c4 ^ r) & 7) << 4);
}

}  // namespace tf32x3
