// Attention dropout for the flash-attention kernels: counter-based
// Philox-4x32-10 (Salmon et al., SC'11; the Random123 rounds and constants).
//
// Replaces the TPU core PRNG of paddle_tpu/ops/pallas_kernels/
// flash_attention.py (_keep_mask, reseeded per logical (b, q-block, k-block)
// through _block_index). Here the keep bit of score (bh, i, j) is a pure
// function of (seed, bh, i, j): word j % 4 of Philox with key (seed mod 2^32,
// seed >> 32) and counter (j / 4, i, bh, 0), where bh, i and j are the
// WHOLE run's indices: a launch over H heads of its own, given the offsets
// (heads_total, head0, row0) by its C entry (set_offsets; kernel
// parameters, so the default path costs a uniform compare), maps its
// (b·H + h, i, j) to (b·heads_total + head0 + h, row0 + i, j). So a
// rank that holds heads head0.. of a model axis, or rows row0.. of a
// sequence axis, draws the bits of the unsharded run; with no offsets
// every bit is the launch's own. The forward kernel, both backward kernels and the plain PyTorch
// versions (ops/kernels/flash_attention.py, dropout_keep_mask) draw the
// same mask whatever their tile sizes. Dropping follows the JAX rule: drop
// iff the word is below round(rate * 2^32); a kept p is scaled by
// 1 / (1 - rate).
//
// Cost: one Philox call gives the bits of 4 scores, so a 64x64 tile takes
// 1024 calls (10 rounds of two 32-bit multiplies each). The flash kernels
// draw them in registers for the lane's own accumulator elements
// (keep_bits_rows / keep_bits_cols).
#pragma once

#include <stdint.h>

namespace flash {

struct Dropout {
  const long long* seed;  // device pointer: drawn on the card, no host sync
  uint32_t threshold;     // drop iff the 32-bit word < threshold
  float scale;            // 1 / (1 - rate)
  int on;
  int heads;              // the launch's head count H
  int heads_total;        // the whole run's head count (H by default)
  int head0, row0;        // the launch's first head and query row

  // the whole run's (b, h) index of the launch's bh = b·H + h
  __device__ __forceinline__ int bh_of(int bh) const {
    return heads_total == heads && head0 == 0
               ? bh
               : (bh / heads) * heads_total + head0 + bh % heads;
  }
};

// The C entries' offsets argument: NULL, or host int[3] = {heads_total (0
// = the launch's H), head0, row0}.
inline void set_offsets(Dropout& d, int heads, const int* offs) {
  d.heads = heads;
  d.heads_total = offs != nullptr && offs[0] > 0 ? offs[0] : heads;
  d.head0 = offs != nullptr ? offs[1] : 0;
  d.row0 = offs != nullptr ? offs[2] : 0;
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Keep bits in registers, for the flash kernels: bit i of the result is the
// keep bit of accumulator register i of a 64x64 block (register 4·nb + 2·h
// + e of lane (g, t) of warp w: row 16w + g + 8h, column 8·nb + 2t + e).
// Each lane runs 8 Philox calls a block, the 1024 calls of the block spread
// over its 128 threads, and takes the words its neighbours drew by
// shuffles: no shared memory, no barrier.

__device__ __forceinline__ uint32_t keep_nibble(const uint4& w, uint32_t t) {
  return (w.x >= t ? 1u : 0u) | (w.y >= t ? 2u : 0u) | (w.z >= t ? 4u : 0u) |
         (w.w >= t ? 8u : 0u);
}

// Rows are queries (row0 = the lane's first query), columns the 64 keys
// from k0 (the launch's indices; the helper adds d's offsets). Lanes t and t^1 hold the same 4-key groups: the even lane draws
// them for row0, the odd one for row0 + 8, and they swap.
__device__ __forceinline__ uint32_t keep_bits_rows(uint32_t key0,
                                                   uint32_t key1,
                                                   const Dropout& d, int bh,
                                                   int row0, int k0, int t) {
  const uint32_t thr = d.threshold;
  bh = d.bh_of(bh);
  row0 += d.row0;
  const int par = t & 1;
  uint32_t mine = 0;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const uint4 w = philox4x32_10(
        static_cast<uint32_t>((k0 >> 2) + 2 * nb + (t >> 1)),
        static_cast<uint32_t>(row0 + 8 * par), static_cast<uint32_t>(bh), 0u,
        key0, key1);
    mine |= keep_nibble(w, thr) << (4 * nb);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  // words 2·par and 2·par + 1 of each nibble are this lane's two columns;
  // row half 0 keeps them at bits 4·nb + {0, 1}, row half 1 at + {2, 3}
  const uint32_t h0 = par ? other : mine, h1 = par ? mine : other;
  return ((h0 >> (2 * par)) & 0x33333333u) |
         (((h1 >> (2 * par)) & 0x33333333u) << 2);
}

// Rows are keys (row0 = the lane's first key, k0 + 16w + g), columns the 64
// queries from q0. The four lanes g = 4a..4a+3 of one t hold the four keys
// of a group: lane m = g % 4 draws the groups of row half m / 2 for the
// column parity m % 2, and each takes word g % 4 of the others'.
__device__ __forceinline__ uint32_t keep_bits_cols(uint32_t key0,
                                                   uint32_t key1,
                                                   const Dropout& d, int bh,
                                                   int row0, int q0,
                                                   int lane) {
  const uint32_t thr = d.threshold;
  bh = d.bh_of(bh);
  q0 += d.row0;
  const int g = lane >> 2, t = lane & 3, m = g & 3;
  const int h = m >> 1, e = m & 1;
  uint32_t mine = 0;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const uint4 w = philox4x32_10(
        static_cast<uint32_t>((row0 - m + 8 * h) >> 2),
        static_cast<uint32_t>(q0 + 8 * nb + 2 * t + e),
        static_cast<uint32_t>(bh), 0u, key0, key1);
    mine |= keep_nibble(w, thr) << (4 * nb);
  }
  // lane j of the four drew register 2·h + e of every n-block; this lane's
  // key is word m of each nibble
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t from =
        __shfl_sync(0xffffffffu, mine, (lane & ~12) | (j << 2));
    bits |= ((from >> m) & 0x11111111u) << j;
  }
  return bits;
}

}  // namespace flash
