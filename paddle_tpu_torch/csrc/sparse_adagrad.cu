// Packed-row sparse Adagrad and whole-row gather / scatter for Hopper
// (sm_90a), on tables of packed rows: [V, lanes] 16-bit words, each f32
// value bit-split into two neighbouring words (low half first, as
// ops/deferred_rows.pack_rows lays it out), so a row of 128 lanes is 256
// contiguous bytes holding up to 64 f32 values.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/sparse_adagrad.py:
//   sparse_adagrad_update <- _kernel (via fused_adagrad_update): for each
//                            unique touched row, read [param(vis) | G(vis)]
//                            as f32, G += u*u, p -= lr*u/(sqrt(G)+eps),
//                            write the row back in place with its spare
//                            lanes (from 4*vis on) zeroed. A uid outside
//                            [0, V) (SENTINEL among them) touches nothing.
//   sparse_row_gather     <- _copy_row_kernel (via fused_row_gather):
//                            out[i] = table[slots[i]].
//   sparse_row_scatter    <- _scatter_row_kernel (via fused_row_scatter):
//                            table[slots[i]] = rows[src[i]], in place.
// The row kernels clamp an out-of-range slot into [0, V) and src into
// [0, n_rows), as the TPU kernels' index maps clamp theirs.
//
// Design. On the TPU each grid step DMAs one 256-byte row into VMEM and the
// table is aliased in -> out; sentinel tail slots are pinned to the last
// valid row so Pallas flushes every output block exactly once. Here every
// slot is independent: uids are unique, so no two warps write one row, a
// sentinel slot returns at once, and the rows-kernels' padded duplicate
// tail rewrites identical bytes. The table is updated in place through its
// pointer; the wrapper returns the same tensor.
//   sparse_adagrad_update: one warp per slot; lane k < vis updates the k-th
//     (param, G) pair, and the lanes together zero the row's spare f32
//     words. The update is written with __fmul_rn / __fadd_rn / __fsub_rn /
//     __fdiv_rn / __fsqrt_rn so that nvcc cannot contract it into FMAs:
//     the result is bit for bit that of the plain PyTorch version, which
//     rounds after every operation.
//   sparse_row_gather / sparse_row_scatter: one thread per 16-byte vector
//     of a row (16 threads cover a 256-byte row), so a warp moves two whole
//     rows with 16-byte loads and stores.
//
// Bound. All three do a handful of flops per row and are bound by the bytes
// they move: the adagrad update reads the slot's id, its summed gradient
// (4*vis bytes) and the row's payload, and writes the whole row; the row
// kernels read and write one row per slot. A row is 256 bytes, so random
// rows cost whole 32-byte sectors and nothing is wasted on them. These first
// versions issue no prefetch beyond what the warps in flight give; their
// times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kSentinel = 2147483647LL;  // ops/deferred_rows.SENTINEL
constexpr int kThreads = 256;

__global__ void adagrad_kernel(float* __restrict__ table,
                               const long long* __restrict__ uids,
                               const float* __restrict__ utot,
                               const float* __restrict__ lr_ptr, long long R,
                               long long V, int row_words, int vis,
                               float eps) {
  const long long slot =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (slot >= R) return;
  const long long id = uids[slot];
  if (id == kSentinel || id < 0 || id >= V) return;
  float* row = table + id * row_words;
  if (lane < vis) {
    const float lr = *lr_ptr;
    const float u = utot[slot * vis + lane];
    const float p = row[lane];
    const float g = row[vis + lane];
    const float g_new = __fadd_rn(g, __fmul_rn(u, u));
    const float step =
        __fdiv_rn(__fmul_rn(lr, u), __fadd_rn(__fsqrt_rn(g_new), eps));
    row[lane] = __fsub_rn(p, step);
    row[vis + lane] = g_new;
  }
  for (int w = 2 * vis + lane; w < row_words; w += 32) row[w] = 0.0f;
}

__global__ void gather_kernel(const uint4* __restrict__ table,
                              const long long* __restrict__ slots,
                              uint4* __restrict__ out, long long n,
                              long long V, int nvec) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * nvec) return;
  const long long i = t / nvec;
  const int v = (int)(t - i * nvec);
  long long s = slots[i];
  s = s < 0 ? 0 : (s >= V ? V - 1 : s);
  out[t] = table[s * nvec + v];
}

__global__ void scatter_kernel(uint4* __restrict__ table,
                               const long long* __restrict__ slots,
                               const uint4* __restrict__ rows,
                               const long long* __restrict__ src, long long n,
                               long long n_rows, long long V, int nvec) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * nvec) return;
  const long long i = t / nvec;
  const int v = (int)(t - i * nvec);
  long long s = slots[i];
  s = s < 0 ? 0 : (s >= V ? V - 1 : s);
  long long r = src[i];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  table[s * nvec + v] = rows[r * nvec + v];
}

unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// table: [V, lanes] 16-bit words (lanes even, 4*vis <= lanes), updated in
// place; uids: [R] int64, unique, SENTINEL where unused; utot: [R, vis] f32;
// lr: one f32 on the device. Returns a cudaError_t (0 = launched).
int sparse_adagrad_update(void* table, const long long* uids,
                          const float* utot, const float* lr, long long R,
                          long long V, int lanes, int vis, float eps,
                          void* stream) {
  if (R == 0) return cudaSuccess;
  adagrad_kernel<<<blocks_for(R * 32), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), uids, utot, lr, R, V, lanes / 2, vis, eps);
  return cudaGetLastError();
}

// out[i] = table[slots[i]] for i < n; rows of lanes 16-bit words, lanes a
// multiple of 8 (whole 16-byte vectors).
int sparse_row_gather(const void* table, const long long* slots, void* out,
                      long long n, long long V, int lanes, void* stream) {
  const int nvec = lanes / 8;
  if (n == 0) return cudaSuccess;
  gather_kernel<<<blocks_for(n * nvec), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), slots, static_cast<uint4*>(out), n, V,
      nvec);
  return cudaGetLastError();
}

// table[slots[i]] = rows[src[i]] for i < n, in place; rows holds n_rows
// rows. The slots of the distinct prefix are unique; a padded tail repeats
// the last (slot, src).
int sparse_row_scatter(void* table, const long long* slots, const void* rows,
                       const long long* src, long long n, long long n_rows,
                       long long V, int lanes, void* stream) {
  const int nvec = lanes / 8;
  if (n == 0) return cudaSuccess;
  scatter_kernel<<<blocks_for(n * nvec), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(table), slots, static_cast<const uint4*>(rows), src,
      n, n_rows, V, nvec);
  return cudaGetLastError();
}

const char* sparse_adagrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
