// Gather-unpack of packed attribute rows into SoA columns, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mafrixraytracing_tpu/ops/unpack_pallas.py::_unpack_kernel (:43)
// which turns the gathered (B, 36) attribute rows into 36 flat (B,) columns
// (and its stand-alone form experiments/exp_unpack.py:41, a pure (B, 36) ->
// (36, B) unpack). Here the gather and the transpose are one pass:
//   out[k, i] = table[clamp(idx[i], 0, P - 1), k]   for k < 36, i < B
// into one (36, B) tensor whose rows are the columns.
//
// What bounds it on the H100: bytes. Each output position reads an 8-byte
// index and a 144-byte row and writes 144 bytes; there is no arithmetic. So
// the kernel must read every byte once and write every byte once, both
// coalesced. A thread per (column, position) would read the k-th float of 32
// different rows a warp: 32 sectors for 128 useful bytes, and every sector
// again for each of the 36 columns. The L2 hides that while the table fits in
// its 50 MB (the main path's gather, P = 65,544, 9.4 MB), not when the rows
// stream from device memory (the pure unpack: 9% of the byte bound on an H100).
//
// Design: a transpose through shared memory. One block owns ROWS = 256
// consecutive output positions with 256 threads.
//   1. Each thread reads one index and clamps it.
//   2. The block copies its 256 rows into shared memory: 144 bytes a row are
//      nine 16-byte pieces, neighbouring threads on neighbouring pieces, so a
//      warp reads 512 contiguous bytes when the rows are contiguous (the pure
//      unpack) and whole 16-byte pieces of rows when they are scattered.
//      All nine loads of a thread are in flight before the first store.
//   3. The block writes the 36 column segments out[k, i0 : i0 + 256],
//      neighbouring threads on neighbouring positions: 1 KB a column, one
//      coalesced store a warp. A segment may start at any 4-byte boundary
//      (B need not be a multiple of 4): the stores are 4 bytes wide.
// The shared rows have a stride of 37 floats, so reading column k across the
// 32 rows of a warp touches 32 different banks (37 is odd). 37 KB of static
// shared memory a block.
// The ragged edge: positions past B read no row and write nothing. The
// table's base must be 16-byte aligned (every row is then, at 144 bytes a
// row); the wrapper refuses any other, as the walks refuse an unaligned
// triangle table. Forward only: the backward is the deterministic
// scatter-add kernel of csrc/scatter.cu (ops/unpack.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 36;
constexpr int ROWS = 256;                  // output positions (and threads) a block
constexpr int STRIDE = COLS + 1;           // shared floats a row: odd, no bank conflicts
constexpr int PIECES = COLS / 4;           // 16-byte pieces a row

__global__ void __launch_bounds__(ROWS) unpack_kernel(
    const float* __restrict__ table, const int64_t* __restrict__ idx, int B, int P,
    float* __restrict__ out) {
  __shared__ float s_rows[ROWS * STRIDE];
  __shared__ int s_row[ROWS];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * ROWS;
  const int n = min(ROWS, B - i0);         // positions of this block
  if (t < n) {
    int64_t row = idx[i0 + t];
    s_row[t] = (int)(row < 0 ? 0 : (row >= P ? P - 1 : row));
  }
  __syncthreads();
  // 9 pieces a thread: piece q = m * 256 + t is part q % 9 of row q / 9
  const float4* src = reinterpret_cast<const float4*>(table);
  float4 v[PIECES];
#pragma unroll
  for (int m = 0; m < PIECES; ++m) {
    const int q = m * ROWS + t;
    const int r = q / PIECES;
    if (r < n) v[m] = src[(size_t)s_row[r] * PIECES + (q - r * PIECES)];
  }
#pragma unroll
  for (int m = 0; m < PIECES; ++m) {
    const int q = m * ROWS + t;
    const int r = q / PIECES;
    if (r < n) {
      float* dst = s_rows + r * STRIDE + 4 * (q - r * PIECES);
      dst[0] = v[m].x;
      dst[1] = v[m].y;
      dst[2] = v[m].z;
      dst[3] = v[m].w;
    }
  }
  __syncthreads();
  if (t < n) {
    float* dst = out + i0 + t;
#pragma unroll 4
    for (int k = 0; k < COLS; ++k) dst[(size_t)k * B] = s_rows[t * STRIDE + k];
  }
}

}  // namespace

// C entry point, bound with ctypes: table (P, 36) f32, 16-byte aligned, with
// P >= 1; idx (B,) i64; out (36, B) f32. Returns cudaGetLastError().
extern "C" int mfx_unpack(const float* table, const int64_t* idx, int B, int P, float* out,
                          cudaStream_t stream) {
  if (B > 0 && (P < 1 || reinterpret_cast<uintptr_t>(table) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (B > 0) unpack_kernel<<<(B + ROWS - 1) / ROWS, ROWS, 0, stream>>>(table, idx, B, P, out);
  return (int)cudaGetLastError();
}
