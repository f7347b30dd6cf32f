// Deterministic scatter-add of cotangent rows into a table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   experiments/exp_scatter.py::_scatter_kernel (:52)
// which computes the backward of the packed attribute fetch
// (mafrixraytracing_tpu/ops/unpack_pallas.py::_fetch_bwd, :89-97):
//   out[p, k] = sum over { i : idx[i] == p } of ct[k, i]     k < K, p < P
// The cotangents arrive as columns (K, B), so the pack of columns into rows is
// part of the sum: no (B, K) intermediate is made. The same function with
// K = 16 and K = 3 is the backward of the light-row and vertex gathers
// (ops/unpack.py::gather_rows).
//
// The TPU kernel is one core walking the rows in order with an accumulator
// that lives across its sequential grid. Here blocks run in no order, and the
// result must not depend on that order: a fit resumed from a checkpoint has to
// repeat the uninterrupted run bit for bit, which float atomics cannot give.
// So there is no atomic on the output. The wrapper sorts the indices (stable,
// so the order within a row is the rays' own) and hands over, for every table
// row p, its segment [starts[p], starts[p + 1]) of sorted positions. The sum
// of a segment is taken in an order the inputs alone fix:
//
//   pass 1  one block per CHUNK = 256 consecutive sorted positions. A thread
//           owns a position and keeps its K values in registers; a segmented
//           inclusive scan over the chunk (8 doubling steps through shared
//           memory, never across a segment's start) leaves the sum of each
//           run at its last position. A run that is a whole segment is
//           written to out; a run cut by the chunk's edge goes to part[chunk]
//           (slot 0: the segment began in an earlier chunk; slot 1: it began
//           here and goes on).
//   pass 2  one warp per table row whose segment spans several chunks: lane l
//           adds the partials of chunks c0 + l, c0 + l + 32, ... in ascending
//           order, then a fixed shuffle tree adds the 32 lanes.
//
// Rows that nobody gathered keep the zero the wrapper allocated.
//
// What bounds it on the H100: bytes. The function moves (K B + P K) 4 + 8 B
// bytes and does one add per value; the sort and the reads through the
// permutation (for one ray the K values lie B floats apart) are this
// design's own cost on top of that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;

template <int K>
__global__ void __launch_bounds__(CHUNK) scatter_chunk_kernel(
    const float* __restrict__ ct, int64_t stride_k, int64_t stride_i,
    const int32_t* __restrict__ sorted_idx, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ starts, int B, float* __restrict__ out,
    float* __restrict__ part) {
  __shared__ float vals[K * CHUNK];
  const int j = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * CHUNK;
  const int64_t pos = base + j;
  const bool live = pos < B;
  int64_t p = 0;
  int run_start = j;
  float acc[K];
  if (live) {
    p = sorted_idx[pos];
    const int64_t src = perm[pos];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = ct[k * stride_k + src * stride_i];
    const int64_t s = starts[p] - base;
    run_start = s > 0 ? (int)s : 0;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  }
  // segmented inclusive scan: after the step with distance d, acc covers the
  // positions [max(run_start, j - 2 d + 1), j]
  for (int d = 1; d < CHUNK; d <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) vals[k * CHUNK + j] = acc[k];
    __syncthreads();
    if (live && j - d >= run_start) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += vals[k * CHUNK + j - d];
    }
    __syncthreads();
  }
  if (!live) return;
  const int64_t seg_end = starts[p + 1];
  const int64_t chunk_end = base + CHUNK < (int64_t)B ? base + CHUNK : (int64_t)B;
  if (pos + 1 != seg_end && pos + 1 != chunk_end) return;  // not a run's last
  const bool head = starts[p] < base;     // the segment began in an earlier chunk
  const bool cut = seg_end > chunk_end;   // and/or goes on in a later one
  float* dst = (!head && !cut) ? out + p * K
                               : part + ((int64_t)blockIdx.x * 2 + (head ? 0 : 1)) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = acc[k];
}

// One warp per table row; only rows whose segment spans several chunks work.
__global__ void __launch_bounds__(128) scatter_combine_kernel(
    const int64_t* __restrict__ starts, const float* __restrict__ part, int P, int K,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;
  const int64_t s = starts[p], e = starts[p + 1];
  if (e <= s) return;
  const int64_t c0 = s / CHUNK, c1 = (e - 1) / CHUNK;
  if (c0 == c1) return;  // pass 1 wrote the whole segment
  for (int k = 0; k < K; ++k) {
    float acc = 0.0f;
    for (int64_t c = c0 + lane; c <= c1; c += 32)
      acc += part[(c * 2 + (c == c0 ? 1 : 0)) * K + k];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[p * K + k] = acc;
  }
}

template <int K>
void launch_chunks(const float* ct, int64_t stride_k, int64_t stride_i,
                   const int32_t* sorted_idx, const int64_t* perm, const int64_t* starts, int B,
                   float* out, float* part, cudaStream_t stream) {
  scatter_chunk_kernel<K><<<(B + CHUNK - 1) / CHUNK, CHUNK, 0, stream>>>(
      ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part);
}

}  // namespace

// C entry point, bound with ctypes. ct: K x B f32 values read at
// ct[k * stride_k + i * stride_i]; sorted_idx (B,) i32 ascending in [0, P);
// perm (B,) i64, the ray of each sorted position; starts (P + 1,) i64;
// out (P, K) f32, zero on entry; part (ceil(B / 256), 2, K) f32 scratch.
// K must be 1, 3, 16 or 36 (returns cudaErrorInvalidValue otherwise).
// Returns cudaGetLastError().
extern "C" int mfx_scatter(const float* ct, int64_t stride_k, int64_t stride_i,
                           const int32_t* sorted_idx, const int64_t* perm,
                           const int64_t* starts, int B, int P, int K, float* out, float* part,
                           cudaStream_t stream) {
  if (B <= 0 || P <= 0) return (int)cudaGetLastError();
  switch (K) {
    case 1: launch_chunks<1>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, stream); break;
    case 3: launch_chunks<3>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, stream); break;
    case 16: launch_chunks<16>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, stream); break;
    case 36: launch_chunks<36>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (B > CHUNK) {
    const int warps = 4;
    scatter_combine_kernel<<<(P + warps - 1) / warps, warps * 32, 0, stream>>>(starts, part, P, K, out);
  }
  return (int)cudaGetLastError();
}
