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
// of a segment is taken in an order the inputs alone fix, written out as a
// plain version in ops/unpack.py::scatter_rows_ordered_reference:
//
//   pass 1  one block per CHUNK = 256 consecutive sorted positions. A thread
//           owns a position and keeps its K values in registers (read as
//           float4 where the values of a ray are 16-byte aligned rows). A
//           segmented inclusive scan over the chunk, 8 doubling steps that
//           never cross a segment's start, leaves the sum of each run at its
//           last position. Steps d = 1..16 run in registers with shuffles:
//           lane l < d needs position j - d of the previous warp, so each
//           warp also carries that warp's values (read once from shared
//           memory) through steps 1..8, which is all that lane l < d reads.
//           Steps 32, 64, 128 go through shared memory: 7 barriers in all.
//           A run that is a whole segment is written to out; a run cut by
//           the chunk's edge goes to part (slot 0: the segment began in an
//           earlier chunk; slot 1: it began here and goes on). The chunk's
//           last thread writes span[chunk]: the row whose segment begins in
//           the chunk and goes on, or -1.
//   pass 2  one warp per (spanning row, column), taken by a grid-stride loop
//           over (chunk, column) that skips chunks whose span is -1: lane l
//           adds the partials of chunks c0 + l, c0 + l + 32, ... in
//           ascending order from 0.0 (8 loads issued before their adds),
//           then a fixed shuffle tree (16, 8, 4, 2, 1) adds the 32 lanes.
//           part is (2, K, chunks), so a warp's loads are coalesced.
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
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

template <int K, bool VEC>
__device__ __forceinline__ void load_values(const float* __restrict__ ct, int64_t stride_k,
                                            int64_t stride_i, int64_t src, float (&acc)[K]) {
  if constexpr (VEC) {
    const float4* row = reinterpret_cast<const float4*>(ct + src * stride_i);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 v = row[q];
      acc[4 * q] = v.x;
      acc[4 * q + 1] = v.y;
      acc[4 * q + 2] = v.z;
      acc[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = ct[k * stride_k + src * stride_i];
  }
}

template <int K, bool VEC>
__global__ void __launch_bounds__(CHUNK) scatter_chunk_kernel(
    const float* __restrict__ ct, int64_t stride_k, int64_t stride_i,
    const int32_t* __restrict__ sorted_idx, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ starts, int B, int chunks, float* __restrict__ out,
    float* __restrict__ part, int32_t* __restrict__ span) {
  __shared__ float vals[K * CHUNK];
  __shared__ int run_starts[CHUNK];
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int64_t base = (int64_t)blockIdx.x * CHUNK;
  const int64_t pos = base + j;
  const bool live = pos < B;
  int64_t p = 0, seg_start = 0;
  int run_start = j;  // a dead position never adds
  float acc[K];
  if (live) {
    p = sorted_idx[pos];
    load_values<K, VEC>(ct, stride_k, stride_i, perm[pos], acc);
    seg_start = starts[p];
    const int64_t s = seg_start - base;
    run_start = s > 0 ? (int)s : 0;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) vals[k * CHUNK + j] = acc[k];
  run_starts[j] = run_start;
  __syncthreads();
  // segmented inclusive scan: after the step with distance d, acc covers the
  // positions [max(run_start, j - 2 d + 1), j]. Steps d < 32 in registers;
  // prev is the same lane's position in the previous warp (jp), advanced
  // through steps 1..8 with its own run start: at step d lane l < d reads
  // lane l - d + 32 of it, whose window never reaches further back than that
  // warp.
  const int jp = j - 32;
  const int prev_start = j >= 32 ? run_starts[jp] : 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float own = acc[k];
    float prev = j >= 32 ? vals[k * CHUNK + jp] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      // lane s offers own to lane s + d and prev to lane s + d - 32
      const float from = __shfl_sync(FULL, lane < 32 - d ? own : prev, (lane - d) & 31);
      if (d < 16) {
        const float prev_from = __shfl_up_sync(FULL, prev, d);
        if (lane >= d && jp - d >= prev_start) prev += prev_from;
      }
      if (j - d >= run_start) own += from;
    }
    acc[k] = own;
  }
  __syncthreads();  // every warp has read the values of the previous one
#pragma unroll
  for (int d = 32; d < CHUNK; d <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) vals[k * CHUNK + j] = acc[k];
    __syncthreads();
    if (j - d >= run_start) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += vals[k * CHUNK + j - d];
    }
    if (d < CHUNK / 2) __syncthreads();
  }
  if (!live) return;
  const int64_t seg_end = starts[p + 1];
  const int64_t chunk_end = base + CHUNK < (int64_t)B ? base + CHUNK : (int64_t)B;
  const bool head = seg_start < base;     // the segment began in an earlier chunk
  const bool cut = seg_end > chunk_end;   // and/or goes on in a later one
  if (pos + 1 == chunk_end) span[blockIdx.x] = (!head && cut) ? (int32_t)p : -1;
  if (pos + 1 != seg_end && pos + 1 != chunk_end) return;  // not a run's last
  if (!head && !cut) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[p * K + k] = acc[k];
  } else {
    float* dst = part + (int64_t)(head ? 0 : K) * chunks + blockIdx.x;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[(int64_t)k * chunks] = acc[k];
  }
}

// One warp per (chunk c0, column k) item of a grid-stride loop; only items
// whose chunk begins a spanning segment work.
__global__ void __launch_bounds__(COMBINE_THREADS) scatter_combine_kernel(
    const int32_t* __restrict__ span, const int64_t* __restrict__ starts,
    const float* __restrict__ part, int chunks, int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (COMBINE_THREADS / 32);
  const int64_t items = (int64_t)chunks * K;
  for (int64_t item = (int64_t)blockIdx.x * (COMBINE_THREADS / 32) + (threadIdx.x >> 5);
       item < items; item += warps) {
    const int64_t c0 = item / K;
    const int k = (int)(item - c0 * K);
    const int64_t p = span[c0];
    if (p < 0) continue;
    const int64_t c1 = (starts[p + 1] - 1) / CHUNK;
    const float* later = part + (int64_t)k * chunks;          // slot 0
    const float* first = part + (int64_t)(K + k) * chunks;    // slot 1
    float acc = 0.0f;
    for (int64_t c = c0 + lane; c <= c1; c += 32 * COMBINE_UNROLL) {
      float v[COMBINE_UNROLL];
#pragma unroll
      for (int u = 0; u < COMBINE_UNROLL; ++u) {
        const int64_t cc = c + 32 * u;
        v[u] = cc <= c1 ? (cc == c0 ? first[cc] : later[cc]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < COMBINE_UNROLL; ++u)
        if (c + 32 * u <= c1) acc += v[u];
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
    if (lane == 0) out[p * K + k] = acc;
  }
}

template <int K>
void launch_chunks(const float* ct, int64_t stride_k, int64_t stride_i,
                   const int32_t* sorted_idx, const int64_t* perm, const int64_t* starts, int B,
                   float* out, float* part, int32_t* span, cudaStream_t stream) {
  const int chunks = (B + CHUNK - 1) / CHUNK;
  const bool vec = K % 4 == 0 && stride_k == 1 && stride_i % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(ct) & 15) == 0;
  if (vec)
    scatter_chunk_kernel<K, K % 4 == 0><<<chunks, CHUNK, 0, stream>>>(
        ct, stride_k, stride_i, sorted_idx, perm, starts, B, chunks, out, part, span);
  else
    scatter_chunk_kernel<K, false><<<chunks, CHUNK, 0, stream>>>(
        ct, stride_k, stride_i, sorted_idx, perm, starts, B, chunks, out, part, span);
}

}  // namespace

// C entry point, bound with ctypes. ct: K x B f32 values read at
// ct[k * stride_k + i * stride_i]; sorted_idx (B,) i32 ascending in [0, P);
// perm (B,) i64, the ray of each sorted position; starts (P + 1,) i64;
// out (P, K) f32, zero on entry; part (2, K, ceil(B / 256)) f32 and span
// (ceil(B / 256),) i32 scratch. passes: 1 runs pass 1, 2 pass 2 (on what
// pass 1 wrote), 3 both. K must be 1, 3, 16 or 36 (returns
// cudaErrorInvalidValue otherwise). Returns cudaGetLastError().
extern "C" int mfx_scatter(const float* ct, int64_t stride_k, int64_t stride_i,
                           const int32_t* sorted_idx, const int64_t* perm,
                           const int64_t* starts, int B, int P, int K, float* out, float* part,
                           int32_t* span, int passes, cudaStream_t stream) {
  if (K != 1 && K != 3 && K != 16 && K != 36) return (int)cudaErrorInvalidValue;
  if (B <= 0 || P <= 0) return (int)cudaGetLastError();
  if (passes & 1) {
    switch (K) {
      case 1: launch_chunks<1>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, span, stream); break;
      case 3: launch_chunks<3>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, span, stream); break;
      case 16: launch_chunks<16>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, span, stream); break;
      default: launch_chunks<36>(ct, stride_k, stride_i, sorted_idx, perm, starts, B, out, part, span, stream); break;
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int chunks = (B + CHUNK - 1) / CHUNK;
  if ((passes & 2) && chunks > 1) {
    const int64_t blocks = ((int64_t)chunks * K + COMBINE_THREADS / 32 - 1) / (COMBINE_THREADS / 32);
    scatter_combine_kernel<<<(int)(blocks < 2048 ? blocks : 2048), COMBINE_THREADS, 0, stream>>>(
        span, starts, part, chunks, K, out);
  }
  return (int)cudaGetLastError();
}
