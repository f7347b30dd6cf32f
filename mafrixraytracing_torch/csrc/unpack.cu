// Gather-unpack of packed attribute rows into SoA columns, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mafrixraytracing_tpu/ops/unpack_pallas.py::_unpack_kernel (:43)
// which turns the gathered (B, 36) attribute rows into 36 flat (B,) columns.
// Here the gather and the transpose are one pass:
//   out[k, i] = table[idx[i], k]   for k < 36, i < B
// into one (36, B) tensor whose rows are the columns.
//
// What bounds it on the H100: device-memory writes. Each ray writes 144
// bytes and reads a 4-byte index; the (T + Sp, 36) table is small (18 KB for
// a 128-triangle scene, ~1.2 MB at 8k triangles) and stays in L1/L2, so its
// scattered reads cost little. The design gives one thread to each
// (column, ray) pair with rays along x, so every warp writes 128 contiguous
// bytes of one column, fully coalesced. The index is read once per column
// block and hits L1/L2 after the first. Forward only: the backward is the
// deterministic scatter-add kernel of csrc/scatter.cu (ops/unpack.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 36;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) unpack_kernel(
    const float* __restrict__ table, const int64_t* __restrict__ idx, int B, int P,
    float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= B) return;
  int64_t row = idx[i];
  row = row < 0 ? 0 : (row >= P ? P - 1 : row);
  out[(size_t)k * B + i] = table[row * COLS + k];
}

}  // namespace

// C entry point, bound with ctypes: table (P, 36) f32, idx (B,) i64,
// out (36, B) f32. Returns cudaGetLastError().
extern "C" int mfx_unpack(const float* table, const int64_t* idx, int B, int P, float* out,
                          cudaStream_t stream) {
  if (B > 0) {
    dim3 grid((B + THREADS - 1) / THREADS, COLS);
    unpack_kernel<<<grid, THREADS, 0, stream>>>(table, idx, B, P, out);
  }
  return (int)cudaGetLastError();
}
