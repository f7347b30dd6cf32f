// The port's counter-based RNG as two kernels, for Hopper (sm_90a): JAX's
// threefry2x32 `fold_in` and `uniform` (partitionable threefry), one launch a
// public draw of core/rng.py.
//
// The JAX package has no kernel here: XLA fuses its threefry into the
// surrounding program. The port's plain version (core/rng.py::threefry2x32,
// _fold_in, _uniforms) runs the cipher as int64 tensor operations with a mask
// after each add, some 170 launches a hash, each streaming int64 tensors of
// the whole batch; a draw of `uniforms` is two hashes and a bit-cast. Here a
// thread keeps the two words and the three key words in registers for all 20
// rounds, in uint32 arithmetic (wrap-around is the mask), the rotations by
// `__funnelshift_l`, and reads and writes each key once, as one 16-byte pair.
//
// threefry_fold_kernel: out[k, d] = fold_in(keys[k * key_step], x) over a
// (K, D) grid, x = data[k * data_k + d * data_d], or start + k * data_k +
// d * data_d where there is no data (a counter range, or one scalar with both
// steps 0). Each steps 0 or 1, so the grid holds every broadcast the callers
// use without a copy: one key against D data (pixel_keys, split, fold_in of
// pixel ids), K keys against one datum (bounce_key, split_dim), K keys
// against D sample indices (the (K, D) outer product of sample_key), and K
// keys against K data. fold_in(key, x) = threefry2x32(key, (0, x mod 2^32)).
//
// threefry_uniform_kernel: out[b, j] for j < n = the float of the xor of the
// two words of threefry2x32(fold_in(keys[b], dim), (0, j)): 23 bits under the
// exponent of 1.0, bit-cast, minus 1.0f, which is exact for a number in
// [1, 2). One thread a key: one fold and n hashes.
//
// What bounds them on the H100: at the main path's sizes (2^19 keys, n <= 3)
// a fold reads 16 and writes 16 bytes a key, and a hash is ~75 integer
// operations; both kernels sit within a few microseconds of either bound. The
// cost they remove is the host's: one launch a draw instead of hundreds. The
// index math is 32-bit where the grid fits, a grid-stride loop covers any
// batch, and nothing depends on the block size, so every output is the plain
// version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;      // the grid-stride loop covers the rest

// one block of four rounds with rotations r0..r3
#define MFX_ROUNDS(r0, r1, r2, r3)                      \
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;     \
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;     \
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;     \
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;

// threefry2x32, 20 rounds, as JAX's `_threefry2x32_lowering`
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  MFX_ROUNDS(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  MFX_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  MFX_ROUNDS(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  MFX_ROUNDS(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  MFX_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
}

#undef MFX_ROUNDS

__device__ __forceinline__ int64_t grid_start() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_step() { return (int64_t)gridDim.x * blockDim.x; }

__global__ void __launch_bounds__(THREADS) threefry_fold_kernel(
    const longlong2* __restrict__ keys, int64_t key_step, const int64_t* __restrict__ data,
    int64_t data_k, int64_t data_d, int64_t start, int64_t K, int64_t D,
    longlong2* __restrict__ out) {
  const int64_t n = K * D;
  const bool narrow = n <= 0xFFFFFFFFll;
  for (int64_t i = grid_start(); i < n; i += grid_step()) {
    const int64_t k = D == 1 ? i : narrow ? (int64_t)((uint32_t)i / (uint32_t)D) : i / D;
    const int64_t d = i - k * D;
    const longlong2 key = keys[k * key_step];
    const int64_t j = k * data_k + d * data_d;
    uint32_t x0 = 0u, x1 = (uint32_t)(data != nullptr ? data[j] : start + j);
    threefry2x32((uint32_t)key.x, (uint32_t)key.y, x0, x1);
    out[i] = make_longlong2((long long)x0, (long long)x1);
  }
}

__global__ void __launch_bounds__(THREADS) threefry_uniform_kernel(
    const longlong2* __restrict__ keys, uint32_t dim, int64_t n, int64_t B,
    float* __restrict__ out) {
  for (int64_t b = grid_start(); b < B; b += grid_step()) {
    const longlong2 key = keys[b];
    uint32_t k0 = 0u, k1 = dim;
    threefry2x32((uint32_t)key.x, (uint32_t)key.y, k0, k1);
    for (int64_t j = 0; j < n; ++j) {
      uint32_t x0 = 0u, x1 = (uint32_t)j;
      threefry2x32(k0, k1, x0, x1);
      out[b * n + j] = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
    }
  }
}

int blocks_for(int64_t work) {
  const int64_t b = (work + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// C entry points, bound with ctypes. Keys are int64 (rows, 2) holding uint32
// words, 16-byte aligned, rows 16 bytes apart; only their low 32 bits count,
// as data counts mod 2^32. Each returns cudaGetLastError().
//
// keys (K or 1, 2); key_step 1, or 0 for one key over all K; data null or
// int64 with every index k * data_k + d * data_d in range; out (K, D, 2).
extern "C" int mfx_rng_fold(const int64_t* keys, int64_t key_step, const int64_t* data,
                            int64_t data_k, int64_t data_d, int64_t start, int64_t K,
                            int64_t D, int64_t* out, cudaStream_t stream) {
  if (K < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (K == 0 || D == 0) return (int)cudaGetLastError();
  if (!aligned(keys) || !aligned(out)) return (int)cudaErrorInvalidValue;
  threefry_fold_kernel<<<blocks_for(K * D), THREADS, 0, stream>>>(
      reinterpret_cast<const longlong2*>(keys), key_step, data, data_k, data_d, start, K, D,
      reinterpret_cast<longlong2*>(out));
  return (int)cudaGetLastError();
}

// keys (B, 2); dim taken mod 2^32; out (B, n) float32.
extern "C" int mfx_rng_uniform(const int64_t* keys, int64_t dim, int64_t n, int64_t B,
                               float* out, cudaStream_t stream) {
  if (B < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  if (!aligned(keys)) return (int)cudaErrorInvalidValue;
  threefry_uniform_kernel<<<blocks_for(B), THREADS, 0, stream>>>(
      reinterpret_cast<const longlong2*>(keys), (uint32_t)dim, n, B, out);
  return (int)cudaGetLastError();
}
