// The instrumented closest-hit walks, for Hopper (sm_90a): a walk with a
// counter of the clusters it stages, and the same walk without its early
// exit.
//
// Replaces the Pallas TPU kernels
//   experiments/exp6.py::_closest_kernel_dbg  (:48)
//   experiments/exp6.py::_closest_kernel_full (:104)
// with the same contract: both return exactly kernel A's (t, idx) on A's
// operands. `closest_dbg_kernel` also writes, per tile, how many of the
// tile's listed clusters the block staged before the early exit stopped it;
// `closest_full_kernel` stages every listed cluster, which is what the walk
// costs without the exit. They are instruments: the walk-profile entry point
// (`mafrixraytracing_torch.profile_walk`) launches them, no render path does.
//
// The walk. These kernels keep the walk that holds a ray a thread
// (`ray_walk_closest` below), which kernel A ran before it became
// pair-parallel: the block stages each listed cluster's 12 x 128 packed
// components (6 KB) in shared memory and every thread tests its own ray
// against all 128 triangles (shared-memory broadcasts), whether or not its
// ray enters the cluster's box. So `walked` keeps the meaning of the TPU
// kernel's counter, the clusters a tile stages before the exit, and the two
// kernels are an independent check of kernel A: another walk, the same
// (t, idx) bit for bit.
//
// The counter. The TPU kernel tests its exit once every four clusters, so its
// count is a multiple of four capped at the list's length. Here the exit is
// tested before every cluster, so the count is exact: walked[tile] is the
// first k whose entry lies beyond the max over the tile's rays of min(best
// hit, far), or the list's length. It is one int32 a tile (the TPU kernel
// repeats it for each of the tile's rays because its outputs are blocked by
// rays).
//
// The bound is A's: both compute A's function, so the least work is A's, and
// the ray-cluster pairs that the full walk stages beyond it are reported
// beside the bound, not inside it. Numerics and ties as A's: no fast math,
// --fmad=false, the same triangle test; among equal t the smallest index.

#include "intersect_common.cuh"

namespace {

// Stage cluster c's packed (12, 128) block into shared memory.
__device__ __forceinline__ void stage_cluster(float* s_tri, const float* __restrict__ tri, int c) {
  const float4* src = reinterpret_cast<const float4*>(tri + (size_t)c * COMP * CLUSTER);
  float4* dst = reinterpret_cast<float4*>(s_tri);
  for (int j = threadIdx.x; j < COMP * CLUSTER / 4; j += TILE) dst[j] = src[j];
}

struct StagedSmem {
  __align__(16) float tri[COMP * CLUSTER];  // the staged cluster, 6 KB
  float red[TILE / 32];
};

// The closest-hit walk that holds a ray a thread, over a tile's n listed
// clusters, front to back. Every thread of the block calls it; best_t starts
// at q.tmax and best_i at -1. Returns the number of listed clusters the
// block staged before it stopped (the same for every thread). The exit is
// tested before every cluster: the first k with entry[k] beyond the tile's
// limit, or n. With EARLY_EXIT false every listed cluster is staged and
// tested: the hits are the same, since a skipped cluster holds no closer hit
// for any ray of the tile.
template <bool EARLY_EXIT>
__device__ __forceinline__ int ray_walk_closest(const float* __restrict__ tri,
                                                const int* list, const float* entry, int n,
                                                const Ray& q, float t_min, StagedSmem& sm,
                                                float& best_t, int& best_i) {
  int k = 0;
  for (; k < n; ++k) {
    if constexpr (EARLY_EXIT) {
      // a later cluster can only help a ray whose limit min(best, far) lies at
      // or beyond its entry; inclusive, or flat clusters are skipped
      const float worst = block_max(fminf(best_t, q.far), sm.red);
      if (!(entry[k] <= worst)) break;
    } else {
      __syncthreads();  // the last cluster's tests are done with sm.tri
    }
    const int c = list[k];
    stage_cluster(sm.tri, tri, c);
    __syncthreads();
    const int base = c * CLUSTER;
    for (int j = 0; j < CLUSTER; ++j) {
      float t;
      if (tri_test(StagedTri{sm.tri, j}, q, t) && t > t_min &&
          (t < best_t || (t == best_t && base + j < best_i))) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  return k;
}

template <bool EARLY_EXIT>
__global__ void __launch_bounds__(TILE) closest_stats_kernel(
    const float* __restrict__ tri, const int* __restrict__ lists,
    const int* __restrict__ counts, const float* __restrict__ entries,
    const float* __restrict__ rays, int B, int stride, float t_min,
    float* __restrict__ t_out, int* __restrict__ i_out, int* __restrict__ walked) {
  __shared__ StagedSmem sm;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  float best_t = q.tmax;
  int best_i = -1;
  const int k = ray_walk_closest<EARLY_EXIT>(tri, lists + (size_t)tile * stride,
                                             entries + (size_t)tile * stride, counts[tile],
                                             q, t_min, sm, best_t, best_i);
  const bool hit = best_t < q.tmax;
  t_out[r] = best_t;
  i_out[r] = hit ? best_i : -1;
  if (walked != nullptr && threadIdx.x == 0) walked[tile] = k;
}

}  // namespace

// C entry points, bound with ctypes. Operands as mfx_closest's less the box
// table: B a multiple of TILE; tri (C, 12, 128), lists/entries (B / TILE, stride), counts
// (B / TILE,), rays (8, B) = [ox oy oz dx dy dz tmax far]; walked (B / TILE,).
// Each returns cudaGetLastError().
extern "C" int mfx_closest_dbg(const float* tri, const int* lists, const int* counts,
                               const float* entries, const float* rays, int B, int stride,
                               float t_min, float* t_out, int* i_out, int* walked,
                               cudaStream_t stream) {
  const int tiles = B / TILE;
  if (tiles > 0)
    closest_stats_kernel<true><<<tiles, TILE, 0, stream>>>(
        tri, lists, counts, entries, rays, B, stride, t_min, t_out, i_out, walked);
  return (int)cudaGetLastError();
}

extern "C" int mfx_closest_full(const float* tri, const int* lists, const int* counts,
                                const float* entries, const float* rays, int B, int stride,
                                float t_min, float* t_out, int* i_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (tiles > 0)
    closest_stats_kernel<false><<<tiles, TILE, 0, stream>>>(
        tri, lists, counts, entries, rays, B, stride, t_min, t_out, i_out, nullptr);
  return (int)cudaGetLastError();
}
