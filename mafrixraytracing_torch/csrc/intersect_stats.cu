// The instrumented closest-hit walks, for Hopper (sm_90a): kernel A's walk
// with a counter of the clusters it reaches, and kernel A's walk with its
// early exit off.
//
// Replaces the Pallas TPU kernels
//   experiments/exp6.py::_closest_kernel_dbg  (:48)
//   experiments/exp6.py::_closest_kernel_full (:104)
// with the same contract: both return exactly kernel A's (t, idx) on A's
// operands, at any t_min. `closest_dbg_kernel` also writes, per tile, how
// many of the tile's listed clusters the walk reached before its early exit
// stopped it; `closest_full_kernel` reaches every listed cluster. They are
// instruments: the walk-profile entry point (`mafrixraytracing_torch.
// profile_walk`) launches them, no render path does.
//
// The walk. Both kernels run A's own pair-parallel walk, `walk_closest` of
// intersect_common.cuh (one block a tile, the cluster boxes staged once, each
// live ray's box test before each listed cluster, only the asking rays
// tested), instantiated with the exit on (the counting walk, which is A's
// walk as it is) or off (the walk without early exit). So what they measure
// is the walk that the search runs: the counting walk's time is A's, and the
// full walk's time less it is exactly what A's exit saves. The full walk
// still skips, by the rays' box tests, the clusters no ray asks for; what it
// adds is the clusters past the exit. Its (t, idx) are A's: a cluster past
// the exit holds no closer hit for any ray of the tile.
//
// The counter. The TPU kernel tests its exit once every four clusters, so its
// count is a multiple of four capped at the list's length. Here the exit is
// tested before every cluster, so the count is exact: walked[tile] is the
// first k whose entry lies beyond the max over the tile's rays of min(best
// hit, far), or the list's length. The best at cluster k is the closest hit
// over the first k listed clusters, as in a walk that tests every pair: a
// pair that the box test skips holds no hit closer than the ray's best. With
// t_min < 0 (or NaN) the exit is off, as A's is (the cull's entries and far
// bound only the hits ahead of the origin), and walked is the count. It is
// one int32 a tile (the TPU kernel repeats it for each of the tile's rays
// because its outputs are blocked by rays).
//
// The bound is A's: both compute A's function on A's operands, so the least
// work is A's, and the ray-cluster pairs that the full walk reaches beyond
// it are reported beside the bound, not inside it. Numerics and ties are A's
// (the same code): no fast math, --fmad=false; among equal t the smallest
// index.

#include "intersect_common.cuh"

namespace {

template <bool EARLY_EXIT>
__global__ void __launch_bounds__(TILE) closest_stats_kernel(
    const float* __restrict__ tri, const float* __restrict__ cmin,
    const float* __restrict__ cmax, const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int C,
    float t_min, float refine_rel, float refine_abs, float* __restrict__ t_out,
    int* __restrict__ i_out, int* __restrict__ walked) {
  __shared__ ClosestFlatSmem sm;
  __shared__ float box[AABB_ROWS * CP];
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  stage_boxes(box, cmin, cmax, C);
  float best_t;
  int best_i;
  const int k = walk_closest<EARLY_EXIT>(tri, box, lists + (size_t)tile * C,
                                         entries + (size_t)tile * C, counts[tile], q, t_min,
                                         refine_rel, refine_abs, sm, best_t, best_i);
  t_out[r] = best_t;
  i_out[r] = best_i;
  if (walked != nullptr && threadIdx.x == 0) walked[tile] = k;
}

}  // namespace

// C entry points, bound with ctypes. Operands as mfx_closest's: B a multiple
// of TILE; tri (C, 12, 128) with C <= CP, cmin and cmax the (C, 3) cluster
// boxes, lists/entries (B / TILE, C), counts (B / TILE,), rays (8, B) =
// [ox oy oz dx dy dz tmax far]; walked (B / TILE,). Each returns
// cudaGetLastError().
extern "C" int mfx_closest_dbg(const float* tri, const float* cmin, const float* cmax,
                               const int* lists, const int* counts, const float* entries,
                               const float* rays, int B, int C, float t_min, float refine_rel,
                               float refine_abs, float* t_out, int* i_out, int* walked,
                               cudaStream_t stream) {
  const int tiles = B / TILE;
  if (C < 0 || C > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    closest_stats_kernel<true><<<tiles, TILE, 0, stream>>>(
        tri, cmin, cmax, lists, counts, entries, rays, B, C, t_min, refine_rel, refine_abs,
        t_out, i_out, walked);
  return (int)cudaGetLastError();
}

extern "C" int mfx_closest_full(const float* tri, const float* cmin, const float* cmax,
                                const int* lists, const int* counts, const float* entries,
                                const float* rays, int B, int C, float t_min, float refine_rel,
                                float refine_abs, float* t_out, int* i_out,
                                cudaStream_t stream) {
  const int tiles = B / TILE;
  if (C < 0 || C > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    closest_stats_kernel<false><<<tiles, TILE, 0, stream>>>(
        tri, cmin, cmax, lists, counts, entries, rays, B, C, t_min, refine_rel, refine_abs,
        t_out, i_out, nullptr);
  return (int)cudaGetLastError();
}
