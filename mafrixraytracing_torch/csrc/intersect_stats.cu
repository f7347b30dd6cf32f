// The instrumented closest-hit walks, for Hopper (sm_90a): kernel A with a
// counter of the clusters it walks, and kernel A without its early exit.
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
// The counter. The TPU kernel tests its exit once every four clusters, so its
// count is a multiple of four capped at the list's length. Here the exit is
// tested before every cluster (walk_closest of intersect_common.cuh), so the
// count is exact: walked[tile] is the first k whose entry lies beyond the
// max over the tile's rays of min(best hit, far), or the list's length. It
// is one int32 a tile (the TPU kernel repeats it for each of the tile's rays
// because its outputs are blocked by rays).
//
// Both kernels are instantiations of the one walk that kernels A and F run,
// so hits, ties and the exit rule cannot drift from A's. Layout, numerics and
// the bound are A's (intersect.cu): both compute A's function, so the least
// work is A's, and the ray-cluster pairs that the full walk stages beyond it
// are reported beside the bound, not inside it.

#include "intersect_common.cuh"

namespace {

template <bool EARLY_EXIT>
__global__ void __launch_bounds__(TILE) closest_stats_kernel(
    const float* __restrict__ tri, const int* __restrict__ lists,
    const int* __restrict__ counts, const float* __restrict__ entries,
    const float* __restrict__ rays, int B, int stride, float t_min,
    float* __restrict__ t_out, int* __restrict__ i_out, int* __restrict__ walked) {
  __shared__ WalkSmem sm;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  float best_t = q.tmax;
  int best_i = -1;
  const int k = walk_closest<EARLY_EXIT>(tri, lists + (size_t)tile * stride,
                                         entries + (size_t)tile * stride, counts[tile], q,
                                         t_min, sm, best_t, best_i);
  const bool hit = best_t < q.tmax;
  t_out[r] = best_t;
  i_out[r] = hit ? best_i : -1;
  if (walked != nullptr && threadIdx.x == 0) walked[tile] = k;
}

}  // namespace

// C entry points, bound with ctypes. Operands as mfx_closest's: B a multiple
// of TILE; tri (C, 12, 128), lists/entries (B / TILE, stride), counts
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
