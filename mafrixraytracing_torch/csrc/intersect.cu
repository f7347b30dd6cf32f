// Closest-hit and any-hit walks over 128-triangle clusters, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_closest_kernel (:356)
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_anyhit_kernel  (:450)
// with the same contract: for each 128-ray tile, walk the tile's cluster
// list (sorted front to back by the cull in ops/intersect.py) and test each
// listed cluster's 128 triangles in the plane + barycentric form that
// `pack_tris` precomputes (12 components per triangle).
//
// Layout. One block per 128-ray tile, one thread per ray. For each listed
// cluster the block stages its 12 x 128 packed components (6 KB) in shared
// memory with coalesced loads; every thread then reads the same component
// at the same time (a shared-memory broadcast, no bank conflicts).
//
// What bounds it on the H100. Each ray-triangle test is ~30 fp32 operations
// on registers against 48 bytes read from shared memory as broadcasts, so
// the walk is bound by fp32 issue rate and by how many clusters a tile must
// visit, not by device memory: a tile reads each cluster once (6 KB) and its
// 128 rays once (4 KB). The design answers that by (1) early exit: after
// each cluster a block reduction takes the max over rays of
// min(best hit, far) and the walk stops once the next cluster's entry
// distance lies beyond it, and (2) sharing each staged cluster across all
// 128 rays of the tile. Warp-level skipping of resolved rays, double
// buffering of the staged cluster and a persistent grid are later work.
//
// Numerics. Built without fast math and with --fmad=false, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// `t` uses IEEE division: kernel and plain version agree bit for bit.
//
// The walk decides ties as the Pallas kernel documents: among equal t the
// smallest triangle index wins, across clusters as well as inside one.
//
// The walks' bodies are the __device__ functions walk_closest and walk_anyhit
// of intersect_common.cuh, which the fused-cull kernels (intersect_fused.cu)
// run on a list in shared memory; here the list is the PyTorch cull's, in
// global memory.

#include "intersect_common.cuh"

namespace {

__global__ void __launch_bounds__(TILE) closest_kernel(
    const float* __restrict__ tri, const int* __restrict__ lists,
    const int* __restrict__ counts, const float* __restrict__ entries,
    const float* __restrict__ rays, int B, int C, float t_min,
    float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ WalkSmem sm;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  float best_t = q.tmax;
  int best_i = -1;
  walk_closest(tri, lists + (size_t)tile * C, entries + (size_t)tile * C, counts[tile], q,
               t_min, sm, best_t, best_i);
  const bool hit = best_t < q.tmax;
  t_out[r] = best_t;
  i_out[r] = hit ? best_i : -1;
}

__global__ void __launch_bounds__(TILE) anyhit_kernel(
    const float* __restrict__ tri, const int* __restrict__ lists,
    const int* __restrict__ counts, const float* __restrict__ entries,
    const float* __restrict__ rays, int B, int C, float t_min,
    uint8_t* __restrict__ occ_out) {
  __shared__ WalkSmem sm;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  const bool blocked = walk_anyhit(tri, lists + (size_t)tile * C, entries + (size_t)tile * C,
                                   counts[tile], q, t_min, sm);
  occ_out[r] = blocked ? 1 : 0;
}

}  // namespace

// C entry points, bound with ctypes. B is a multiple of TILE; tri is
// (C, 12, 128), lists/entries (B / TILE, C), counts (B / TILE,), rays
// (8, B) = [ox oy oz dx dy dz tmax far]. Each returns cudaGetLastError().
extern "C" int mfx_closest(const float* tri, const int* lists, const int* counts,
                           const float* entries, const float* rays, int B, int C,
                           float t_min, float* t_out, int* i_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (tiles > 0)
    closest_kernel<<<tiles, TILE, 0, stream>>>(tri, lists, counts, entries, rays, B, C,
                                                t_min, t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" int mfx_anyhit(const float* tri, const int* lists, const int* counts,
                          const float* entries, const float* rays, int B, int C,
                          float t_min, uint8_t* occ_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (tiles > 0)
    anyhit_kernel<<<tiles, TILE, 0, stream>>>(tri, lists, counts, entries, rays, B, C,
                                               t_min, occ_out);
  return (int)cudaGetLastError();
}
