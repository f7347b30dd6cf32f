// Closest-hit and any-hit walks over 128-triangle clusters, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_closest_kernel (:356)
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_anyhit_kernel  (:450)
// with the same contract: for each 128-ray tile, walk the tile's cluster
// list (sorted front to back by the cull in ops/intersect.py) and test the
// listed clusters' triangles in the plane + barycentric form that
// `pack_tris` precomputes (12 components per triangle): the closest hit in
// (t_min, tmax), the smallest triangle index among equal t (across clusters
// too), or whether any hit lies in (t_min, tmax).
//
// What bounds it on the H100. fp32 operations: ~30 a ray-triangle test, 128
// tests for every (ray, cluster) pair that the answer needs, that is every
// listed cluster whose box the ray enters no later than its final hit
// (closest hit) or before tmax (any hit, one cluster once it is occluded).
// A tile's lists are the union of its rays' boxes, and scattered rays
// (bounces, shadow rays, unrelated rays) share few of them: on a soup of 64
// clusters a tile lists 63 and a ray enters 2-3 before its hit. Bytes are
// small beside that: the rays (32 bytes), the outputs, the triangle table
// (6 KB a cluster) and the cluster boxes (24 bytes a cluster), all
// L2-resident.
//
// The design tests only the pairs the rays ask for. One block a tile. The
// walk keeps the list order and the exit before each cluster (closest hit:
// stop once the cluster's entry lies beyond the max over the tile of
// min(best, far); any hit: once every ray is blocked, dead or past its last
// cluster). For each cluster visited, every live ray tests its own box
// (`box_meets`: the child refinement's slab test of kernels D and E on the
// box grown by a margin, widened by refine_rel and refine_abs; the
// closest-hit walk against the ray's best at the start of the cluster, the
// any-hit walk against tmax) and the block lists the asking rays as four
// warp ballots. A cluster no ray asks for is not tested. The asking rays are
// tested in one of two ways, chosen per visit from what the block counts:
// - few rays against many faces: pair by pair. Thread i holds triangle i of
//   the cluster in registers and tests it against the asking rays, whose
//   records sit in shared memory; a warp reduces its lanes' hits on one ray
//   and one lane lowers the ray's 64-bit key (t's bits in float order above
//   the index) with atomicMin (closest hit) or sets its blocked byte (any
//   hit). A scattered tile (bounces, shadow rays, unrelated rays) asks for
//   a few rays a cluster, which cost a warp step each, not 128 serial tests
//   on one thread while 127 wait.
// - many rays against few faces (2 m > faces + 20: Cornell's one cluster of
//   18 faces, where a warp step of 32 lanes would test 14 of padding): the
//   cluster is staged in shared memory and each asking ray's thread tests
//   the slots that hold a face (the warps' ballots say which), not the 128,
//   and keeps its own key.
// The next listed cluster's triangles are loaded before the current one's
// tests. Two barriers a cluster (three when it is staged). The cluster
// boxes are staged in shared memory once (3.5 KB), the rays once (3.5 KB);
// with the staged cluster (6 KB), 14,400 bytes (A) or 13,504 (B) of static
// shared memory in all.
//
// Numerics. Built without fast math and with --fmad=false, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// `t` uses IEEE division. The box test only culls: a ray asks for every
// cluster that holds a hit it could keep, so the running best and the exits
// are those of the dense plain version, and an integer minimum or an OR does
// not depend on the order of the tests: kernel and plain version agree bit
// for bit. t_min may be negative: the keys order t's bits as floats, and the
// box test then rules nothing out from behind the origin.
//
// The walks' bodies are the __device__ functions walk_closest and walk_anyhit
// of intersect_common.cuh, which the fused-cull kernels (intersect_fused.cu)
// run on a list and boxes in shared memory; here the list is kernel K's (or,
// beyond 128 clusters and on the CPU, the PyTorch cull's), in global memory.

#include "intersect_common.cuh"

namespace {

__global__ void __launch_bounds__(TILE) closest_kernel(
    const float* __restrict__ tri, const float* __restrict__ cmin,
    const float* __restrict__ cmax, const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int C,
    float t_min, float refine_rel, float refine_abs, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  __shared__ ClosestFlatSmem sm;
  __shared__ float box[AABB_ROWS * CP];
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  stage_boxes(box, cmin, cmax, C);
  float best_t;
  int best_i;
  walk_closest(tri, box, lists + (size_t)tile * C, entries + (size_t)tile * C, counts[tile],
               q, t_min, refine_rel, refine_abs, sm, best_t, best_i);
  t_out[r] = best_t;
  i_out[r] = best_i;
}

__global__ void __launch_bounds__(TILE) anyhit_kernel(
    const float* __restrict__ tri, const float* __restrict__ cmin,
    const float* __restrict__ cmax, const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int C,
    float t_min, float refine_rel, float refine_abs, uint8_t* __restrict__ occ_out) {
  __shared__ AnyhitFlatSmem sm;
  __shared__ float box[AABB_ROWS * CP];
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  stage_boxes(box, cmin, cmax, C);
  const bool blocked =
      walk_anyhit(tri, box, lists + (size_t)tile * C, entries + (size_t)tile * C,
                  counts[tile], q, t_min, refine_rel, refine_abs, sm);
  occ_out[r] = blocked ? 1 : 0;
}

}  // namespace

// C entry points, bound with ctypes. B is a multiple of TILE; tri is
// (C, 12, 128) with C <= CP, cmin and cmax the (C, 3) cluster boxes,
// lists/entries (B / TILE, C), counts (B / TILE,), rays
// (8, B) = [ox oy oz dx dy dz tmax far]; refine_rel and refine_abs widen the
// box test's comparisons. Each returns cudaGetLastError().
extern "C" int mfx_closest(const float* tri, const float* cmin, const float* cmax,
                           const int* lists, const int* counts, const float* entries,
                           const float* rays, int B, int C, float t_min, float refine_rel,
                           float refine_abs, float* t_out, int* i_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (C < 0 || C > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    closest_kernel<<<tiles, TILE, 0, stream>>>(tri, cmin, cmax, lists, counts, entries, rays,
                                                B, C, t_min, refine_rel, refine_abs, t_out,
                                                i_out);
  return (int)cudaGetLastError();
}

extern "C" int mfx_anyhit(const float* tri, const float* cmin, const float* cmax,
                          const int* lists, const int* counts, const float* entries,
                          const float* rays, int B, int C, float t_min, float refine_rel,
                          float refine_abs, uint8_t* occ_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (C < 0 || C > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    anyhit_kernel<<<tiles, TILE, 0, stream>>>(tri, cmin, cmax, lists, counts, entries, rays,
                                               B, C, t_min, refine_rel, refine_abs, occ_out);
  return (int)cudaGetLastError();
}
