// Two-level closest-hit and any-hit walks over superclusters, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_closest_super_kernel (:964)
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_anyhit_super_kernel  (:1028)
// with the same contract. A tile's list holds SUPERclusters (16 consecutive
// clusters each), sorted front to back by the cull in ops/intersect.py. The
// result is the closest hit (any hit, for the second kernel) over all
// triangles of all live children of the listed superclusters.
//
// Layout. One block per 128-ray tile. For each listed supercluster the block
// stages its 16 child AABBs and live flags (`pack_bounds`, 7 x 16 floats) in
// shared memory, and every thread slab-tests its own ray against the 16
// children with its own limit (closest hit: its best at the start of the
// supercluster; any hit: tmax, and nothing at all once the ray is blocked or
// dead) into a 16-bit mask. Both walks are then pair-parallel: the block
// lists, for each child, the rays whose mask asks for it; for each listed
// child, thread i holds triangle i in registers and tests it against the
// listed rays, so a visit costs the (ray, child) pairs asked for, not 128
// serial tests a child while the lanes whose ray did not ask wait. Scattered
// rays (bounce and shadow rays) make tiles whose rays ask for few children
// each but many in all.
// Closest hit (D): each ray's best is a 64-bit key in shared memory, the
// bits of t in the order of the floats (`key_bits`) above the triangle
// index; a warp reduces its lanes' hits on one ray and one lane lowers the
// key with atomicMin (`closest_pair`, shared with the flat walks). The minimum of integer keys does not depend
// on the order of the tests, so the smallest index still wins a tie.
// Any hit (E): a hit sets the ray's blocked byte; a blocked ray is skipped.
// walk_closest_super and walk_anyhit_super in intersect_common.cuh have the
// details.
// Children whose live flag is 0 (empty clusters and the slots past the last
// cluster) are never read, so no read goes past the triangle table.
//
// The refinement is only a cull. Its reciprocal is the IEEE 1 / d of the
// cull in ops/intersect.py (`refine_children` there states the same test in
// plain PyTorch), and its two inclusive comparisons (entry <= exit, entry <=
// limit) are widened by a few ulp (refine_rel, refine_abs: launch arguments,
// defined once in ops/intersect.py beside `refine_children`), so that rounding
// at a flat or axis-aligned child, where entry == exit == limit, cannot drop
// a child whose triangle the dense plain version finds. The triangle test
// itself is exact against the running best, so the widening costs only
// visits, never a wrong hit.
//
// What bounds it on the H100. As the flat walks: fp32 issue rate times the
// ray-triangle tests (~30 operations each) the walk makes, not device
// memory. A tile reads its rays once (4 KB), 448 bytes per listed
// supercluster and 6 KB per visited child, all L2-resident. The walks answer
// the bound by testing fewer pairs (refinement against the best at the start
// of a supercluster, early exit between superclusters, only the pairs a ray
// asks for), and load the next child's triangles into registers while they
// test the current one's. 128 threads a block and 6.4 KB (E) or 7.2 KB (D)
// of static shared memory leave occupancy to the register count.
//
// Numerics and ties as in intersect.cu: no fast math, --fmad=false, among
// equal t the smallest triangle index wins across clusters. t_min may be
// negative, as there: the keys order t's bits as floats, the refinement then
// rules nothing out from behind the origin, and the exits read the cull's
// entries and far only when t_min >= 0.
//
// The walks' bodies are the __device__ functions walk_closest_super and
// walk_anyhit_super of intersect_common.cuh, shared with the fused-cull
// kernels of intersect_fused.cu.

#include "intersect_common.cuh"

namespace {

__global__ void __launch_bounds__(TILE) closest_super_kernel(
    const float* __restrict__ tri, const float* __restrict__ bounds,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int S,
    float t_min, float refine_rel, float refine_abs, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  __shared__ ClosestSuperSmem sm;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  float best_t;
  int best_i;
  walk_closest_super(tri, bounds, lists + (size_t)tile * S, entries + (size_t)tile * S,
                     counts[tile], q, t_min, refine_rel, refine_abs, sm, best_t, best_i);
  t_out[r] = best_t;
  i_out[r] = best_i;
}

__global__ void __launch_bounds__(TILE) anyhit_super_kernel(
    const float* __restrict__ tri, const float* __restrict__ bounds,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int S,
    float t_min, float refine_rel, float refine_abs, uint8_t* __restrict__ occ_out) {
  __shared__ AnyhitSuperSmem sm;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  const bool blocked =
      walk_anyhit_super(tri, bounds, lists + (size_t)tile * S, entries + (size_t)tile * S,
                        counts[tile], q, t_min, refine_rel, refine_abs, sm);
  occ_out[r] = blocked ? 1 : 0;
}

}  // namespace

// C entry points, bound with ctypes. B is a multiple of TILE; tri is
// (C, 12, 128) with C <= S * 16, bounds (S, 7, 16), lists/entries
// (B / TILE, S), counts (B / TILE,), rays (8, B) = [ox oy oz dx dy dz tmax
// far]; refine_rel and refine_abs widen the child refinement's comparisons.
// Each returns cudaGetLastError().
extern "C" int mfx_closest_super(const float* tri, const float* bounds, const int* lists,
                                 const int* counts, const float* entries, const float* rays,
                                 int B, int C, int S, float t_min, float refine_rel,
                                 float refine_abs, float* t_out, int* i_out,
                                 cudaStream_t stream) {
  const int tiles = B / TILE;
  if (C > S * SUPER) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    closest_super_kernel<<<tiles, TILE, 0, stream>>>(tri, bounds, lists, counts, entries, rays,
                                                      B, S, t_min, refine_rel, refine_abs,
                                                      t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" int mfx_anyhit_super(const float* tri, const float* bounds, const int* lists,
                                const int* counts, const float* entries, const float* rays,
                                int B, int C, int S, float t_min, float refine_rel,
                                float refine_abs, uint8_t* occ_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (C > S * SUPER) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    anyhit_super_kernel<<<tiles, TILE, 0, stream>>>(tri, bounds, lists, counts, entries, rays,
                                                     B, S, t_min, refine_rel, refine_abs,
                                                     occ_out);
  return (int)cudaGetLastError();
}
