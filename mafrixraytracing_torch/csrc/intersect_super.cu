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
// Layout. One block per 128-ray tile, one thread per ray, as the flat walks
// in intersect.cu. For each listed supercluster the block stages its 16
// child AABBs and live flags (`pack_bounds`, 7 x 16 floats) in shared
// memory. Every thread slab-tests its own ray against the 16 children with
// its own limit (closest hit: its running best; any hit: tmax, and nothing
// at all once the ray is blocked or dead) into a 16-bit mask. The masks are
// OR-ed across the block (a warp reduction, then four words in shared
// memory). The block then visits the set children in ascending order:
// stages the child's packed triangles (6 KB) and tests them as the flat
// walks do, each thread skipping a child its own mask excludes. Children
// whose live flag is 0 (empty clusters and the slots past the last cluster)
// are never staged, so no read goes past the triangle table.
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
// number of child clusters a tile must visit (each visit is 128 x 128
// ray-triangle tests of ~30 operations on shared-memory broadcasts), not
// device memory. A tile reads its rays once (4 KB), 448 bytes per listed
// supercluster and 6 KB per visited child. 128 threads and 6.6 KB of shared
// memory a block leave occupancy to the register count. The design answers
// the bound by visiting fewer children (refinement against the running
// best, early exit between superclusters, per-thread skipping). Double
// buffering of the staged child with cp.async or TMA is later work.
//
// Numerics and ties as in intersect.cu: no fast math, --fmad=false, among
// equal t the smallest triangle index wins across clusters.

#include "intersect_common.cuh"

namespace {

constexpr int SUPER = 16;        // child clusters per supercluster
constexpr int BOUNDS_ROWS = 7;   // min xyz, max xyz, live
constexpr float BIG = 1e30f;

__device__ __forceinline__ float safe_inverse(float d) {
  const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / safe;
}

// Stage supercluster s's (7, 16) child bounds into shared memory.
__device__ __forceinline__ void stage_bounds(float* s_b, const float* __restrict__ bounds,
                                             int s) {
  const float* src = bounds + (size_t)s * BOUNDS_ROWS * SUPER;
  if (threadIdx.x < BOUNDS_ROWS * SUPER) s_b[threadIdx.x] = src[threadIdx.x];
}

// 16-bit mask of the staged children this ray can meet within `limit`.
__device__ __forceinline__ unsigned refine(const float* s_b, const Ray& q, float ix,
                                           float iy, float iz, float limit,
                                           float refine_rel, float refine_abs) {
  const float lim = limit + (refine_rel * limit + refine_abs);
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < SUPER; ++j) {
    const float x0 = (s_b[0 * SUPER + j] - q.ox) * ix, x1 = (s_b[3 * SUPER + j] - q.ox) * ix;
    const float y0 = (s_b[1 * SUPER + j] - q.oy) * iy, y1 = (s_b[4 * SUPER + j] - q.oy) * iy;
    const float z0 = (s_b[2 * SUPER + j] - q.oz) * iz, z1 = (s_b[5 * SUPER + j] - q.oz) * iz;
    const float tn = fmaxf(fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)), -BIG);
    const float tf = fminf(fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)), BIG);
    const bool live = s_b[6 * SUPER + j] > 0.5f;
    if (live && tn <= tf + (refine_rel * fabsf(tf) + refine_abs) && tf > 0.0f && tn <= lim)
      mask |= 1u << j;
  }
  return mask;
}

// OR over the block's 128 threads; ends with every thread holding it.
__device__ __forceinline__ unsigned block_or(unsigned m, unsigned* s_or) {
  m = __reduce_or_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) s_or[threadIdx.x >> 5] = m;
  __syncthreads();
  return s_or[0] | s_or[1] | s_or[2] | s_or[3];
}

__global__ void __launch_bounds__(TILE) closest_super_kernel(
    const float* __restrict__ tri, const float* __restrict__ bounds,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int S,
    float t_min, float refine_rel, float refine_abs, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  __shared__ __align__(16) float s_tri[COMP * CLUSTER];
  __shared__ float s_b[BOUNDS_ROWS * SUPER];
  __shared__ float s_red[TILE / 32];
  __shared__ unsigned s_or[TILE / 32];
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const int n = counts[tile];
  const int* list = lists + (size_t)tile * S;
  const float* entry = entries + (size_t)tile * S;
  const bool dead = q.tmax <= t_min;

  float best_t = q.tmax;
  int best_i = -1;
  for (int k = 0; k < n; ++k) {
    // early exit between superclusters as the flat walk's, inclusive; the
    // reduction's barriers fence s_b, s_or and s_tri from the last iteration
    const float worst = block_max(fminf(best_t, q.far), s_red);
    if (!(entry[k] <= worst)) break;
    const int s = list[k];
    stage_bounds(s_b, bounds, s);
    __syncthreads();
    // a dead ray (tmax <= t_min) asks for no child at all
    const unsigned mine = dead ? 0u : refine(s_b, q, ix, iy, iz, best_t, refine_rel, refine_abs);
    unsigned todo = block_or(mine, s_or);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int c = s * SUPER + j;
      __syncthreads();  // the last child's tests are done with s_tri
      stage_cluster(s_tri, tri, c);
      __syncthreads();
      if ((mine >> j) & 1u) {
        const int base = c * CLUSTER;
        for (int i = 0; i < CLUSTER; ++i) {
          float t;
          if (tri_test(s_tri, i, q, t) && t > t_min &&
              (t < best_t || (t == best_t && base + i < best_i))) {
            best_t = t;
            best_i = base + i;
          }
        }
      }
    }
  }
  const bool hit = best_t < q.tmax;
  t_out[r] = best_t;
  i_out[r] = hit ? best_i : -1;
}

__global__ void __launch_bounds__(TILE) anyhit_super_kernel(
    const float* __restrict__ tri, const float* __restrict__ bounds,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays, int B, int S,
    float t_min, float refine_rel, float refine_abs, uint8_t* __restrict__ occ_out) {
  __shared__ __align__(16) float s_tri[COMP * CLUSTER];
  __shared__ float s_b[BOUNDS_ROWS * SUPER];
  __shared__ unsigned s_or[TILE / 32];
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  const Ray q = load_ray(rays, B, r);
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const int n = counts[tile];
  const int* list = lists + (size_t)tile * S;
  const float* entry = entries + (size_t)tile * S;
  const bool dead = q.tmax <= t_min;

  bool blocked = false;
  for (int k = 0; k < n; ++k) {
    // resolved as in the flat any-hit walk; the vote's barrier fences s_b,
    // s_or and s_tri from the last iteration
    const bool resolved = blocked || dead || (q.far < entry[k]);
    if (__syncthreads_and(resolved)) break;
    const int s = list[k];
    stage_bounds(s_b, bounds, s);
    __syncthreads();
    // blocked and dead rays ask for no child at all
    const unsigned mine =
        (blocked || dead) ? 0u : refine(s_b, q, ix, iy, iz, q.tmax, refine_rel, refine_abs);
    unsigned todo = block_or(mine, s_or);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int c = s * SUPER + j;
      __syncthreads();  // the last child's tests are done with s_tri
      stage_cluster(s_tri, tri, c);
      __syncthreads();
      if (!blocked && ((mine >> j) & 1u)) {
        for (int i = 0; i < CLUSTER; ++i) {
          float t;
          if (tri_test(s_tri, i, q, t) && t > t_min && t < q.tmax) {
            blocked = true;
            break;
          }
        }
      }
    }
  }
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
