// Shared pieces of the cluster walks (intersect.cu, intersect_super.cu,
// intersect_fused.cu): the ray record, the staging of one packed cluster into
// shared memory, the plane + barycentric ray-triangle test, the block-wide
// reductions, and the four walks themselves as __device__ functions.
// intersect_stats.cu instantiates the closest-hit walk with a counter and
// without its early exit.
//
// A walk takes its tile's list, entries and count by pointer and value, so
// the list may live in global memory (the cull ran in PyTorch: kernels A, B,
// D, E) or in shared memory (the block culled for itself: kernels F, G, H,
// I). Hits, ties and early exits are the same code either way.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // rays per block (the ray-order tile)
constexpr int CLUSTER = 128;  // triangles per cluster
constexpr int COMP = 12;      // packed components per triangle
constexpr int SUPER = 16;        // child clusters per supercluster
constexpr int BOUNDS_ROWS = 7;   // min xyz, max xyz, live
constexpr float DET_EPS = 1e-10f;
constexpr float BIG = 1e30f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmax, far;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int B, int r) {
  Ray q;
  q.ox = rays[0 * (size_t)B + r];
  q.oy = rays[1 * (size_t)B + r];
  q.oz = rays[2 * (size_t)B + r];
  q.dx = rays[3 * (size_t)B + r];
  q.dy = rays[4 * (size_t)B + r];
  q.dz = rays[5 * (size_t)B + r];
  q.tmax = rays[6 * (size_t)B + r];
  q.far = rays[7 * (size_t)B + r];
  return q;
}

// IEEE 1 / d with |d| floored at 1e-12: the reciprocal of the cull and of the
// child refinement (ops/intersect.py::_safe_inverse).
__device__ __forceinline__ float safe_inverse(float d) {
  const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / safe;
}

// Stage cluster c's packed (12, 128) block into shared memory.
__device__ __forceinline__ void stage_cluster(float* s_tri, const float* __restrict__ tri, int c) {
  const float4* src = reinterpret_cast<const float4*>(tri + (size_t)c * COMP * CLUSTER);
  float4* dst = reinterpret_cast<float4*>(s_tri);
  for (int j = threadIdx.x; j < COMP * CLUSTER / 4; j += TILE) dst[j] = src[j];
}

// The plane + barycentric test of one ray against triangle j of the staged
// cluster, in the operation order of ops/intersect.py::_plane_terms.
// Returns true with t set when the ray meets the triangle's interior.
__device__ __forceinline__ bool tri_test(const float* s, int j, const Ray& q, float& t) {
  const float nx = s[0 * CLUSTER + j], ny = s[1 * CLUSTER + j], nz = s[2 * CLUSTER + j];
  const float dp = s[3 * CLUSTER + j];
  const float det = q.dx * nx + q.dy * ny + q.dz * nz;
  if (!(fabsf(det) > DET_EPS)) return false;
  t = (dp - (q.ox * nx + q.oy * ny + q.oz * nz)) / det;
  const float px = q.ox + t * q.dx;
  const float py = q.oy + t * q.dy;
  const float pz = q.oz + t * q.dz;
  const float u = s[4 * CLUSTER + j] * px + s[5 * CLUSTER + j] * py + s[6 * CLUSTER + j] * pz
                  - s[7 * CLUSTER + j];
  const float v = s[8 * CLUSTER + j] * px + s[9 * CLUSTER + j] * py + s[10 * CLUSTER + j] * pz
                  - s[11 * CLUSTER + j];
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

// Max over the block's 128 threads; ends with every thread holding it. The
// two barriers also fence the staged cluster between iterations.
__device__ __forceinline__ float block_max(float x, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  return fmaxf(fmaxf(s_red[0], s_red[1]), fmaxf(s_red[2], s_red[3]));
}

// OR over the block's 128 threads; ends with every thread holding it.
__device__ __forceinline__ unsigned block_or(unsigned m, unsigned* s_or) {
  m = __reduce_or_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) s_or[threadIdx.x >> 5] = m;
  __syncthreads();
  return s_or[0] | s_or[1] | s_or[2] | s_or[3];
}

// Shared memory of a flat walk, and what the two-level walks add to it.
struct WalkSmem {
  __align__(16) float tri[COMP * CLUSTER];  // the staged cluster, 6 KB
  float red[TILE / 32];
};
struct SuperSmem {
  float b[BOUNDS_ROWS * SUPER];  // the staged child boxes
  unsigned orr[TILE / 32];
};

// The closest-hit walk over a tile's n listed clusters, front to back (kernels
// A and F, and the two instrumented kernels of intersect_stats.cu). Every
// thread of the block calls it; best_t starts at q.tmax and best_i at -1.
// Returns the number of listed clusters the block staged before it stopped
// (the same for every thread; A and F drop it). The exit is tested before
// every cluster, so the number is exact: the first k with entry[k] beyond
// the tile's limit, or n. With EARLY_EXIT false every listed cluster is
// staged and tested: the hits are the same, since a skipped cluster holds no
// closer hit for any ray of the tile.
template <bool EARLY_EXIT = true>
__device__ __forceinline__ int walk_closest(const float* __restrict__ tri, const int* list,
                                            const float* entry, int n, const Ray& q,
                                            float t_min, WalkSmem& sm, float& best_t,
                                            int& best_i) {
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
      if (tri_test(sm.tri, j, q, t) && t > t_min &&
          (t < best_t || (t == best_t && base + j < best_i))) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  return k;
}

// The any-hit walk over a tile's n listed clusters (kernels B and G).
__device__ __forceinline__ bool walk_anyhit(const float* __restrict__ tri, const int* list,
                                            const float* entry, int n, const Ray& q,
                                            float t_min, WalkSmem& sm) {
  const bool dead = q.tmax <= t_min;
  bool blocked = false;
  for (int k = 0; k < n; ++k) {
    // a ray is resolved once blocked, dead, or past its last cluster's exit;
    // the barrier also fences the staged cluster between iterations
    const bool resolved = blocked || dead || (q.far < entry[k]);
    if (__syncthreads_and(resolved)) break;
    const int c = list[k];
    stage_cluster(sm.tri, tri, c);
    __syncthreads();
    if (!blocked) {
      for (int j = 0; j < CLUSTER; ++j) {
        float t;
        if (tri_test(sm.tri, j, q, t) && t > t_min && t < q.tmax) {
          blocked = true;
          break;
        }
      }
    }
  }
  return blocked;
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

// The closest-hit walk over a tile's n listed superclusters with the child
// refinement (kernels D and H).
__device__ __forceinline__ void walk_closest_super(
    const float* __restrict__ tri, const float* __restrict__ bounds, const int* list,
    const float* entry, int n, const Ray& q, float t_min, float refine_rel, float refine_abs,
    WalkSmem& sm, SuperSmem& ss, float& best_t, int& best_i) {
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  for (int k = 0; k < n; ++k) {
    // early exit between superclusters as the flat walk's, inclusive; the
    // reduction's barriers fence ss.b, ss.orr and sm.tri from the last iteration
    const float worst = block_max(fminf(best_t, q.far), sm.red);
    if (!(entry[k] <= worst)) break;
    const int s = list[k];
    stage_bounds(ss.b, bounds, s);
    __syncthreads();
    // a dead ray (tmax <= t_min) asks for no child at all
    const unsigned mine =
        dead ? 0u : refine(ss.b, q, ix, iy, iz, best_t, refine_rel, refine_abs);
    unsigned todo = block_or(mine, ss.orr);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int c = s * SUPER + j;
      __syncthreads();  // the last child's tests are done with sm.tri
      stage_cluster(sm.tri, tri, c);
      __syncthreads();
      if ((mine >> j) & 1u) {
        const int base = c * CLUSTER;
        for (int i = 0; i < CLUSTER; ++i) {
          float t;
          if (tri_test(sm.tri, i, q, t) && t > t_min &&
              (t < best_t || (t == best_t && base + i < best_i))) {
            best_t = t;
            best_i = base + i;
          }
        }
      }
    }
  }
}

// The any-hit walk over a tile's n listed superclusters (kernels E and I).
__device__ __forceinline__ bool walk_anyhit_super(
    const float* __restrict__ tri, const float* __restrict__ bounds, const int* list,
    const float* entry, int n, const Ray& q, float t_min, float refine_rel, float refine_abs,
    WalkSmem& sm, SuperSmem& ss) {
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  bool blocked = false;
  for (int k = 0; k < n; ++k) {
    // resolved as in the flat any-hit walk; the vote's barrier fences ss.b,
    // ss.orr and sm.tri from the last iteration
    const bool resolved = blocked || dead || (q.far < entry[k]);
    if (__syncthreads_and(resolved)) break;
    const int s = list[k];
    stage_bounds(ss.b, bounds, s);
    __syncthreads();
    // blocked and dead rays ask for no child at all
    const unsigned mine =
        (blocked || dead) ? 0u : refine(ss.b, q, ix, iy, iz, q.tmax, refine_rel, refine_abs);
    unsigned todo = block_or(mine, ss.orr);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int c = s * SUPER + j;
      __syncthreads();  // the last child's tests are done with sm.tri
      stage_cluster(sm.tri, tri, c);
      __syncthreads();
      if (!blocked && ((mine >> j) & 1u)) {
        for (int i = 0; i < CLUSTER; ++i) {
          float t;
          if (tri_test(sm.tri, i, q, t) && t > t_min && t < q.tmax) {
            blocked = true;
            break;
          }
        }
      }
    }
  }
  return blocked;
}

}  // namespace
