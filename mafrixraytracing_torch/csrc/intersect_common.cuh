// Shared pieces of the cluster walks (intersect.cu, intersect_super.cu,
// intersect_fused.cu): the ray record, the staging of one packed cluster into
// shared memory, the plane + barycentric ray-triangle test (one body for a
// triangle in shared memory or in registers), the block-wide reductions, and
// the four walks themselves as __device__ functions. intersect_stats.cu
// instantiates the closest-hit walk with a counter and without its early
// exit. The flat walks (kernels A, B, F, G) hold a ray a thread and test it
// against a staged cluster. The two-level walks (kernels D, E, H, I) are
// pair-parallel: a thread holds a triangle of a child cluster and tests it
// against the rays that ask for that child; the closest-hit one keeps each
// ray's best as a 64-bit integer key in shared memory, lowered by atomicMin.
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

// Triangle j of a cluster staged in shared memory, as its 12 components.
struct StagedTri {
  const float* s;
  int j;
  __device__ __forceinline__ float operator[](int k) const { return s[k * CLUSTER + j]; }
};

// The plane + barycentric test of one ray against one triangle, in the
// operation order of ops/intersect.py::_plane_terms. `c[k]` is the
// triangle's component k: a StagedTri, or a float[12] held in registers (the
// pair walk of walk_anyhit_super). Returns true with t set when the ray meets
// the triangle's interior.
template <class Tri>
__device__ __forceinline__ bool tri_test(const Tri& c, const Ray& q, float& t) {
  const float nx = c[0], ny = c[1], nz = c[2];
  const float dp = c[3];
  const float det = q.dx * nx + q.dy * ny + q.dz * nz;
  if (!(fabsf(det) > DET_EPS)) return false;
  t = (dp - (q.ox * nx + q.oy * ny + q.oz * nz)) / det;
  const float px = q.ox + t * q.dx;
  const float py = q.oy + t * q.dy;
  const float pz = q.oz + t * q.dz;
  const float u = c[4] * px + c[5] * py + c[6] * pz - c[7];
  const float v = c[8] * px + c[9] * py + c[10] * pz - c[11];
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

// The test against triangle j of the staged cluster.
__device__ __forceinline__ bool tri_test(const float* s, int j, const Ray& q, float& t) {
  return tri_test(StagedTri{s, j}, q, t);
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

// Shared memory of a flat walk.
struct WalkSmem {
  __align__(16) float tri[COMP * CLUSTER];  // the staged cluster, 6 KB
  float red[TILE / 32];
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

// --- The pair-parallel two-level walks (kernels D, E, H, I) ---------------
//
// The work of a supercluster's visit scales with the (ray, child) pairs the
// rays ask for, not with the children times 128 serial tests. Per
// supercluster every ray that still asks refines its 16-bit mask of children
// (closest hit: against its best at the start of the supercluster; any hit:
// against tmax); the block lists, for each child, the rays that ask for it (a
// ballot a warp, offsets by popc). Then for each child that some ray asks
// for, thread i holds triangle i of the child in registers and tests it
// against the child's listed rays, whose records sit in shared memory; the
// next child's triangles are loaded before the current one's tests, so the L2
// latency hides behind them. A child one ray asks for costs a test a thread,
// not 128 tests on one thread while 127 wait; a child all 128 rays ask for
// costs what a staged child cost. The rays ask for the same children as in a
// walk that holds a ray a thread (the refinement, the list order and the exit
// between superclusters are unchanged) and make the same tests in the same
// arithmetic, and what a walk keeps of its tests (an OR, a minimum of integer
// keys) does not depend on their order, so each walk equals its plain version
// on every input.

// Shared memory of a pair-parallel walk.
struct PairSmem {
  float ray[7][TILE];                 // the tile's rays: ox oy oz dx dy dz tmax
  float b[BOUNDS_ROWS * SUPER];       // the staged child boxes
  int warp_count[SUPER][TILE / 32];   // per child, the rays each warp lists
  uint8_t list[SUPER][TILE];          // per child, the rays that ask for it
};

// ... of the any-hit walk (kernels E and I)
struct AnyhitSuperSmem : PairSmem {
  uint8_t blocked[TILE];              // 1 once the ray is occluded
};

// ... and of the closest-hit walk (kernels D and H)
struct ClosestSuperSmem : PairSmem {
  unsigned long long key[TILE];       // per ray, its best (t bits << 32 | index)
  float red[TILE / 32];
};

__device__ __forceinline__ void stage_rays(PairSmem& sm, const Ray& q) {
  const int tid = threadIdx.x;
  sm.ray[0][tid] = q.ox;
  sm.ray[1][tid] = q.oy;
  sm.ray[2][tid] = q.oz;
  sm.ray[3][tid] = q.dx;
  sm.ray[4][tid] = q.dy;
  sm.ray[5][tid] = q.dz;
  sm.ray[6][tid] = q.tmax;
}

// Ray r of the tile from shared memory (a broadcast: every lane reads the
// same ray). `far` is not staged: the tests do not read it.
__device__ __forceinline__ Ray listed_ray(const PairSmem& sm, int r) {
  Ray y;
  y.ox = sm.ray[0][r];
  y.oy = sm.ray[1][r];
  y.oz = sm.ray[2][r];
  y.dx = sm.ray[3][r];
  y.dy = sm.ray[4][r];
  y.dz = sm.ray[5][r];
  y.tmax = sm.ray[6][r];
  y.far = 0.0f;
  return y;
}

// The number of rays listed for child j.
__device__ __forceinline__ int listed(const PairSmem& sm, int j) {
  const int* wc = sm.warp_count[j];
  return wc[0] + wc[1] + wc[2] + wc[3];
}

// List, for each child, the threads whose `mine` asks for it, in thread
// order, into sm.list and sm.warp_count; returns the mask of the children
// some thread asks for (the same on every thread). Every thread calls it; it
// ends with a barrier, so the lists may be read at once.
__device__ __forceinline__ unsigned list_children(unsigned mine, PairSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  unsigned ballot[SUPER];
#pragma unroll
  for (int j = 0; j < SUPER; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, (mine >> j) & 1u);
    if (lane == 0) sm.warp_count[j][warp] = __popc(ballot[j]);
  }
  __syncthreads();
  unsigned todo = 0;
#pragma unroll
  for (int j = 0; j < SUPER; ++j) {
    if (listed(sm, j) > 0) todo |= 1u << j;
    if ((mine >> j) & 1u) {
      int at = __popc(ballot[j] & below);
      for (int w = 0; w < warp; ++w) at += sm.warp_count[j][w];
      sm.list[j][at] = (uint8_t)tid;
    }
  }
  __syncthreads();
  return todo;
}

// Triangle `lane` of cluster c into registers: one coalesced 6 KB read of the
// block (the packed (12, 128) layout), straight from the L2-resident table.
__device__ __forceinline__ void load_tri(float (&c)[COMP], const float* __restrict__ tri,
                                         int cl) {
  const float* src = tri + (size_t)cl * COMP * CLUSTER + threadIdx.x;
#pragma unroll
  for (int k = 0; k < COMP; ++k) c[k] = __ldg(src + k * CLUSTER);
}

// visit(cur, j) for each child j of supercluster s in `todo`, in ascending
// order, with `cur` thread i's triangle of the child in registers; the next
// child's triangle is loaded before the current one's visit.
template <class Visit>
__device__ __forceinline__ void visit_children(const float* __restrict__ tri, int s,
                                               unsigned todo, Visit&& visit) {
  if (!todo) return;
  float cur[COMP], next[COMP];
  int j = __ffs(todo) - 1;
  todo &= todo - 1;
  load_tri(cur, tri, s * SUPER + j);
  for (;;) {
    const int jn = todo ? __ffs(todo) - 1 : -1;
    if (jn >= 0) {
      todo &= todo - 1;
      load_tri(next, tri, s * SUPER + jn);
    }
    visit(cur, j);
    if (jn < 0) break;
#pragma unroll
    for (int c = 0; c < COMP; ++c) cur[c] = next[c];
    j = jn;
  }
}

// Thread i's triangle (`c`, triangle i of child j) against the m rays that
// ask for child j. A ray already blocked is skipped; a hit in (t_min, tmax)
// blocks it. Every writer stores 1, so the bytes need no atomics and the
// result does not depend on the order of the tests.
__device__ __forceinline__ void test_listed(const float (&c)[COMP], AnyhitSuperSmem& sm, int j,
                                            int m, float t_min) {
  volatile uint8_t* blocked = sm.blocked;
  for (int p = 0; p < m; ++p) {
    const int r = sm.list[j][p];
    if (blocked[r]) continue;
    const Ray y = listed_ray(sm, r);
    float t;
    if (tri_test(c, y, t) && t > t_min && t < y.tmax) blocked[r] = 1;
  }
}

// Thread i's triangle (`c`, global index `id`) against the m rays that ask
// for child j: each ray's key takes the minimum of (t bits, index) over its
// hits in (t_min, tmax). Every lane of a warp tests the same ray in the same
// step, so the warp reduces first (a ballot; the smallest t bits; among the
// lanes holding them the lowest, whose index is the smallest) and one lane
// makes one 64-bit atomicMin on the ray's key: at most four atomics a (ray,
// child) pair, none where no lane hits. t > t_min >= 0, so the bits of t
// order as unsigned integers; the index breaks ties. Integer minima do not
// depend on the order of the tests.
__device__ __forceinline__ void closest_listed(const float (&c)[COMP], ClosestSuperSmem& sm,
                                               int j, int m, unsigned id, float t_min) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < m; ++p) {
    const int r = sm.list[j][p];
    const Ray y = listed_ray(sm, r);
    float t = 0.0f;
    // strictly below tmax, or the untouched key (tmax, ~0u) would lose its tie
    const bool hit = tri_test(c, y, t) && t > t_min && t < y.tmax;
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (!hits) continue;
    const unsigned tb = hit ? __float_as_uint(t) : 0xffffffffu;
    const unsigned least = __reduce_min_sync(0xffffffffu, tb);
    const unsigned first = __ballot_sync(0xffffffffu, hit && tb == least);
    if (lane == __ffs(first) - 1)
      atomicMin(&sm.key[r], ((unsigned long long)least << 32) | id);
  }
}

// The closest-hit walk over a tile's n listed superclusters (kernels D and
// H), pair-parallel (see above). best_t and best_i come back as kernel A's:
// the closest hit in (t_min, tmax), smallest global index on ties; tmax and
// -1 on a miss. t_min must be >= 0 (the C entry points refuse less).
__device__ __forceinline__ void walk_closest_super(
    const float* __restrict__ tri, const float* __restrict__ bounds, const int* list,
    const float* entry, int n, const Ray& q, float t_min, float refine_rel, float refine_abs,
    ClosestSuperSmem& sm, float& best_t, int& best_i) {
  const int tid = threadIdx.x;
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  stage_rays(sm, q);
  sm.key[tid] = ((unsigned long long)__float_as_uint(q.tmax) << 32) | 0xffffffffu;
  for (int k = 0; k < n; ++k) {
    // the last supercluster's tests are done: the keys are final, the boxes,
    // counts and lists free
    __syncthreads();
    const float best = __uint_as_float((unsigned)(sm.key[tid] >> 32));
    // early exit between superclusters as the flat walk's, inclusive
    const float worst = block_max(fminf(best, q.far), sm.red);
    if (!(entry[k] <= worst)) break;
    const int s = list[k];
    stage_bounds(sm.b, bounds, s);
    __syncthreads();
    // against the best at the start of the supercluster; a dead ray
    // (tmax <= t_min) asks for no child at all
    const unsigned mine =
        dead ? 0u : refine(sm.b, q, ix, iy, iz, best, refine_rel, refine_abs);
    const unsigned todo = list_children(mine, sm);
    visit_children(tri, s, todo, [&](const float (&c)[COMP], int j) {
      closest_listed(c, sm, j, listed(sm, j), (unsigned)((s * SUPER + j) * CLUSTER + tid),
                     t_min);
    });
  }
  __syncthreads();
  const unsigned long long key = sm.key[tid];
  best_t = __uint_as_float((unsigned)(key >> 32));
  best_i = (int)(unsigned)key;   // ~0u, which is -1, on a miss
}

// The any-hit walk over a tile's n listed superclusters (kernels E and I),
// pair-parallel (see above).
__device__ __forceinline__ bool walk_anyhit_super(
    const float* __restrict__ tri, const float* __restrict__ bounds, const int* list,
    const float* entry, int n, const Ray& q, float t_min, float refine_rel, float refine_abs,
    AnyhitSuperSmem& sm) {
  const int tid = threadIdx.x;
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  stage_rays(sm, q);
  sm.blocked[tid] = 0;
  for (int k = 0; k < n; ++k) {
    // the last supercluster's tests are done: the blocked bytes are final,
    // the boxes, counts and lists free
    __syncthreads();
    const bool blocked = sm.blocked[tid] != 0;
    // resolved as in the flat any-hit walk
    const bool resolved = blocked || dead || (q.far < entry[k]);
    if (__syncthreads_and(resolved)) break;
    const int s = list[k];
    stage_bounds(sm.b, bounds, s);
    __syncthreads();
    // blocked and dead rays ask for no child at all
    const unsigned mine =
        (blocked || dead) ? 0u : refine(sm.b, q, ix, iy, iz, q.tmax, refine_rel, refine_abs);
    const unsigned todo = list_children(mine, sm);
    visit_children(tri, s, todo, [&](const float (&c)[COMP], int j) {
      test_listed(c, sm, j, listed(sm, j), t_min);
    });
  }
  __syncthreads();
  return sm.blocked[tid] != 0;
}

}  // namespace
