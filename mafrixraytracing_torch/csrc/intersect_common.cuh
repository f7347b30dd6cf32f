// Shared pieces of the cluster walks (intersect.cu, intersect_super.cu,
// intersect_fused.cu): the ray record, the plane + barycentric ray-triangle
// test, the slab test of one box, the block-wide maximum, and the four walks
// themselves as __device__ functions. All four are pair-parallel: a thread
// holds a triangle of a cluster in registers and tests it against the rays
// of the tile that ask for that cluster, whose records sit in shared memory.
// The closest-hit walks keep each ray's best as a 64-bit integer key in
// shared memory, lowered by atomicMin; the any-hit walks a byte a ray.
// The instrumented kernels (intersect_stats.cu) run the flat closest-hit
// walk as it is, with its exit on or off, and read its count.
//
// A walk takes its tile's list, entries and count by pointer and value, so
// the list may live in global memory (the cull ran before the walk, as
// kernel K or in PyTorch: kernels A, B, D, E) or in shared memory (the block culled for itself: kernels F, G, H,
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
constexpr int CP = 128;          // box slots of the packed table (pack_aabbs)
constexpr int AABB_ROWS = 7;     // rows the kernels read: min xyz, max xyz, live
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
// box test (ops/intersect.py::_safe_inverse).
__device__ __forceinline__ float safe_inverse(float d) {
  const float safe = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / safe;
}

// The plane + barycentric test of one ray against one triangle, in the
// operation order of ops/intersect.py::_plane_terms. `c[k]` is the
// triangle's component k (a float[12] held in registers, or a StagedTri).
// Returns true with t set when the ray meets the triangle's interior.
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

// Triangle j of a cluster staged in shared memory ((12, 128), component
// major), as its 12 components.
struct StagedTri {
  const float* s;
  int j;
  __device__ __forceinline__ float operator[](int k) const { return s[k * CLUSTER + j]; }
};

// Max over the block's 128 threads; ends with every thread holding it. The
// two barriers also fence shared memory between iterations.
__device__ __forceinline__ float block_max(float x, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  return fmaxf(fmaxf(s_red[0], s_red[1]), fmaxf(s_red[2], s_red[3]));
}

// The lower end of the box test's range: a hit needs t > t_min, so a box the
// ray has left by t = 0 can hold one only when t_min < 0, and then no box is
// ruled out from behind.
__device__ __forceinline__ float box_floor(float t_min) {
  return t_min >= 0.0f ? 0.0f : -BIG;
}

// Whether the ray can meet box j within `limit`: one slab test with the
// cull's IEEE reciprocal (ix, iy, iz = safe_inverse of the direction) against
// the box grown by a margin m on every side, then entry <= exit, exit beyond
// `floor` (box_floor) and entry <= limit, both inclusive comparisons widened
// by rel * |x| + abs. `b` holds the rows min xyz, max xyz, live, each
// `stride` floats apart: the child bounds of a supercluster (stride SUPER) or
// the cluster boxes staged in the packed box table's layout (stride CP). The
// plane test's t of a ray that grazes a triangle's plane can err by far more
// than rel * |t| (its numerator cancels at the scale of the coordinates), but
// the point it reports lies within a few roundings of that scale of the
// triangle, so the margin m = rel * (the largest |coordinate| of the origin +
// that of the box) + abs keeps it; the widening keeps a flat or axis-aligned
// box, where entry == exit == a hit's t. ops/intersect.py::refine_children
// states the same test in plain PyTorch.
__device__ __forceinline__ bool box_meets(const float* b, int stride, int j, const Ray& q,
                                          float ix, float iy, float iz, float limit,
                                          float floor, float rel, float abs_) {
  const float lx = b[0 * stride + j], ly = b[1 * stride + j], lz = b[2 * stride + j];
  const float hx = b[3 * stride + j], hy = b[4 * stride + j], hz = b[5 * stride + j];
  // max |coordinate| of a box (lo <= hi) is max over its axes of max(-lo, hi)
  const float scale = fmaxf(fmaxf(fabsf(q.ox), fabsf(q.oy)), fabsf(q.oz)) +
                      fmaxf(fmaxf(fmaxf(-lx, hx), fmaxf(-ly, hy)), fmaxf(-lz, hz));
  const float m = rel * scale + abs_;
  const float x0 = ((lx - m) - q.ox) * ix, x1 = ((hx + m) - q.ox) * ix;
  const float y0 = ((ly - m) - q.oy) * iy, y1 = ((hy + m) - q.oy) * iy;
  const float z0 = ((lz - m) - q.oz) * iz, z1 = ((hz + m) - q.oz) * iz;
  const float tn = fmaxf(fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)), -BIG);
  const float tf = fminf(fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)), BIG);
  const float lim = limit + (rel * fabsf(limit) + abs_);
  const bool live = b[6 * stride + j] > 0.5f;
  return live && tn <= tf + (rel * fabsf(tf) + abs_) && tf > floor && tn <= lim;
}

// Stage supercluster s's (7, 16) child bounds into shared memory.
__device__ __forceinline__ void stage_bounds(float* s_b, const float* __restrict__ bounds,
                                             int s) {
  const float* src = bounds + (size_t)s * BOUNDS_ROWS * SUPER;
  if (threadIdx.x < BOUNDS_ROWS * SUPER) s_b[threadIdx.x] = src[threadIdx.x];
}

// 16-bit mask of the staged children this ray can meet within `limit`.
__device__ __forceinline__ unsigned refine(const float* s_b, const Ray& q, float ix,
                                           float iy, float iz, float limit, float floor,
                                           float refine_rel, float refine_abs) {
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < SUPER; ++j)
    if (box_meets(s_b, SUPER, j, q, ix, iy, iz, limit, floor, refine_rel, refine_abs))
      mask |= 1u << j;
  return mask;
}

// --- Pair-parallel tests ---------------------------------------------------
//
// The work of a visit scales with the (ray, cluster) pairs the rays ask for,
// not with the clusters times 128 serial tests on one thread. A ray asks for
// a cluster when its own box test passes (closest hit: against its best at
// the start of the visit; any hit: against tmax); thread i holds triangle i
// of the cluster in registers and tests it against the asking rays, whose
// records sit in shared memory, while the next cluster's triangles are
// already loading. A cluster one ray asks for costs a test a thread, not 128
// tests on one thread while 127 wait; a cluster all 128 rays ask for costs
// what a staged cluster cost. The box test is only a cull: a ray asks for
// every cluster that holds a hit it could keep, so the running best, and
// with it the early exit, are those of a walk that tests every listed
// cluster, and what a walk keeps of its tests (an OR, a minimum of integer
// keys) does not depend on their order: each walk equals its plain version
// on every input.

// The tile's rays in shared memory: ox oy oz dx dy dz tmax.
struct RaySmem {
  float ray[7][TILE];
};

__device__ __forceinline__ void stage_rays(RaySmem& sm, const Ray& q) {
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
__device__ __forceinline__ Ray listed_ray(const RaySmem& sm, int r) {
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

// Triangle `lane` of cluster c into registers: one coalesced 6 KB read of the
// block (the packed (12, 128) layout), straight from the L2-resident table.
__device__ __forceinline__ void load_tri(float (&c)[COMP], const float* __restrict__ tri,
                                         int cl) {
  const float* src = tri + (size_t)cl * COMP * CLUSTER + threadIdx.x;
#pragma unroll
  for (int k = 0; k < COMP; ++k) c[k] = __ldg(src + k * CLUSTER);
}

// The bits of t as an unsigned integer in the order of the floats: the sign
// bit set for a positive value, every bit flipped for a negative one. It is
// a bijection, so the key of tmax gives tmax back bit for bit.
__device__ __forceinline__ unsigned key_bits(float t) {
  const unsigned b = __float_as_uint(t);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A ray's key before its first hit: (tmax, ~0u), which decodes to t = tmax
// and index -1.
__device__ __forceinline__ unsigned long long miss_key(float tmax) {
  return ((unsigned long long)key_bits(tmax) << 32) | 0xffffffffu;
}

// Thread i's triangle (`c`, global index `id`) against ray y, whose key is
// *key: the key takes the minimum of (t, index) over the hits in (t_min,
// tmax). Every lane of a warp tests the same ray in the same step, so the
// warp reduces first (a ballot; the least key bits; among the lanes holding
// them the lowest, whose index is the smallest) and one lane makes one 64-bit
// atomicMin: at most four atomics a (ray, cluster) pair, none where no lane
// hits. Hits are strictly below tmax, or the untouched key (tmax, ~0u) would
// lose its tie. t + 0 makes a -0 hit +0, so that equal t tie by index as in
// the plain version. Integer minima do not depend on the order of the tests.
__device__ __forceinline__ void closest_pair(const float (&c)[COMP], const Ray& y,
                                             unsigned long long* key, unsigned id,
                                             float t_min) {
  float t = 0.0f;
  const bool hit = tri_test(c, y, t) && t > t_min && t < y.tmax;
  if (!__ballot_sync(0xffffffffu, hit)) return;
  const unsigned tb = hit ? key_bits(t + 0.0f) : 0xffffffffu;
  const unsigned least = __reduce_min_sync(0xffffffffu, tb);
  const unsigned first = __ballot_sync(0xffffffffu, hit && tb == least);
  if ((int)(threadIdx.x & 31) == __ffs(first) - 1)
    atomicMin(key, ((unsigned long long)least << 32) | id);
}

// Thread i's triangle against ray y, whose blocked byte is *blocked. A ray
// already blocked is skipped; a hit in (t_min, tmax) blocks it. Every writer
// stores 1, so the bytes need no atomics and the result does not depend on
// the order of the tests.
__device__ __forceinline__ void anyhit_pair(const float (&c)[COMP], const Ray& y,
                                            volatile uint8_t* blocked, float t_min) {
  if (*blocked) return;
  float t;
  if (tri_test(c, y, t) && t > t_min && t < y.tmax) *blocked = 1;
}

// --- The flat walks (kernels A, B, F, G) -----------------------------------
//
// The tile's list, front to back. Before cluster k the exit: the closest-hit
// walk stops once entry[k] lies beyond the max over the tile's rays of
// min(best, far) (inclusive, or flat clusters are skipped), the any-hit walk
// once every ray is blocked, dead or past its last cluster's exit. The cull's
// entries and far bound the hits ahead of the origin only, so with t_min < 0
// the closest-hit walk visits every listed cluster and the any-hit walk
// stops only once every ray is blocked or dead. Then each live ray tests its
// own box of cluster k (box_meets), the block lists the asking rays as four
// 32-bit ballots and counts the cluster's faces (triangles with a normal:
// the others are padding or mega triangles zeroed by pack_tris, never hit),
// and, unless no ray asks, visits cluster k. A visit tests the asking rays
// against the cluster in one of two ways, the same tests either way:
// - pair by pair (a thread a triangle, the asking rays one after another),
//   which costs a few warp steps for each asking ray; a warp whose 32
//   triangles have no face skips it;
// - a ray a thread: the cluster is staged in shared memory and each asking
//   ray's thread tests it against the cluster's faces (the ballot says
//   which slots hold one), which costs the same for one asking ray as for
//   128, and nothing for a slot without a face.
// The second is taken when the rays that ask are many against the faces:
// 2 m > faces + 20, since a pair step costs about what two faces cost a
// visit that holds a ray a thread, and its staging about what twenty do
// (estimated from both visits' times on an H100). Two barriers a
// cluster, and one more in a visit that stages: one after the last visit's
// tests (the keys or blocked bytes are final, the ballots free), one after
// the ballots. The next listed cluster's triangles are loaded before the
// current one's tests. An empty list costs nothing beyond the outputs.

// Shared memory of a flat walk: the rays, a cluster staged for a visit that
// holds a ray a thread, per warp the ballot of the rays that ask for the
// cluster and the number of its faces, and the exit's per-warp reduction.
struct FlatSmem : RaySmem {
  __align__(16) float tri[COMP * CLUSTER];
  unsigned ask[TILE / 32];
  unsigned faces[TILE / 32];          // per warp, the lanes whose triangle has a face
  unsigned done[TILE / 32];           // any hit: the resolved rays
  float red[TILE / 32];               // closest hit: max of min(best, far)
};

struct ClosestFlatSmem : FlatSmem {
  unsigned long long key[TILE];       // per ray, its best (key_bits(t) << 32 | index)
};

struct AnyhitFlatSmem : FlatSmem {
  uint8_t blocked[TILE];              // 1 once the ray is occluded
};

// Boxes 0..n-1 of the (n, 3) cluster bounds into shared memory in the
// layout of the packed box table's first seven rows (pack_aabbs: min xyz,
// max xyz, live = min x <= max x), which box_meets reads (kernels A and B;
// F and G cull from the same rows staged by tile_cull). The walk's first
// barrier fences them.
__device__ __forceinline__ void stage_boxes(float* s_box, const float* __restrict__ cmin,
                                            const float* __restrict__ cmax, int n) {
  const int tid = threadIdx.x;
  if (tid < n) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_box[a * CP + tid] = cmin[tid * 3 + a];
      s_box[(3 + a) * CP + tid] = cmax[tid * 3 + a];
    }
    s_box[6 * CP + tid] = cmin[tid * 3] <= cmax[tid * 3] ? 1.0f : 0.0f;
  }
}

// Whether thread i's triangle has a face (a non-zero normal).
__device__ __forceinline__ bool has_face(const float (&c)[COMP]) {
  return c[0] != 0.0f || c[1] != 0.0f || c[2] != 0.0f;
}

// What every thread writes after its ballot of the asking rays: lane 0 of
// each warp stores the ballot and the lanes whose triangle (`cur`) has a
// face.
__device__ __forceinline__ void ballot_asks(FlatSmem& sm, bool asks, const float (&cur)[COMP]) {
  const unsigned ask = __ballot_sync(0xffffffffu, asks);
  const unsigned faces = __ballot_sync(0xffffffffu, has_face(cur));
  if ((threadIdx.x & 31) == 0) {
    sm.ask[threadIdx.x >> 5] = ask;
    sm.faces[threadIdx.x >> 5] = faces;
  }
}

__device__ __forceinline__ int bits(const unsigned (&m)[TILE / 32]) {
  return __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
}

// After the ballots' barrier: 0 when no ray asks, 1 for a visit pair by
// pair, 2 for a visit that holds a ray a thread (the rule above).
__device__ __forceinline__ int visit_kind(const FlatSmem& sm) {
  const int m = bits(sm.ask);
  return m == 0 ? 0 : (2 * m > bits(sm.faces) + 20 ? 2 : 1);
}

// Thread i's triangle into the staged cluster; ends with a barrier.
__device__ __forceinline__ void stage_own(FlatSmem& sm, const float (&cur)[COMP]) {
#pragma unroll
  for (int k = 0; k < COMP; ++k) sm.tri[k * CLUSTER + threadIdx.x] = cur[k];
  __syncthreads();
}

// Whether the thread's own ray asked for the visited cluster.
__device__ __forceinline__ bool own_asks(const FlatSmem& sm) {
  return (sm.ask[threadIdx.x >> 5] >> (threadIdx.x & 31)) & 1u;
}

// visit(cur, c, kind) for the clusters list[k] the walk decides to test, in
// list order, with `cur` thread i's triangle of cluster c in registers.
// step(k, c, cur) runs before each cluster on every thread and returns 0 to
// stop the walk, -1 to skip cluster c, or the visit's kind (1, 2); it ends
// with a barrier, so what it wrote may be read at once. The next cluster's
// triangle is loaded before the current one's visit; a cluster skipped costs
// no load of its own.
template <class Step, class Visit>
__device__ __forceinline__ void walk_list(const float* __restrict__ tri, const int* list,
                                          int n, Step&& step, Visit&& visit) {
  float cur[COMP], next[COMP];
  int c = list[0];
  load_tri(cur, tri, c);
  for (int k = 0; k < n; ++k) {
    const int kind = step(k, c, cur);
    if (kind == 0) break;
    const int cn = k + 1 < n ? list[k + 1] : -1;
    if (kind < 0) {
      if (cn >= 0) load_tri(cur, tri, cn);
    } else {
      if (cn >= 0) load_tri(next, tri, cn);
      visit(cur, c, kind);
      if (cn >= 0) {
#pragma unroll
        for (int a = 0; a < COMP; ++a) cur[a] = next[a];
      }
    }
    c = cn;
  }
}

// fn(i) for every i whose bit is set in the four warp masks (the asking
// rays, the faces of a cluster), in ascending order (the same on every
// thread), until fn returns true.
template <class Fn>
__device__ __forceinline__ void for_each_bit(const unsigned (&mask)[TILE / 32], Fn&& fn) {
#pragma unroll
  for (int w = 0; w < TILE / 32; ++w) {
    unsigned m = mask[w];
    while (m) {
      if (fn(w * 32 + __ffs(m) - 1)) return;
      m &= m - 1;
    }
  }
}

// fn(j) for the slots of the visited cluster that hold a face, in ascending
// order, until fn returns true (after the ballots' barrier).
template <class Fn>
__device__ __forceinline__ void for_each_face(const FlatSmem& sm, Fn&& fn) {
  if (bits(sm.faces) == CLUSTER) {   // a full cluster: no mask to read
    for (int j = 0; j < CLUSTER; ++j)
      if (fn(j)) return;
  } else {
    for_each_bit(sm.faces, fn);
  }
}

// The closest-hit walk over a tile's n listed clusters (kernels A and F,
// and the instrumented kernels M). `box` holds the clusters' boxes as
// stage_boxes lays them out. best_t and best_i come back as the plain
// version's: the closest hit in (t_min, tmax), smallest global index on
// ties; tmax and -1 on a miss. Returns the number of listed clusters the walk
// reached: k where the exit stopped it before cluster k, else n (0 for an
// empty list). With EXIT false the walk never stops early: it reaches every
// listed cluster, and the rays still ask for a cluster by their box test,
// so (t, idx) are the same, since a cluster past the exit holds no closer
// hit for any ray of the tile.
template <bool EXIT = true>
__device__ __forceinline__ int walk_closest(const float* __restrict__ tri, const float* box,
                                            const int* list, const float* entry, int n,
                                            const Ray& q, float t_min, float rel,
                                            float abs_, ClosestFlatSmem& sm, float& best_t,
                                            int& best_i) {
  if (n <= 0) {   // an empty list: every ray misses
    best_t = q.tmax;
    best_i = -1;
    return 0;
  }
  int reached = n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  const bool ahead = t_min >= 0.0f;   // the exit holds (see above)
  const float floor = box_floor(t_min);
  stage_rays(sm, q);
  sm.key[tid] = miss_key(q.tmax);
  walk_list(tri, list, n, [&](int k, int c, const float (&cur)[COMP]) {
    // the last visit's tests are done: the keys are final, the ballots free
    __syncthreads();
    const float best = key_float((unsigned)(sm.key[tid] >> 32));
    // against the best at the start of the cluster; a dead ray asks for none
    const bool asks = !dead && box_meets(box, CP, c, q, ix, iy, iz, best, floor, rel, abs_);
    float worst = fminf(best, q.far);
    for (int o = 16; o > 0; o >>= 1)
      worst = fmaxf(worst, __shfl_xor_sync(0xffffffffu, worst, o));
    ballot_asks(sm, asks, cur);
    if (lane == 0) sm.red[warp] = worst;
    __syncthreads();
    worst = fmaxf(fmaxf(sm.red[0], sm.red[1]), fmaxf(sm.red[2], sm.red[3]));
    if (EXIT && ahead && !(entry[k] <= worst)) {
      reached = k;
      return 0;
    }
    const int kind = visit_kind(sm);
    return kind ? kind : -1;
  }, [&](const float (&cur)[COMP], int c, int kind) {
    const unsigned base = (unsigned)(c * CLUSTER);
    if (kind == 2) {
      stage_own(sm, cur);
      if (!own_asks(sm)) return;
      unsigned long long key = sm.key[tid];
      for_each_face(sm, [&](int j) {
        float t;
        if (tri_test(StagedTri{sm.tri, j}, q, t) && t > t_min && t < q.tmax)
          key = min(key, ((unsigned long long)key_bits(t + 0.0f) << 32) | (base + j));
        return false;
      });
      sm.key[tid] = key;
      return;
    }
    if (!__any_sync(0xffffffffu, has_face(cur))) return;
    for_each_bit(sm.ask, [&](int r) {
      closest_pair(cur, listed_ray(sm, r), &sm.key[r], base + tid, t_min);
      return false;
    });
  });
  __syncthreads();
  const unsigned long long key = sm.key[tid];
  best_t = key_float((unsigned)(key >> 32));
  best_i = (int)(unsigned)key;   // ~0u, which is -1, on a miss
  return reached;
}

// The any-hit walk over a tile's n listed clusters (kernels B and G).
__device__ __forceinline__ bool walk_anyhit(const float* __restrict__ tri, const float* box,
                                            const int* list, const float* entry, int n,
                                            const Ray& q, float t_min, float rel, float abs_,
                                            AnyhitFlatSmem& sm) {
  if (n <= 0) return false;   // an empty list: no ray is blocked
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  const bool ahead = t_min >= 0.0f;   // the exit holds (see above)
  const float floor = box_floor(t_min);
  stage_rays(sm, q);
  sm.blocked[tid] = 0;
  walk_list(tri, list, n, [&](int k, int c, const float (&cur)[COMP]) {
    // the last visit's tests are done: the blocked bytes are final
    __syncthreads();
    const bool blocked = sm.blocked[tid] != 0;
    // a ray is resolved once blocked, dead, or past its last cluster's exit
    const bool resolved = blocked || dead || (ahead && q.far < entry[k]);
    // blocked and dead rays ask for none
    const bool asks = !(blocked || dead) &&
                      box_meets(box, CP, c, q, ix, iy, iz, q.tmax, floor, rel, abs_);
    const unsigned done = __ballot_sync(0xffffffffu, resolved);
    ballot_asks(sm, asks, cur);
    if (lane == 0) sm.done[warp] = done;
    __syncthreads();
    if ((sm.done[0] & sm.done[1] & sm.done[2] & sm.done[3]) == 0xffffffffu) return 0;
    const int kind = visit_kind(sm);
    return kind ? kind : -1;
  }, [&](const float (&cur)[COMP], int, int kind) {
    if (kind == 2) {
      stage_own(sm, cur);
      if (!own_asks(sm)) return;
      for_each_face(sm, [&](int j) {
        float t;
        const bool hit = tri_test(StagedTri{sm.tri, j}, q, t) && t > t_min && t < q.tmax;
        if (hit) sm.blocked[tid] = 1;
        return hit;
      });
      return;
    }
    if (!__any_sync(0xffffffffu, has_face(cur))) return;
    for_each_bit(sm.ask, [&](int r) {
      anyhit_pair(cur, listed_ray(sm, r), &sm.blocked[r], t_min);
      return false;
    });
  });
  __syncthreads();
  return sm.blocked[tid] != 0;
}

// --- The two-level walks (kernels D, E, H, I) ------------------------------
//
// Per supercluster every ray that still asks refines its 16-bit mask of
// children (closest hit: against its best at the start of the supercluster;
// any hit: against tmax); the block lists, for each child, the rays that ask
// for it (a ballot a warp, offsets by popc). Then for each child that some
// ray asks for, thread i holds triangle i of the child and tests it against
// the child's listed rays (closest_pair, anyhit_pair).

// Shared memory of a two-level walk.
struct PairSmem : RaySmem {
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
  unsigned long long key[TILE];       // per ray, its best (key_bits(t) << 32 | index)
  float red[TILE / 32];
};

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

// The closest-hit walk over a tile's n listed superclusters (kernels D and
// H), pair-parallel (see above). best_t and best_i come back as kernel A's:
// the closest hit in (t_min, tmax), smallest global index on ties; tmax and
// -1 on a miss. For any t_min: the exit reads the cull's entries and far
// only when t_min >= 0, as the flat walks' does.
__device__ __forceinline__ void walk_closest_super(
    const float* __restrict__ tri, const float* __restrict__ bounds, const int* list,
    const float* entry, int n, const Ray& q, float t_min, float refine_rel, float refine_abs,
    ClosestSuperSmem& sm, float& best_t, int& best_i) {
  const int tid = threadIdx.x;
  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  const bool dead = q.tmax <= t_min;
  const bool ahead = t_min >= 0.0f;   // the exit holds (see the flat walks)
  const float floor = box_floor(t_min);
  stage_rays(sm, q);
  sm.key[tid] = miss_key(q.tmax);
  for (int k = 0; k < n; ++k) {
    // the last supercluster's tests are done: the keys are final, the boxes,
    // counts and lists free
    __syncthreads();
    const float best = key_float((unsigned)(sm.key[tid] >> 32));
    // early exit between superclusters as the flat walk's, inclusive
    const float worst = block_max(fminf(best, q.far), sm.red);
    if (ahead && !(entry[k] <= worst)) break;
    const int s = list[k];
    stage_bounds(sm.b, bounds, s);
    __syncthreads();
    // against the best at the start of the supercluster; a dead ray
    // (tmax <= t_min) asks for no child at all
    const unsigned mine =
        dead ? 0u : refine(sm.b, q, ix, iy, iz, best, floor, refine_rel, refine_abs);
    const unsigned todo = list_children(mine, sm);
    visit_children(tri, s, todo, [&](const float (&c)[COMP], int j) {
      const unsigned id = (unsigned)((s * SUPER + j) * CLUSTER + tid);
      const int m = listed(sm, j);
      for (int p = 0; p < m; ++p) {
        const int r = sm.list[j][p];
        closest_pair(c, listed_ray(sm, r), &sm.key[r], id, t_min);
      }
    });
  }
  __syncthreads();
  const unsigned long long key = sm.key[tid];
  best_t = key_float((unsigned)(key >> 32));
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
  const bool ahead = t_min >= 0.0f;   // the exit holds (see the flat walks)
  const float floor = box_floor(t_min);
  stage_rays(sm, q);
  sm.blocked[tid] = 0;
  for (int k = 0; k < n; ++k) {
    // the last supercluster's tests are done: the blocked bytes are final,
    // the boxes, counts and lists free
    __syncthreads();
    const bool blocked = sm.blocked[tid] != 0;
    // resolved as in the flat any-hit walk
    const bool resolved = blocked || dead || (ahead && q.far < entry[k]);
    if (__syncthreads_and(resolved)) break;
    const int s = list[k];
    stage_bounds(sm.b, bounds, s);
    __syncthreads();
    // blocked and dead rays ask for no child at all
    const unsigned mine = (blocked || dead)
                              ? 0u
                              : refine(sm.b, q, ix, iy, iz, q.tmax, floor, refine_rel,
                                       refine_abs);
    const unsigned todo = list_children(mine, sm);
    visit_children(tri, s, todo, [&](const float (&c)[COMP], int j) {
      const int m = listed(sm, j);
      for (int p = 0; p < m; ++p) {
        const int r = sm.list[j][p];
        anyhit_pair(c, listed_ray(sm, r), &sm.blocked[r], t_min);
      }
    });
  }
  __syncthreads();
  return sm.blocked[tid] != 0;
}

}  // namespace
