// The block-wide cull of one 128-ray tile against at most 128 boxes, for the
// fused-cull walks (intersect_fused.cu: the list stays in shared memory and is
// walked at once). See intersect_fused.cu for the design;
// ops/intersect.py::_cull is the arithmetic it repeats, as the stand-alone
// cull kernel K (cull.cu) does.
#pragma once

#include "intersect_common.cuh"

namespace {

struct CullSmem {
  float box[AABB_ROWS * CP];     // the staged box table
  unsigned key[CP];              // tile-min entry per box, as bits
  int list[CP];                  // box ids, front to back
  float entry[CP];               // their entries, ascending
};

// Rays of the fused kernels: rows 0-6 of (8, B) = [ox oy oz dx dy dz tmax];
// row 7 (the list kernels' `far`) is not read: the cull computes it.
__device__ __forceinline__ Ray load_ray_nofar(const float* __restrict__ rays, int B, int r) {
  Ray q;
  q.ox = rays[0 * (size_t)B + r];
  q.oy = rays[1 * (size_t)B + r];
  q.oz = rays[2 * (size_t)B + r];
  q.dx = rays[3 * (size_t)B + r];
  q.dy = rays[4 * (size_t)B + r];
  q.dz = rays[5 * (size_t)B + r];
  q.tmax = rays[6 * (size_t)B + r];
  q.far = -BIG;
  return q;
}

// The block-wide cull of one tile against the first n (<= CP) boxes of the
// packed (8, CP) table. Every thread of the block calls it with its own ray.
// Sets q.far; leaves the ordered list in cs.list / cs.entry (all CP slots,
// survivors first) and returns the number of survivors. Ends with a barrier,
// so the list may be read at once.
__device__ __forceinline__ int tile_cull(const float* __restrict__ aabbs, int n, Ray& q,
                                         CullSmem& cs) {
  const int tid = threadIdx.x;
  for (int j = tid; j < AABB_ROWS * CP; j += TILE) cs.box[j] = aabbs[j];
  cs.key[tid] = __float_as_uint(BIG);
  __syncthreads();

  const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
  // in `_cull` a NaN in the origin poisons tn and tf and fails every
  // comparison, where fmaxf and fminf would drop it (a NaN in the direction
  // never gets that far: safe_inverse takes it for -1e-12, there as here)
  const bool sane = (q.ox == q.ox) && (q.oy == q.oy) && (q.oz == q.oz);
  float far = -BIG;
  for (int j = 0; j < n; ++j) {
    const float x0 = (cs.box[0 * CP + j] - q.ox) * ix, x1 = (cs.box[3 * CP + j] - q.ox) * ix;
    const float y0 = (cs.box[1 * CP + j] - q.oy) * iy, y1 = (cs.box[4 * CP + j] - q.oy) * iy;
    const float z0 = (cs.box[2 * CP + j] - q.oz) * iz, z1 = (cs.box[5 * CP + j] - q.oz) * iz;
    const float tn = fmaxf(fmaxf(fmaxf(-BIG, fminf(x0, x1)), fminf(y0, y1)), fminf(z0, z1));
    const float tf = fminf(fminf(fminf(BIG, fmaxf(x0, x1)), fmaxf(y0, y1)), fmaxf(z0, z1));
    const bool live = cs.box[6 * CP + j] > 0.5f;
    const bool hit = sane && live && (tn <= tf) && (tf > 0.0f) && (tn < q.tmax);
    // clamp at +0: a -0 entry would order last as an unsigned integer
    const float e = hit ? (tn > 0.0f ? tn : 0.0f) : BIG;
    if (hit) far = fmaxf(far, tf);
    const unsigned m = __reduce_min_sync(0xffffffffu, __float_as_uint(e));
    if ((tid & 31) == 0) atomicMin(&cs.key[j], m);
  }
  q.far = (q.tmax == q.tmax) ? fminf(far, q.tmax) : q.tmax;
  __syncthreads();

  // rank of slot tid among the CP (entry, id) pairs
  const unsigned mine = cs.key[tid];
  int rank = 0;
  for (int j = 0; j < CP; ++j) {
    const unsigned other = cs.key[j];
    rank += (other < mine || (other == mine && j < tid)) ? 1 : 0;
  }
  cs.list[rank] = tid;
  cs.entry[rank] = __uint_as_float(mine);
  return __syncthreads_count(mine < __float_as_uint(BIG));
}

}  // namespace
