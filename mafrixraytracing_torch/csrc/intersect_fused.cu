// Fused-cull closest-hit and any-hit searches, flat and two-level, for Hopper
// (sm_90a): the cull of ops/intersect.py::_cull inside the walk's block.
//
// Replaces the Pallas TPU kernels
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_fused_closest_kernel       (:608)
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_fused_anyhit_kernel        (:667)
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_fused_closest_super_kernel (:709)
//   mafrixraytracing_tpu/ops/intersect_pallas.py::_fused_anyhit_super_kernel  (:769)
// with the same contract: per 128-ray tile, slab-test the rays against at
// most 128 boxes (clusters on the flat path, superclusters on the two-level
// path; `pack_aabbs`, (8, 128): min xyz, max xyz, live, pad), take each box's
// smallest entry distance over the tile and each ray's `far` (the exit of
// its last surviving box, capped at tmax), order the surviving boxes front to
// back, and walk that list as kernels A, B, D and E walk the list the
// PyTorch cull hands them.
//
// Why. The PyTorch cull is a chain of some 25 elementwise operations over
// dense (B, C) temporaries in device memory, a sort and two conversions per
// query; here the same work stays in shared memory and registers, and the
// query is one launch.
//
// Layout. One block per tile, one thread per ray (`tile_cull`):
//   1. The block stages the 7 x n box rows in shared memory (3.5 KB).
//   2. Each thread slab-tests its own ray against the n boxes (shared-memory
//      broadcasts) in the arithmetic of `_cull`: the IEEE reciprocal of
//      `safe_inverse`, separate subtract and multiply, the live row masking
//      the +-3e38 sentinels of empty boxes. It keeps its own `far` in a
//      register. Entries are >= +0 (a -0 is made +0), so their bit patterns
//      order as unsigned integers: the tile's minimum of a box's entry is a
//      warp `__reduce_min_sync` and one shared-memory `atomicMin` a warp,
//      exact and independent of the order in which warps arrive.
//   3. One thread a slot ranks the 128 (entry, id) pairs: a slot's place is
//      the number of pairs below it, ties by id (what the stable sort of
//      `_cull` gives). 128 broadcast reads a thread and one barrier; no
//      sorting network, since any thread can read any slot here. The count
//      is the number of entries below BIG.
//   4. The walk of intersect_common.cuh runs on the shared-memory list, so
//      hits, ties and early exits are the list path's by construction. The
//      flat walks (F, G: kernel A's and B's) test each ray against the box
//      rows this cull staged; the two-level walks (H, I: D's and E's) stage
//      each listed supercluster's child bounds.
// The lists equal `_cull`'s, so each kernel agrees bit for bit with the list
// kernel fed by `_cull`, and with its plain version. A ray with a NaN in its
// origin passes no box (in `_cull` the NaN poisons entry and exit); a
// dead or padded ray (tmax 0) passes none either; a tile of such rays has
// count 0 and walks nothing.
//
// What bounds it on the H100. Operations, as the list walks: the slab tests
// add 128 rays x n boxes x ~27 fp32 operations a tile, the cost of ~115
// (ray, cluster) pairs (128 tests of ~30 each) at n = 128; the walks test
// only the (ray, cluster) or (ray, child) pairs their rays ask for
// (intersect_common.cuh). Bytes: a tile reads its rays (3.5 KB), the box
// table (L2-resident) and 6 KB per visited cluster, and writes 8 or 1 bytes
// a ray. 15.9 KB of static shared memory at most (F).
//
// `tile_cull` (intersect_cull.cuh) is the cull of one tile in a block of one
// tile; the stand-alone cull kernel K (cull.cu) culls several tiles a block
// with the same arithmetic.

#include "intersect_cull.cuh"

namespace {

__global__ void __launch_bounds__(TILE) fused_closest_kernel(
    const float* __restrict__ tri, const float* __restrict__ aabbs,
    const float* __restrict__ rays, int B, int n_box, float t_min, float refine_rel,
    float refine_abs, float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ ClosestFlatSmem sm;
  __shared__ CullSmem cs;
  const int r = blockIdx.x * TILE + threadIdx.x;
  Ray q = load_ray_nofar(rays, B, r);
  const int n = tile_cull(aabbs, n_box, q, cs);
  float best_t;
  int best_i;
  walk_closest(tri, cs.box, cs.list, cs.entry, n, q, t_min, refine_rel, refine_abs, sm,
               best_t, best_i);
  t_out[r] = best_t;
  i_out[r] = best_i;
}

__global__ void __launch_bounds__(TILE) fused_anyhit_kernel(
    const float* __restrict__ tri, const float* __restrict__ aabbs,
    const float* __restrict__ rays, int B, int n_box, float t_min, float refine_rel,
    float refine_abs, uint8_t* __restrict__ occ_out) {
  __shared__ AnyhitFlatSmem sm;
  __shared__ CullSmem cs;
  const int r = blockIdx.x * TILE + threadIdx.x;
  Ray q = load_ray_nofar(rays, B, r);
  const int n = tile_cull(aabbs, n_box, q, cs);
  occ_out[r] =
      walk_anyhit(tri, cs.box, cs.list, cs.entry, n, q, t_min, refine_rel, refine_abs, sm)
          ? 1 : 0;
}

__global__ void __launch_bounds__(TILE) fused_closest_super_kernel(
    const float* __restrict__ tri, const float* __restrict__ bounds,
    const float* __restrict__ aabbs, const float* __restrict__ rays, int B, int n_box,
    float t_min, float refine_rel, float refine_abs, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  __shared__ ClosestSuperSmem sm;
  __shared__ CullSmem cs;
  const int r = blockIdx.x * TILE + threadIdx.x;
  Ray q = load_ray_nofar(rays, B, r);
  const int n = tile_cull(aabbs, n_box, q, cs);
  float best_t;
  int best_i;
  walk_closest_super(tri, bounds, cs.list, cs.entry, n, q, t_min, refine_rel, refine_abs, sm,
                     best_t, best_i);
  t_out[r] = best_t;
  i_out[r] = best_i;
}

__global__ void __launch_bounds__(TILE) fused_anyhit_super_kernel(
    const float* __restrict__ tri, const float* __restrict__ bounds,
    const float* __restrict__ aabbs, const float* __restrict__ rays, int B, int n_box,
    float t_min, float refine_rel, float refine_abs, uint8_t* __restrict__ occ_out) {
  __shared__ AnyhitSuperSmem sm;
  __shared__ CullSmem cs;
  const int r = blockIdx.x * TILE + threadIdx.x;
  Ray q = load_ray_nofar(rays, B, r);
  const int n = tile_cull(aabbs, n_box, q, cs);
  occ_out[r] =
      walk_anyhit_super(tri, bounds, cs.list, cs.entry, n, q, t_min, refine_rel, refine_abs,
                        sm)
          ? 1 : 0;
}

}  // namespace

// C entry points, bound with ctypes. B is a multiple of TILE; tri is
// (C, 12, 128); aabbs (8, 128) as `pack_aabbs` makes it, of which the first
// n_box <= 128 columns are boxes (clusters: n_box = C; superclusters: n_box =
// S with C <= S * 16 and bounds (S, 7, 16)); rays (8, B) = [ox oy oz dx dy dz
// tmax -], the last row unread. Each returns cudaGetLastError().
extern "C" int mfx_fused_closest(const float* tri, const float* aabbs, const float* rays,
                                 int B, int n_box, float t_min, float refine_rel,
                                 float refine_abs, float* t_out, int* i_out,
                                 cudaStream_t stream) {
  const int tiles = B / TILE;
  if (n_box < 0 || n_box > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    fused_closest_kernel<<<tiles, TILE, 0, stream>>>(tri, aabbs, rays, B, n_box, t_min,
                                                      refine_rel, refine_abs, t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" int mfx_fused_anyhit(const float* tri, const float* aabbs, const float* rays,
                                int B, int n_box, float t_min, float refine_rel,
                                float refine_abs, uint8_t* occ_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (n_box < 0 || n_box > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    fused_anyhit_kernel<<<tiles, TILE, 0, stream>>>(tri, aabbs, rays, B, n_box, t_min,
                                                     refine_rel, refine_abs, occ_out);
  return (int)cudaGetLastError();
}

extern "C" int mfx_fused_closest_super(const float* tri, const float* bounds,
                                       const float* aabbs, const float* rays, int B, int C,
                                       int n_box, float t_min, float refine_rel,
                                       float refine_abs, float* t_out, int* i_out,
                                       cudaStream_t stream) {
  const int tiles = B / TILE;
  if (n_box < 0 || n_box > CP || C > n_box * SUPER) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    fused_closest_super_kernel<<<tiles, TILE, 0, stream>>>(
        tri, bounds, aabbs, rays, B, n_box, t_min, refine_rel, refine_abs, t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" int mfx_fused_anyhit_super(const float* tri, const float* bounds,
                                      const float* aabbs, const float* rays, int B, int C,
                                      int n_box, float t_min, float refine_rel,
                                      float refine_abs, uint8_t* occ_out,
                                      cudaStream_t stream) {
  const int tiles = B / TILE;
  if (n_box < 0 || n_box > CP || C > n_box * SUPER) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    fused_anyhit_super_kernel<<<tiles, TILE, 0, stream>>>(
        tri, bounds, aabbs, rays, B, n_box, t_min, refine_rel, refine_abs, occ_out);
  return (int)cudaGetLastError();
}
