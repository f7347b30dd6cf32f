// The cull as a kernel of its own, for Hopper (sm_90a): per 128-ray tile, the
// ordered list of the boxes its rays can meet, for the list walks.
//
// Replaces the Pallas TPU kernel
//   experiments/exp_cullkernel.py::_cull_kernel (:78, with _slab8 :54)
// with the same contract: slab-test the tile's rays against at most 128 boxes
// (`pack_aabbs`, (8, 128): min xyz, max xyz, live, pad), take each box's
// smallest entry distance over the tile, order the boxes front to back with
// the survivors first, count the survivors, and give each ray its `far` (the
// exit of its last surviving box, capped at tmax). The lists go to global
// memory, where kernels A, B, D and E read them in place of the lists of
// ops/intersect.py::_cull.
//
// It computes what the TPU kernel computes, not how. That kernel culls eight
// tiles a grid step with an approximate reciprocal refined by a Newton step
// and orders them with a bitonic network across lanes, and agrees with the
// array-level cull only within a tolerance. Here one block culls one tile
// with `tile_cull` (intersect_cull.cuh), the block-wide cull of the fused
// walks: the IEEE arithmetic of `_cull`, an exact integer minimum per box and
// a rank by counting, so lists, counts, entries and far equal `_cull`'s bit
// for bit, and a list walk fed by this kernel equals the same walk fed by
// `_cull` and the fused walk on the same rays.
//
// Layout. One block a tile, one thread a ray and, after the cull, one thread
// a list slot: thread s < n_box writes slot s of the tile's list and entries
// (two coalesced rows a tile), thread 0 the count, every thread its far.
// Survivors come first (entries ascending, ties by id), then the other boxes
// by ascending id with entry BIG; the walks read only the first `count`. A
// row has n_box columns, the stride the list walks take: the first n_box
// ranks hold exactly the n_box real boxes, since the table's unused slots
// carry entry BIG and larger ids.
//
// What bounds it on the H100. It sits at the card's balance of 20 fp32
// operations a byte: 27 operations a slab test of a live ray against a live
// box, against 28 bytes read and 4 written a ray and 8 n bytes of list a
// tile. With few live boxes (a scene of one cluster, a mesh whose 32
// superclusters are half empty) the bytes decide, with 64 and more the slab
// tests. The ranking adds 128 shared-memory reads a thread, the minimum one
// warp reduction a box. 5.5 KB of static shared memory.

#include "intersect_cull.cuh"

namespace {

__global__ void __launch_bounds__(TILE) cull_kernel(
    const float* __restrict__ aabbs, const float* __restrict__ rays, int B, int n_box,
    int* __restrict__ lists, float* __restrict__ entries, int* __restrict__ counts,
    float* __restrict__ far_out) {
  __shared__ CullSmem cs;
  const int tile = blockIdx.x;
  const int r = tile * TILE + threadIdx.x;
  Ray q = load_ray_nofar(rays, B, r);
  const int n = tile_cull(aabbs, n_box, q, cs);
  if (threadIdx.x < n_box) {
    lists[(size_t)tile * n_box + threadIdx.x] = cs.list[threadIdx.x];
    entries[(size_t)tile * n_box + threadIdx.x] = cs.entry[threadIdx.x];
  }
  if (threadIdx.x == 0) counts[tile] = n;
  far_out[r] = q.far;
}

}  // namespace

// C entry point, bound with ctypes. B is a multiple of TILE; aabbs (8, 128)
// as `pack_aabbs` makes it, of which the first n_box <= 128 columns are
// boxes; rays (8, B) = [ox oy oz dx dy dz tmax -], the last row unread;
// lists and entries (B / TILE, n_box); counts (B / TILE,); far (B,). Returns
// cudaGetLastError().
extern "C" int mfx_cull(const float* aabbs, const float* rays, int B, int n_box, int* lists,
                        float* entries, int* counts, float* far_out, cudaStream_t stream) {
  const int tiles = B / TILE;
  if (n_box < 0 || n_box > CP) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    cull_kernel<<<tiles, TILE, 0, stream>>>(aabbs, rays, B, n_box, lists, entries, counts,
                                            far_out);
  return (int)cudaGetLastError();
}
