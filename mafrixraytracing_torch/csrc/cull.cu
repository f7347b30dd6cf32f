// The cull as a kernel of its own, for Hopper (sm_90a): per 128-ray tile, the
// ordered list of the boxes its rays can meet, for the list walks. It is the
// cull of every CUDA query of at most 128 boxes (ops/intersect.py::_prep).
//
// Replaces the Pallas TPU kernel
//   experiments/exp_cullkernel.py::_cull_kernel (:78, with _slab8 :54)
// with the same contract: slab-test the tile's rays against at most 128 boxes
// (min xyz, max xyz; an empty box has min > max), take each box's smallest
// entry distance over the tile, order the boxes front to back with the
// survivors first, count the survivors, and give each ray its `far` (the exit
// of its last surviving box, capped at tmax). The lists go to global memory,
// where kernels A, B, D and E read them.
//
// It computes what the TPU kernel computes, not how. That kernel culls eight
// tiles a grid step with an approximate reciprocal refined by a Newton step
// and orders them with a bitonic network across lanes, and agrees with the
// array-level cull only within a tolerance. Here the arithmetic is that of
// ops/intersect.py::_cull (the IEEE reciprocal of `safe_inverse`, separate
// subtract and multiply, the order of the fminf/fmaxf chains of tn and tf, a
// NaN origin passing no box, the entry clamped at +0, a NaN tmax giving a NaN
// far), the minimum is one of unsigned bits and the order a rank by counting,
// so lists, counts, entries and far equal `_cull`'s bit for bit.
//
// Layout. CULL_TILES tiles a block, one thread a ray.
//   1. Warp 0 reads the n boxes straight from the (n, 3) minima and maxima
//      (no packed table) and stages the live ones, compacted, 32 bytes each
//      in shared memory (two 16-byte loads a box); the other threads load
//      their rays meanwhile. One barrier.
//   2. Each thread slab-tests its ray against the live boxes (shared-memory
//      broadcasts) and keeps its far in a register; per box a warp takes the
//      minimum of its 32 entries' bits (`__reduce_min_sync`, exact: entries
//      are >= +0, so their bits order as unsigned integers) and lane 0 stores
//      it in the warp's own row: no atomics. Far goes out. One barrier.
//   3. Thread s < n of a tile combines the four warp minima of its tile for
//      live box s (empty boxes take BIG) into the tile's key row. One barrier.
//   4. Thread s < n ranks key s among the tile's n keys (ties by id: what
//      the stable sort of `_cull` gives) and writes slot `rank` of the tile's
//      row of n columns, the stride the list walks take; thread 0 the count.
//      With n <= 32 one warp of the tile ranks.
// Three barriers a block of CULL_TILES tiles; the staging, the ranking and
// the rows cost n, not 128.
//
// What bounds it on the H100. The bytes (28 read and 4 written a ray, 8 n a
// tile) with few live boxes (Cornell's one cluster), the slab tests (27 fp32
// operations for each live ray and live box; most of them minima, maxima,
// comparisons and selects, which run at half the rate of a product) with
// many (the 128 clusters of profile_walk's sphere). 14.3 KB of static shared
// memory a block.

#include "intersect_common.cuh"

namespace {

constexpr int CULL_TILES = 4;                   // tiles a block
constexpr int CULL_THREADS = CULL_TILES * TILE;
constexpr int CULL_WARPS = CULL_THREADS / 32;
constexpr int TILE_WARPS = TILE / 32;

// A live box as staged: two 16-byte rows, and its index in (cmin, cmax).
struct __align__(16) CullBox {
  float lx, ly, lz, hx;
  float hy, hz;
  int id;
  int pad;
};

struct CullKernelSmem {
  CullBox box[CP];                     // the live boxes, ascending id
  unsigned wmin[CULL_WARPS][CP];       // per warp, the least entry bits of each live box
  unsigned key[CULL_TILES][CP];        // per tile, each box's entry bits, by id
  unsigned char live[CP];              // by id
  int n_live;
};

__global__ void __launch_bounds__(CULL_THREADS) cull_kernel(
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ rays, int B, int n, int* __restrict__ lists,
    float* __restrict__ entries, int* __restrict__ counts, float* __restrict__ far_out) {
  __shared__ CullKernelSmem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int t = tid / TILE;          // the thread's tile in the block
  const int s = tid % TILE;          // its ray in the tile, and after the cull its slot
  const int tile = blockIdx.x * CULL_TILES + t;
  const bool real = tile < B / TILE;  // the same for the tile's four warps
  const int r = tile * TILE + s;
  const unsigned big = __float_as_uint(BIG);

  // 1. the rays in flight, warp 0 stages the live boxes
  Ray q{};
  if (real) {
    q.ox = rays[0 * (size_t)B + r];
    q.oy = rays[1 * (size_t)B + r];
    q.oz = rays[2 * (size_t)B + r];
    q.dx = rays[3 * (size_t)B + r];
    q.dy = rays[4 * (size_t)B + r];
    q.dz = rays[5 * (size_t)B + r];
    q.tmax = rays[6 * (size_t)B + r];
  }
  if (warp == 0) {
    int base = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      CullBox b{};
      bool live = false;
      if (j < n) {
        b = CullBox{cmin[3 * j], cmin[3 * j + 1], cmin[3 * j + 2], cmax[3 * j],
                    cmax[3 * j + 1], cmax[3 * j + 2], j, 0};
        // `_cull`'s live test: the +-3e38 sentinels of an empty box overflow
        // to +-inf slabs that would pass the interval test
        live = b.lx <= b.hx;
        sm.live[j] = live;
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) sm.box[base + __popc(m & ((1u << lane) - 1u))] = b;
      base += __popc(m);
    }
    if (lane == 0) sm.n_live = base;
  }
  __syncthreads();

  // 2. the slab tests, each live box's minimum a warp, far
  const int n_live = sm.n_live;
  if (real) {
    const float ix = safe_inverse(q.dx), iy = safe_inverse(q.dy), iz = safe_inverse(q.dz);
    // in `_cull` a NaN in the origin poisons tn and tf and fails every
    // comparison, where fmaxf and fminf would drop it (a NaN in the direction
    // never gets that far: safe_inverse takes it for -1e-12, there as here)
    const bool sane = (q.ox == q.ox) && (q.oy == q.oy) && (q.oz == q.oz);
    float far = -BIG;
#pragma unroll 4
    for (int k = 0; k < n_live; ++k) {
      const CullBox b = sm.box[k];
      const float x0 = (b.lx - q.ox) * ix, x1 = (b.hx - q.ox) * ix;
      const float y0 = (b.ly - q.oy) * iy, y1 = (b.hy - q.oy) * iy;
      const float z0 = (b.lz - q.oz) * iz, z1 = (b.hz - q.oz) * iz;
      const float tn = fmaxf(fmaxf(fmaxf(-BIG, fminf(x0, x1)), fminf(y0, y1)), fminf(z0, z1));
      const float tf = fminf(fminf(fminf(BIG, fmaxf(x0, x1)), fmaxf(y0, y1)), fmaxf(z0, z1));
      const bool hit = sane && (tn <= tf) && (tf > 0.0f) && (tn < q.tmax);
      // clamp at +0: a -0 entry would order last as an unsigned integer
      const float e = hit ? (tn > 0.0f ? tn : 0.0f) : BIG;
      if (hit) far = fmaxf(far, tf);
      const unsigned least = __reduce_min_sync(0xffffffffu, __float_as_uint(e));
      if (lane == 0) sm.wmin[warp][k] = least;
    }
    far_out[r] = (q.tmax == q.tmax) ? fminf(far, q.tmax) : q.tmax;
  }
  __syncthreads();

  // 3. the tile's key of each box: its four warps' minima, BIG if empty
  if (real && s < n) {
    if (s < n_live) {
      const unsigned* w = &sm.wmin[t * TILE_WARPS][s];
      sm.key[t][sm.box[s].id] = min(min(w[0], w[CP]), min(w[2 * CP], w[3 * CP]));
    }
    if (!sm.live[s]) sm.key[t][s] = big;
  }
  __syncthreads();

  // 4. slot s's rank among the tile's n (entry, id) pairs, the row, the count
  if (real && s < n) {
    const unsigned mine = sm.key[t][s];
    int rank = 0, count = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned other = sm.key[t][j];
      rank += (other < mine || (other == mine && j < s)) ? 1 : 0;
      count += other < big ? 1 : 0;
    }
    const size_t row = (size_t)tile * n;
    lists[row + rank] = s;
    entries[row + rank] = __uint_as_float(mine);
    if (s == 0) counts[tile] = count;
  }
}

}  // namespace

// C entry point, bound with ctypes. B is a multiple of TILE; cmin and cmax
// (n, 3), 1 <= n <= 128 boxes; rays (8, B) = [ox oy oz dx dy dz tmax -], the
// last row unread (far_out may be that row); lists and entries (B / TILE, n);
// counts (B / TILE,); far (B,). Returns cudaGetLastError().
extern "C" int mfx_cull(const float* cmin, const float* cmax, const float* rays, int B, int n,
                        int* lists, float* entries, int* counts, float* far_out,
                        cudaStream_t stream) {
  if (n < 1 || n > CP) return (int)cudaErrorInvalidValue;
  const int blocks = (B / TILE + CULL_TILES - 1) / CULL_TILES;
  if (blocks > 0)
    cull_kernel<<<blocks, CULL_THREADS, 0, stream>>>(cmin, cmax, rays, B, n, lists, entries,
                                                     counts, far_out);
  return (int)cudaGetLastError();
}
