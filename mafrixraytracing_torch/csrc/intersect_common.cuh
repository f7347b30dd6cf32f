// Shared pieces of the cluster walks (intersect.cu, intersect_super.cu): the
// ray record, the staging of one packed cluster into shared memory, the
// plane + barycentric ray-triangle test and the block-wide maximum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // rays per block (the ray-order tile)
constexpr int CLUSTER = 128;  // triangles per cluster
constexpr int COMP = 12;      // packed components per triangle
constexpr float DET_EPS = 1e-10f;

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

}  // namespace
