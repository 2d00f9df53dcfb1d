// Shared device code of the port's ray-query kernels (closest_hit.cu,
// anyhit.cu, blocked_hit.cu): plane layouts, the ray load, and the sphere,
// box and triangle tests.
//
// Every expression keeps the association of the plain PyTorch versions
// (ops/closest_hit.py:_sphere_pairs and _mt_pairs, ops/anyhit.py:_slab_pairs,
// which follow the reference's pallas_intersect.py helpers of the same
// names), e.g. (d0*n0 + d1*n1) + d2*n2 and inv = 1/det; t = t_num*inv. The
// libraries are built with -fmad=false and without --use_fast_math
// (utils/build.py), so each test rounds as the plain version's does.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rtt {

constexpr int kCluster = 64;   // triangles per cluster (culling unit)
constexpr int kSphCols = 16;   // _pack_spheres columns
constexpr int kTriCols = 32;   // _pack_tris columns (untextured)
constexpr int kBoxCols = 8;    // _cluster_aabbs / _block_aabbs columns
constexpr int kRows = 26;      // merged-table width (untextured)
constexpr int kThreads = 256;  // threads per block
constexpr float kDetEps = 1e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float invdx, invdy, invdz;
  bool alive;
};

// rays: (7, R) SoA rows ox oy oz dx dy dz alive
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int R,
                                        int i) {
  Ray r;
  r.ox = rays[i];
  r.oy = rays[R + i];
  r.oz = rays[2 * R + i];
  r.dx = rays[3 * R + i];
  r.dy = rays[4 * R + i];
  r.dz = rays[5 * R + i];
  r.alive = rays[6 * R + i] > 0.5f;
  // a huge finite stand-in for a zero direction component avoids 0*inf
  r.invdx = 1.0f / (r.dx == 0.0f ? 1e-30f : r.dx);
  r.invdy = 1.0f / (r.dy == 0.0f ? 1e-30f : r.dy);
  r.invdz = 1.0f / (r.dz == 0.0f ? 1e-30f : r.dz);
  return r;
}

// Near-root sphere quadratic of the valid sphere plane row p: whether the ray
// hits it with t >= t_min, and t. a_quad = d.d.
__device__ __forceinline__ bool sphere_hit(const float* __restrict__ p,
                                           const Ray& r, float a_quad,
                                           float t_min, float* t_out) {
  const float ocx = r.ox - p[0], ocy = r.oy - p[1], ocz = r.oz - p[2];
  const float b = 2.0f * ((ocx * r.dx + ocy * r.dy) + ocz * r.dz);
  const float cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - p[3];
  const float disc = b * b - 4.0f * a_quad * cc;
  const float t = (-b - sqrtf(fmaxf(disc, 0.0f))) / (2.0f * a_quad);
  *t_out = t;
  return disc >= 0.0f && t >= t_min;
}

// Slab test of box [lo(0:3) | hi(3:6)]: the ray is inside it for
// t in [tn, tf] (entered when tf >= tn), tn clamped below at t_min.
__device__ __forceinline__ void slab(const float* __restrict__ box,
                                     const Ray& r, float t_min, float* tn,
                                     float* tf) {
  const float t1x = (box[0] - r.ox) * r.invdx, t2x = (box[3] - r.ox) * r.invdx;
  const float t1y = (box[1] - r.oy) * r.invdy, t2y = (box[4] - r.oy) * r.invdy;
  const float t1z = (box[2] - r.oz) * r.invdz, t2z = (box[5] - r.oz) * r.invdz;
  *tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
              fmaxf(fminf(t1z, t2z), t_min));
  *tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// Moller-Trumbore (cross/determinant form) against the triangle plane row q:
// a(0:3) e1(3:6) e2(6:9) n = e1 x e2 (9:12) ... Whether det >= 1e-6 (back
// faces culled), u, v >= 0, u + v <= 1 and t >= t_min, and t.
__device__ __forceinline__ bool triangle_hit(const float* __restrict__ q,
                                             const Ray& r, float t_min,
                                             float* t_out) {
  const float aox = r.ox - q[0], aoy = r.oy - q[1], aoz = r.oz - q[2];
  const float det = -((r.dx * q[9] + r.dy * q[10]) + r.dz * q[11]);
  const float t_num = (aox * q[9] + aoy * q[10]) + aoz * q[11];
  const float daox = aoy * r.dz - aoz * r.dy;  // ao x d
  const float daoy = aoz * r.dx - aox * r.dz;
  const float daoz = aox * r.dy - aoy * r.dx;
  const float u_num = (q[6] * daox + q[7] * daoy) + q[8] * daoz;
  const float v_num = -((q[3] * daox + q[4] * daoy) + q[5] * daoz);
  const float inv = 1.0f / det;
  const float t = t_num * inv;
  const float u = u_num * inv;
  const float v = v_num * inv;
  *t_out = t;
  return det >= kDetEps && t >= t_min && u >= 0.0f && v >= 0.0f &&
         u + v <= 1.0f;
}

// Writes ray i's outputs: t, id (0 on a miss) and, when rows is not null,
// the winner's merged-table row copied from the plane arrays through the
// copy map (row 0: sphere plane columns, row 1: triangle plane columns,
// -1: zero column), column-major as rows[col * R + i]; a miss (best < 0)
// gives a zero row.
__device__ __forceinline__ void write_hit(
    int i, int R, float best_t, int best, int SP,
    const float* __restrict__ sph, const float* __restrict__ tri,
    const int* __restrict__ copy_map, float* __restrict__ t_out,
    int* __restrict__ id_out, float* __restrict__ rows) {
  t_out[i] = best_t;
  id_out[i] = best < 0 ? 0 : best;
  if (rows == nullptr) return;
  const float* src = nullptr;
  const int* cols = nullptr;
  if (best >= 0 && best < SP) {
    src = sph + best * kSphCols;
    cols = copy_map;
  } else if (best >= SP) {
    src = tri + (best - SP) * kTriCols;
    cols = copy_map + kRows;
  }
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    float val = 0.0f;
    if (src != nullptr) {
      const int col = cols[c];
      if (col >= 0) val = src[col];
    }
    rows[c * R + i] = val;
  }
}

}  // namespace rtt
