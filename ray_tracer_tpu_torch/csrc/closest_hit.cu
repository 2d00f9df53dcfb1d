// Closest-hit kernel with in-kernel winner-row extraction, for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:_make_kernel
// (want_attrs=True and False), called there through _nearest_hit_call by
// nearest_hit_attrs_pallas / nearest_hit_pallas.
//
// What it computes, for every ray i (one thread per ray):
//   * the closest hit over all spheres (near-root quadratic) and triangles
//     (Moller-Trumbore, det >= 1e-6 back-face cull, u, v >= 0, u + v <= 1),
//     with t >= t_min; dead lanes (alive <= 0.5) and misses give t = +inf and
//     id 0;
//   * ids: spheres [0, SP), triangles [SP, SP + TP);
//   * ties: primitives are visited in ascending id order with a strict `<`,
//     so the lowest id wins a tie, as the TPU kernel's fold does;
//   * with kWantAttrs, the winner's 26-column merged-table row
//     (ops/intersect.py:_pack_attrs) copied from the plane arrays through the
//     copy map (ops/closest_hit.py:_attr_copy_maps), stored column-major as
//     rows[col * R + i]; misses give a zero row.
//
// Culling: the triangles are ordered so that each run of 64 (a cluster) is
// spatially tight, and clu holds one AABB per real cluster. A ray slab-tests
// each cluster's box and runs the 64 triangle tests only if it enters the box
// closer than its current best. Clusters made only of padding would pass the
// slab test (their boxes are +-inf), so the caller passes the count of real
// clusters, ceil(num_tris / 64), and the loop stops there.
//
// What bounds it on this card: arithmetic and divergence, not bytes. The
// planes of a 16k-triangle scene are 2 MB and stay in the 50 MB L2; a warp's
// threads mostly read the same cluster box and the same triangle at the same
// time, so the loads broadcast. The cost is the slab test of every cluster
// box per ray plus ~30 float operations per triangle pair, and lanes of one
// warp that enter different clusters serialize. This first version keeps the
// simple per-ray sweep over all cluster boxes; a two-level hierarchy, shared
// memory tiling of the planes and ray sorting are later work.
//
// Numerics: every expression keeps the association of the reference's
// _mt_pairs / _sphere_pairs / _slab_test, e.g. (d0*n0 + d1*n1) + d2*n2, and
// inv = 1/det; t = t_num*inv. The library is built with -fmad=false and
// without --use_fast_math (utils/build.py), so t, u and v are bit-identical
// to the plain PyTorch version's (ops/closest_hit.py), which rounds every
// operation separately.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCluster = 64;   // triangles per cluster (culling unit)
constexpr int kSphCols = 16;   // _pack_spheres columns
constexpr int kTriCols = 32;   // _pack_tris columns (untextured)
constexpr int kBoxCols = 8;    // _cluster_aabbs columns
constexpr int kRows = 26;      // merged-table width (untextured)
constexpr int kThreads = 256;  // threads per block
constexpr float kDetEps = 1e-6f;

template <bool kWantAttrs>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ rays, int R,
                   const float* __restrict__ sph, int SP, int has_spheres,
                   const float* __restrict__ tri,
                   const float* __restrict__ clu, int n_clusters,
                   const int* __restrict__ copy_map, float t_min,
                   float* __restrict__ t_out, int* __restrict__ id_out,
                   float* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  // rays: (7, R) SoA rows ox oy oz dx dy dz alive
  const float ox = rays[i], oy = rays[R + i], oz = rays[2 * R + i];
  const float dx = rays[3 * R + i], dy = rays[4 * R + i],
              dz = rays[5 * R + i];
  const bool alive = rays[6 * R + i] > 0.5f;

  float best_t = INFINITY;
  int best = -1;
  if (alive) {
    // ---- spheres: near-root quadratic (_sphere_pairs) --------------------
    if (has_spheres) {
      const float a_quad = (dx * dx + dy * dy) + dz * dz;
      for (int s = 0; s < SP; ++s) {
        const float* p = sph + s * kSphCols;
        if (!(p[4] > 0.5f)) continue;  // valid column
        const float ocx = ox - p[0], ocy = oy - p[1], ocz = oz - p[2];
        const float b = 2.0f * ((ocx * dx + ocy * dy) + ocz * dz);
        const float cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - p[3];
        const float disc = b * b - 4.0f * a_quad * cc;
        const float t = (-b - sqrtf(fmaxf(disc, 0.0f))) / (2.0f * a_quad);
        if (disc >= 0.0f && t >= t_min && t < best_t) {
          best_t = t;
          best = s;
        }
      }
    }
    // ---- triangles: cluster slab test, then Moller-Trumbore -------------
    // a huge finite stand-in for a zero direction component avoids 0*inf
    const float invdx = 1.0f / (dx == 0.0f ? 1e-30f : dx);
    const float invdy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
    const float invdz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
    for (int c = 0; c < n_clusters; ++c) {
      const float* box = clu + c * kBoxCols;
      const float t1x = (box[0] - ox) * invdx, t2x = (box[3] - ox) * invdx;
      const float t1y = (box[1] - oy) * invdy, t2y = (box[4] - oy) * invdy;
      const float t1z = (box[2] - oz) * invdz, t2z = (box[5] - oz) * invdz;
      const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                             fmaxf(fminf(t1z, t2z), t_min));
      const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                             fmaxf(t1z, t2z));
      if (!(tf >= tn && tn < best_t)) continue;
      const int base = c * kCluster;
      for (int k = 0; k < kCluster; ++k) {
        // plane row: a(0:3) e1(3:6) e2(6:9) n = e1 x e2 (9:12) ...
        const float* q = tri + (base + k) * kTriCols;
        const float aox = ox - q[0], aoy = oy - q[1], aoz = oz - q[2];
        const float det = -((dx * q[9] + dy * q[10]) + dz * q[11]);
        const float t_num = (aox * q[9] + aoy * q[10]) + aoz * q[11];
        const float daox = aoy * dz - aoz * dy;  // ao x d
        const float daoy = aoz * dx - aox * dz;
        const float daoz = aox * dy - aoy * dx;
        const float u_num = (q[6] * daox + q[7] * daoy) + q[8] * daoz;
        const float v_num = -((q[3] * daox + q[4] * daoy) + q[5] * daoz);
        const float inv = 1.0f / det;
        const float t = t_num * inv;
        const float u = u_num * inv;
        const float v = v_num * inv;
        if (det >= kDetEps && t >= t_min && u >= 0.0f && v >= 0.0f &&
            u + v <= 1.0f && t < best_t) {
          best_t = t;
          best = SP + base + k;
        }
      }
    }
  }
  t_out[i] = best_t;
  id_out[i] = best < 0 ? 0 : best;
  if (kWantAttrs) {
    // winner's merged-table row; copy_map row 0 = sphere plane columns,
    // row 1 = triangle plane columns, -1 = zero column
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
    for (int r = 0; r < kRows; ++r) {
      float val = 0.0f;
      if (src != nullptr) {
        const int col = cols[r];
        if (col >= 0) val = src[col];
      }
      rows[r * R + i] = val;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to contiguous arrays:
//   rays (7, R) f32; sph (SP, 16) f32; tri (TP, 32) f32; clu (>= n_clusters, 8)
//   f32; copy_map (2, 26) i32; t_out (R,) f32; id_out (R,) i32;
//   rows (26, R) f32, read only when want_attrs != 0.
int rtt_closest_hit(const float* rays, int R, const float* sph, int SP,
                    int has_spheres, const float* tri, const float* clu,
                    int n_clusters, const int* copy_map, float t_min,
                    int want_attrs, float* t_out, int* id_out, float* rows,
                    void* stream) {
  if (R <= 0) return 0;
  const dim3 block(kThreads);
  const dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_attrs) {
    closest_hit_kernel<true><<<grid, block, 0, s>>>(
        rays, R, sph, SP, has_spheres, tri, clu, n_clusters, copy_map, t_min,
        t_out, id_out, rows);
  } else {
    closest_hit_kernel<false><<<grid, block, 0, s>>>(
        rays, R, sph, SP, has_spheres, tri, clu, n_clusters, copy_map, t_min,
        t_out, id_out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
