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
// Numerics: the pair and box tests are hit_common.cuh's, which keep the
// association of the reference's _mt_pairs / _sphere_pairs / _slab_test and
// are built with -fmad=false and without --use_fast_math, so t, u and v are
// bit-identical to the plain PyTorch version's (ops/closest_hit.py), which
// rounds every operation separately.

#include "hit_common.cuh"

using namespace rtt;

namespace {

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
  const Ray r = load_ray(rays, R, i);
  float best_t = INFINITY;
  int best = -1;
  if (r.alive) {
    float t;
    // ---- spheres: near-root quadratic (_sphere_pairs) --------------------
    if (has_spheres) {
      const float a_quad = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
      for (int s = 0; s < SP; ++s) {
        const float* p = sph + s * kSphCols;
        if (!(p[4] > 0.5f)) continue;  // valid column
        if (sphere_hit(p, r, a_quad, t_min, &t) && t < best_t) {
          best_t = t;
          best = s;
        }
      }
    }
    // ---- triangles: cluster slab test, then Moller-Trumbore -------------
    for (int c = 0; c < n_clusters; ++c) {
      float tn, tf;
      slab(clu + c * kBoxCols, r, t_min, &tn, &tf);
      if (!(tf >= tn && tn < best_t)) continue;
      const int base = c * kCluster;
      for (int k = 0; k < kCluster; ++k) {
        if (triangle_hit(tri + (base + k) * kTriCols, r, t_min, &t) &&
            t < best_t) {
          best_t = t;
          best = SP + base + k;
        }
      }
    }
  }
  write_hit(i, R, best_t, best, SP, sph, tri, copy_map, t_out, id_out,
            kWantAttrs ? rows : nullptr);
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
