// Any-hit (shadow-ray) kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:
// _make_anyhit_kernel, called there through _anyhit_call by anyhit_pallas.
//
// What it computes, for every ray i (one thread per ray): whether ANY sphere
// (near-root quadratic) or triangle (Moller-Trumbore, det >= 1e-6 back-face
// cull, u, v >= 0, u + v <= 1) is hit with t_min <= t < t_max, t in units of
// |d|, so that d spans the shadow segment. Dead lanes (alive <= 0.5) and
// lanes with no blocking hit write false. There is no winner to track: the
// first blocking hit settles a lane and its thread returns. Blocking is an OR
// over primitives, so the visiting order does not change the answer.
//
// Culling: as in the closest-hit kernel (closest_hit.cu), each run of 64
// triangles (a cluster) has one AABB, and a ray tests a cluster's triangles
// only if its slab test passes. The segment's end t_max takes the place of
// the closest-hit kernel's running best: tf >= tn && tn < t_max. Only the
// real clusters, ceil(num_tris / 64), are swept; all-padding clusters have
// +-inf boxes that would pass every slab test.
//
// What bounds it on this card: operations and divergence, not bytes. Every
// live ray slab-tests every cluster box until it is blocked (~20 float
// operations a box), and runs ~30 operations per triangle of each box it
// enters. A warp waits for its slowest lane: a lane whose segment is
// unblocked sweeps every box while its neighbours returned at their first
// hit, and dead lanes idle beside live ones. The TPU kernel's early exit is
// per 512-ray tile (the tile skips clusters once every live lane is
// settled); here it is per thread, which is finer, and whole warps of dead
// lanes cost only their load and store.
//
// Later work: a box hierarchy shared with the closest-hit and streaming
// kernels (supers over clusters, so a ray skips 8 boxes with one test), and
// compaction of the sparse shadow lanes (nee lanes are a fraction of the
// wavefront after the first bounce) so that warps hold only live rays.
//
// Numerics: the pair and box tests are hit_common.cuh's, shared with the
// closest-hit kernels; they round as the plain version's
// (ops/anyhit.py:anyhit_reference, which reuses ops/closest_hit.py's
// _sphere_pairs and _mt_pairs), so the two agree on every lane.

#include "hit_common.cuh"

using namespace rtt;

namespace {

__device__ bool blocked_by_spheres(const float* __restrict__ sph, int SP,
                                   const Ray& r, float t_min, float t_max) {
  const float a_quad = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  float t;
  for (int s = 0; s < SP; ++s) {
    const float* p = sph + s * kSphCols;
    if (!(p[4] > 0.5f)) continue;  // valid column
    if (sphere_hit(p, r, a_quad, t_min, &t) && t < t_max) return true;
  }
  return false;
}

__device__ bool blocked_by_triangles(const float* __restrict__ tri,
                                     const float* __restrict__ clu,
                                     int n_clusters, const Ray& r, float t_min,
                                     float t_max) {
  float t;
  for (int c = 0; c < n_clusters; ++c) {
    float tn, tf;
    slab(clu + c * kBoxCols, r, t_min, &tn, &tf);
    if (!(tf >= tn && tn < t_max)) continue;
    const float* q = tri + c * kCluster * kTriCols;
    for (int k = 0; k < kCluster; ++k, q += kTriCols)
      if (triangle_hit(q, r, t_min, &t) && t < t_max) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
anyhit_kernel(const float* __restrict__ rays, int R,
              const float* __restrict__ sph, int SP, int has_spheres,
              const float* __restrict__ tri, const float* __restrict__ clu,
              int n_clusters, float t_min, float t_max,
              bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i);
  out[i] = r.alive &&
           ((has_spheres && blocked_by_spheres(sph, SP, r, t_min, t_max)) ||
            blocked_by_triangles(tri, clu, n_clusters, r, t_min, t_max));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to contiguous arrays:
//   rays (7, R) f32; sph (SP, 16) f32; tri (TP, 32) f32;
//   clu (>= n_clusters, 8) f32; out (R,) bool.
int rtt_anyhit(const float* rays, int R, const float* sph, int SP,
               int has_spheres, const float* tri, const float* clu,
               int n_clusters, float t_min, float t_max, bool* out,
               void* stream) {
  if (R <= 0) return 0;
  const dim3 block(kThreads);
  const dim3 grid((R + kThreads - 1) / kThreads);
  anyhit_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, R, sph, SP, has_spheres, tri, clu, n_clusters, t_min, t_max, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_anyhit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
