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
// Numerics: every expression keeps the association of closest_hit.cu and of
// the plain version (ops/anyhit.py:anyhit_reference, which reuses
// ops/closest_hit.py:_sphere_pairs and _mt_pairs). The library is built
// with -fmad=false and without --use_fast_math (utils/build.py), so each
// pair test rounds as the plain version's does, and the two agree on every
// lane.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCluster = 64;   // triangles per cluster (culling unit)
constexpr int kSphCols = 16;   // _pack_spheres columns
constexpr int kTriCols = 32;   // _pack_tris columns (untextured)
constexpr int kBoxCols = 8;    // _cluster_aabbs columns
constexpr int kThreads = 256;  // threads per block
constexpr float kDetEps = 1e-6f;

__device__ bool blocked_by_spheres(const float* __restrict__ sph, int SP,
                                   float ox, float oy, float oz, float dx,
                                   float dy, float dz, float t_min,
                                   float t_max) {
  const float a_quad = (dx * dx + dy * dy) + dz * dz;
  for (int s = 0; s < SP; ++s) {
    const float* p = sph + s * kSphCols;
    if (!(p[4] > 0.5f)) continue;  // valid column
    const float ocx = ox - p[0], ocy = oy - p[1], ocz = oz - p[2];
    const float b = 2.0f * ((ocx * dx + ocy * dy) + ocz * dz);
    const float cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - p[3];
    const float disc = b * b - 4.0f * a_quad * cc;
    const float t = (-b - sqrtf(fmaxf(disc, 0.0f))) / (2.0f * a_quad);
    if (disc >= 0.0f && t >= t_min && t < t_max) return true;
  }
  return false;
}

__device__ bool blocked_by_triangles(const float* __restrict__ tri,
                                     const float* __restrict__ clu,
                                     int n_clusters, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float t_min, float t_max) {
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
    if (!(tf >= tn && tn < t_max)) continue;
    const float* q = tri + c * kCluster * kTriCols;
    for (int k = 0; k < kCluster; ++k, q += kTriCols) {
      // plane row: a(0:3) e1(3:6) e2(6:9) n = e1 x e2 (9:12) ...
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
          u + v <= 1.0f && t < t_max)
        return true;
    }
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
  // rays: (7, R) SoA rows ox oy oz dx dy dz alive
  if (!(rays[6 * R + i] > 0.5f)) {
    out[i] = false;
    return;
  }
  const float ox = rays[i], oy = rays[R + i], oz = rays[2 * R + i];
  const float dx = rays[3 * R + i], dy = rays[4 * R + i],
              dz = rays[5 * R + i];
  out[i] = (has_spheres && blocked_by_spheres(sph, SP, ox, oy, oz, dx, dy,
                                              dz, t_min, t_max)) ||
           blocked_by_triangles(tri, clu, n_clusters, ox, oy, oz, dx, dy, dz,
                                t_min, t_max);
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
