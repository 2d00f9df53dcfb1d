// Any-hit (shadow-ray) kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:
// _make_anyhit_kernel, called there through _anyhit_call by anyhit_pallas.
//
// What it computes, for every ray i: whether ANY valid sphere (near-root
// quadratic) or triangle (Moller-Trumbore, det >= 1e-6 back-face cull,
// u, v >= 0, u + v <= 1) is hit with t_min <= t < t_max, t in units of |d|,
// so that d spans the shadow segment. Dead lanes (alive == 0) and lanes with
// no blocking hit write false. A cluster's triangles are tested only where
// its box is entered before the segment's end (tf >= tn && tn < t_max, the
// rule of the plain version, ops/anyhit.py:anyhit_reference, and of the
// reference kernel). Blocking is an OR over primitives, so neither the
// visiting order nor where a lane stops changes the answer.
//
// What bounds it on this card: instructions issued, not bytes (the planes of
// a 16k-triangle scene are 0.8 MB of geometry rows and boxes, in L2;
// rays in and flags out are 54 MB at 1080p, 0.016 ms). A ray-per-thread
// sweep spends them on a slab test of every cluster box from global memory
// for every ray, on 4-byte global loads for every operand, and on warps in
// which a few lanes test a cluster's 64 triangles while the others idle or
// have returned. What the design does about it is the closest-hit kernel's
// (closest_hit.cu), on the same traversal core (hit_common.cuh:visit_group,
// instantiated for a shadow query):
//   * supers over runs of 8 clusters (the reference's any-hit kernel has
//     them too), so a ray tests n_clusters / 8 boxes plus 8 for each super
//     it enters before the segment's end;
//   * the whole hierarchy is staged into the thread block's shared memory
//     once, by cp.async, unless the block's 256 rays are all dead (most
//     blocks of a shadow wavefront after the first bounce);
//   * a warp walks the union of the clusters its lanes enter, each
//     cluster's geometry rows arriving by cp.async in one of two tiles while
//     the cluster before it is tested; where few lanes enter, the 32 lanes
//     share each entering ray's 64 tests and answer it with one ballot;
//   * a lane stops at its first blocking hit and leaves the live lanes; the
//     warp stops walking once none of its live lanes is unblocked (the
//     reference stops a 512-ray tile alike);
//   * the spheres come first, over the real ones only (the rows after them
//     are padding): a lane a sphere blocks skips the triangles.
// Shared memory: 32 (n_supers + n_clusters) bytes of boxes plus 8 warps x
// 6,144 bytes of tiles, as the closest-hit kernel's (58 KB on a
// 16k-triangle scene: three blocks an SM). A scene whose hierarchy does not
// fit is refused by the launcher; ops/intersect.occluded_kernels sends such
// scenes, past the streaming crossover, to the streaming closest-hit kernel.
// Compaction of the sparse shadow lanes (a fraction of the wavefront after
// the first bounce) is left for later work.
//
// Numerics: the pair and box tests are hit_common.cuh's, shared with the
// closest-hit kernels; they round as the plain version's (which reuses
// ops/closest_hit.py's _sphere_pairs and _mt_pairs), so the two agree on
// every lane.

#include "hit_common.cuh"

using namespace rtt;

namespace {

// Whether one of the first n rows of the sphere plane sph (the real
// spheres) is valid and hit with t_min <= t < t_max.
__device__ __forceinline__ bool blocked_by_spheres(
    const float* __restrict__ sph, int n, const Ray& r, float t_min,
    float t_max) {
  const float a_quad = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  float t;
  for (int s = 0; s < n; ++s) {
    const float* p = sph + s * kSphCols;
    if (!(p[4] > 0.5f)) continue;  // valid column
    if (sphere_hit(p, r, a_quad, t_min, &t) && t < t_max) return true;
  }
  return false;
}

// Three blocks an SM is what the shared memory allows below the streaming
// crossover, as for the closest-hit kernel.
__global__ void __launch_bounds__(kThreads, 3)
anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const unsigned char* __restrict__ alive, int R,
              const float* __restrict__ sph, int n_spheres,
              const float* __restrict__ geo,
              const float* __restrict__ clu, int n_clusters,
              const float* __restrict__ sup, int n_supers, float t_min,
              float t_max, bool* __restrict__ out) {
  extern __shared__ float4 shared[];
  float4* sup_s = shared;                // n_supers boxes
  float4* clu_s = sup_s + 2 * n_supers;  // n_clusters boxes
  const int lane = threadIdx.x & 31;
  float* tiles = reinterpret_cast<float*>(clu_s + 2 * n_clusters) +
                 (threadIdx.x >> 5) * 2 * kTileFloats;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const Ray r = load_ray_rows(o, d, alive, R, i);
  int blocked = 0;
  if (__syncthreads_or(r.alive)) {
    copy_boxes_async(sup_s, sup, n_supers, threadIdx.x, kThreads);
    copy_boxes_async(clu_s, clu, n_clusters, threadIdx.x, kThreads);
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    if (r.alive)
      blocked = blocked_by_spheres(sph, n_spheres, r, t_min, t_max);
    float seg_end = t_max;  // the core's bound; a shadow query keeps it
    for (int g0 = 0; g0 < n_clusters; g0 += kGroup) {
      const bool live = r.alive && !blocked;
      if (!__any_sync(kFull, live)) break;
      visit_group<true>(r, live, t_min, lane, sup_s, 0, clu_s, 0, g0,
                        min(g0 + kGroup, n_clusters), geo, 0, tiles,
                        &seg_end, &blocked);
    }
  }
  if (i < R) out[i] = blocked != 0;
}

// Allows the kernel shared_bytes of dynamic shared memory on the current
// device; the runtime is asked once per device and size
// (hit_common.cuh:allow_shared).
cudaError_t allow(size_t shared_bytes) {
  static size_t granted[kMaxDevices];
  return allow_shared(anyhit_kernel, shared_bytes, granted);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch takes for this hierarchy.
int rtt_anyhit_shared_bytes(int n_clusters, int n_supers) {
  return (n_clusters + n_supers) * kBoxCols * 4 +
         kWarps * 2 * kTileFloats * 4;
}

// Thread blocks an SM keeps resident for this hierarchy; 0 when it does not
// fit.
int rtt_anyhit_blocks_per_sm(int n_clusters, int n_supers) {
  const size_t shared_bytes = rtt_anyhit_shared_bytes(n_clusters, n_supers);
  if (allow(shared_bytes) != cudaSuccess) {
    cudaGetLastError();  // a size that does not fit is an answer, not a fault
    return 0;
  }
  return resident_blocks(anyhit_kernel, shared_bytes);
}

// Launches the kernel on `stream` and returns the CUDA error (0 = ok): a
// refused launch, cudaErrorInvalidValue when the counts disagree, or the
// attribute call's error when the hierarchy does not fit into shared
// memory. All pointers are device pointers to contiguous arrays:
//   o, d (R, 3) f32; alive (R,) bytes or null (all alive); sph (>=
//   n_spheres, 16) f32, its first n_spheres rows the real spheres; geo
//   (TP, 12) f32; clu (>= n_clusters, 8) f32; sup (n_supers, 8) f32 with
//   n_supers = ceil(n_clusters / 8); out (R,) bool.
int rtt_anyhit(const float* o, const float* d, const unsigned char* alive,
               int R, const float* sph, int n_spheres, const float* geo,
               const float* clu, int n_clusters, const float* sup,
               int n_supers, float t_min, float t_max, bool* out,
               void* stream) {
  if (R <= 0) return 0;
  if (n_supers != (n_clusters + kSuper - 1) / kSuper)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes = rtt_anyhit_shared_bytes(n_clusters, n_supers);
  const cudaError_t err = allow(shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreads);
  const dim3 grid((R + kThreads - 1) / kThreads);
  anyhit_kernel<<<grid, block, shared_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      o, d, alive, R, sph, n_spheres, geo, clu, n_clusters, sup, n_supers,
      t_min, t_max, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
