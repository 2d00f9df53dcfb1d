// Closest-hit kernel with in-kernel winner-row extraction, for Hopper
// (sm_90a): the resident kernel, whose whole box hierarchy lives in shared
// memory.
//
// Replaces the TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:_make_kernel
// (want_attrs=True and False, textured=True and False), called there through
// _nearest_hit_call by nearest_hit_attrs_pallas / nearest_hit_pallas.
//
// What it computes, for every ray i:
//   * the closest hit over all spheres (near-root quadratic) and triangles
//     (Moller-Trumbore, det >= 1e-6 back-face cull, u, v >= 0, u + v <= 1),
//     with t >= t_min; dead lanes (alive == 0) and misses give t = +inf and
//     id 0;
//   * ids: spheres [0, SP), triangles [SP, SP + TP);
//   * ties: the lowest id wins (hit_common.cuh: a candidate wins when
//     (t, id) is lexicographically smaller, boxes enter with tn <= best_t);
//   * with kWantAttrs, the winner's 26-column merged-table row
//     (ops/intersect.py:_pack_attrs) copied from the plane arrays through the
//     copy map (ops/closest_hit.py:_attr_copy_maps), stored column-major as
//     rows[col * R + i]; misses give a zero row. With kTextured (a textured
//     scene's rows) the row is 40 columns, copied from 48-column triangle
//     planes: uv0-2, tangent, bitangent and the two texture ids besides.
//     Only write_hit's widths differ: the traversal reads the geometry plane
//     alone, and the untextured variants compile as they did.
//
// What bounds it on this card: instructions issued, not bytes (the planes of
// a 16k-triangle scene are 2 MB and stay in the 50 MB L2; rays in and rows
// out are 290 MB at 1080p, 0.09 ms). A ray-per-thread sweep spends them on
// a slab test of every cluster box for every ray, on 4-byte global loads
// for every operand, and on warps in which a few lanes test a cluster's 64
// triangles while the others idle. What the design does about it:
//   * a level above the clusters: supers over runs of 8 clusters (the
//     reference's KConfig.supers), so a ray tests n_clusters / 8 boxes plus
//     8 for each super it enters;
//   * the whole hierarchy (supers and clusters, 32 bytes a box, at most
//     13.8 KB below the streaming kernel's crossover) is staged into the
//     thread block's shared memory once, by cp.async, unless the block's 256
//     rays are all dead. One block per 256 rays: a persistent grid that
//     staged once per resident block measured slower on every wavefront
//     but a 191k-triangle scene's, because the card's block scheduler
//     balances the uneven rays (sky, terrain) better than a fixed stride;
//   * a warp works on its 32 rays together (hit_common.cuh:visit_group):
//     it walks the union of the clusters its lanes enter, each cluster's
//     3,072 bytes of geometry rows brought into one of two per-warp tiles by
//     cp.async while the cluster before it is tested, and where few lanes
//     enter a cluster the warp's 32 lanes share each entering ray's 64
//     triangle tests.
// Shared memory: 32 (n_supers + n_clusters) bytes of boxes plus 8 warps x
// 6,144 bytes of tiles (57 KB for a 16k-triangle scene: three blocks an SM).
// A scene whose hierarchy does not fit beside the tiles is refused by the
// launcher; the streaming kernel (blocked_hit.cu) takes such scenes.
//
// Numerics: the pair and box tests are hit_common.cuh's, which keep the
// association of the reference's _mt_pairs / _sphere_pairs / _slab_test and
// are built with -fmad=false and without --use_fast_math, so t, u and v are
// bit-identical to the plain PyTorch version's (ops/closest_hit.py), which
// rounds every operation separately.

#include "hit_common.cuh"

using namespace rtt;

namespace {

// Three blocks an SM is what the shared memory allows below the crossover;
// saying so lets the compiler take up to 85 registers instead of spilling to
// stay at 64.
template <bool kWantAttrs, bool kTextured>
__global__ void __launch_bounds__(kThreads, 3)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const unsigned char* __restrict__ alive, int R,
                   const float* __restrict__ sph, int SP, int n_spheres,
                   const float* __restrict__ geo,
                   const float* __restrict__ tri,
                   const float* __restrict__ clu, int n_clusters,
                   const float* __restrict__ sup, int n_supers,
                   const int* __restrict__ copy_map, float t_min,
                   float* __restrict__ t_out, int* __restrict__ id_out,
                   float* __restrict__ rows) {
  extern __shared__ float4 shared[];
  float4* sup_s = shared;                   // n_supers boxes
  float4* clu_s = sup_s + 2 * n_supers;     // n_clusters boxes
  const int lane = threadIdx.x & 31;
  float* tiles = reinterpret_cast<float*>(clu_s + 2 * n_clusters) +
                 (threadIdx.x >> 5) * 2 * kTileFloats;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const Ray r = load_ray_rows(o, d, alive, R, i);
  float best_t = INFINITY;
  int best = -1;
  // a thread block whose 256 rays are all dead (most blocks of a late
  // bounce) stages nothing
  if (__syncthreads_or(r.alive)) {
    copy_boxes_async(sup_s, sup, n_supers, threadIdx.x, kThreads);
    copy_boxes_async(clu_s, clu, n_clusters, threadIdx.x, kThreads);
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    if (__any_sync(kFull, r.alive)) {
      if (r.alive) closest_sphere(sph, n_spheres, r, t_min, &best_t, &best);
      for (int g0 = 0; g0 < n_clusters; g0 += kGroup)
        visit_group<false>(r, r.alive, t_min, lane, sup_s, 0, clu_s, 0, g0,
                           min(g0 + kGroup, n_clusters), geo, SP, tiles,
                           &best_t, &best);
    }
  }
  if (i < R)
    write_hit<kTextured ? kRowsTex : kRows,
              kTextured ? kTriColsTex : kTriCols>(
        i, R, best_t, best, SP, sph, tri, copy_map, t_out, id_out,
        kWantAttrs ? rows : nullptr);
}

// The kernel's variants: 0 ids only (which serves textured scenes too: it
// copies no row), 1 rows, 2 a textured scene's rows.
int variant(int want_attrs, int textured) {
  return want_attrs ? (textured ? 2 : 1) : 0;
}

auto kernel_of(int v) {
  return v == 2 ? closest_hit_kernel<true, true>
       : v == 1 ? closest_hit_kernel<true, false>
                : closest_hit_kernel<false, false>;
}

// Allows variant v of the kernel shared_bytes of dynamic shared memory on
// the current device; the runtime is asked once per variant, device and size
// (hit_common.cuh:allow_shared).
cudaError_t allow(int v, size_t shared_bytes) {
  static size_t granted[3][kMaxDevices];
  return allow_shared(kernel_of(v), shared_bytes, granted[v]);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch takes for this hierarchy.
int rtt_closest_hit_shared_bytes(int n_clusters, int n_supers) {
  return (n_clusters + n_supers) * kBoxCols * 4 +
         kWarps * 2 * kTileFloats * 4;
}

// Thread blocks an SM keeps resident of a variant for this hierarchy; 0 when
// it does not fit.
int rtt_closest_hit_blocks_per_sm(int n_clusters, int n_supers,
                                  int want_attrs, int textured) {
  const size_t shared_bytes =
      rtt_closest_hit_shared_bytes(n_clusters, n_supers);
  const int v = variant(want_attrs, textured);
  if (allow(v, shared_bytes) != cudaSuccess) {
    cudaGetLastError();  // a size that does not fit is an answer, not a fault
    return 0;
  }
  return resident_blocks(kernel_of(v), shared_bytes);
}

// Launches the kernel on `stream` and returns the CUDA error (0 = ok): a
// refused launch, cudaErrorInvalidValue when the counts disagree, or the
// attribute call's error when the hierarchy does not fit into shared
// memory. All pointers are device pointers to contiguous arrays:
//   o, d (R, 3) f32; alive (R,) bytes or null (all alive); sph (SP, 16) f32,
//   its first n_spheres rows the real spheres; geo (TP, 12) f32; tri
//   (TP, 32) f32, (TP, 48) when textured != 0; clu (>= n_clusters, 8) f32;
//   sup (n_supers, 8) f32 with n_supers = ceil(n_clusters / 8); copy_map
//   (2, 26) i32, (2, 40) when textured; t_out (R,) f32; id_out (R,) i32;
//   rows (26, R) f32, (40, R) when textured, written only when
//   want_attrs != 0.
int rtt_closest_hit(const float* o, const float* d,
                    const unsigned char* alive, int R, const float* sph,
                    int SP, int n_spheres, const float* geo,
                    const float* tri, const float* clu, int n_clusters,
                    const float* sup, int n_supers, const int* copy_map,
                    float t_min, int want_attrs, int textured, float* t_out,
                    int* id_out, float* rows, void* stream) {
  if (R <= 0) return 0;
  if (n_supers != (n_clusters + kSuper - 1) / kSuper)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes =
      rtt_closest_hit_shared_bytes(n_clusters, n_supers);
  const int v = variant(want_attrs, textured);
  auto kernel = kernel_of(v);
  const cudaError_t err = allow(v, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreads);
  const dim3 grid((R + kThreads - 1) / kThreads);
  kernel<<<grid, block, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      o, d, alive, R, sph, SP, n_spheres, geo, tri, clu, n_clusters, sup,
      n_supers, copy_map, t_min, t_out, id_out, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
