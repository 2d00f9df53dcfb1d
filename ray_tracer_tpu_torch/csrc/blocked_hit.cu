// Streaming closest-hit kernel (large scenes) for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:
// _make_blocked_kernel (want_attrs=True and False), called there through
// _nearest_hit_blocked_call, with its per-step block lists (_block_lists), by
// nearest_hit_attrs_pallas / nearest_hit_pallas on scenes past the resident
// kernel's budget (_use_blocked).
//
// What it computes is the closest-hit kernel's (closest_hit.cu): for every ray
// i (one thread per ray) the closest sphere or triangle hit with t >= t_min,
// ids spheres [0, SP) and triangles [SP, SP + TP), t = +inf and id 0 on a miss
// or a dead lane, and with kWantAttrs the winner's 26-column merged-table row
// (zero on a miss).
//
// How: a three-level hierarchy over the triangles, which are ordered so that
// each run of 64 (a cluster) and each run of block_clusters clusters (a
// block, 8192 triangles on the main path) is spatially tight.
//   1. Every real block box is slab-tested once; the blocks the ray enters no
//      farther than its best so far (the spheres' hit) go into a per-thread
//      list, kept sorted near-to-far by entry distance (insertion sort, in
//      local memory, at most kMaxBlocks entries).
//   2. The blocks are visited in that order until the next one starts
//      farther than the running best. In a visited block every real cluster
//      box is slab-tested, and the 64 triangles of each box entered no
//      farther than the running best are tested.
// Only real blocks, ceil(n_clusters / block_clusters), and real clusters,
// ceil(num_tris / 64), are swept: boxes made only of padding are +-inf and
// would pass every slab test. A block's box spans its real clusters only.
//
// Ties: blocks are not visited in id order, so a candidate wins when
// (t, id) is lexicographically smaller than the best, and a box is culled
// only when it starts strictly farther than the best (tn <= best_t enters).
// A lower-id triangle at an equal t in a block visited later still wins, so
// the result does not depend on the visiting order: the lowest id wins a tie,
// as in the closest-hit kernel and both plain versions.
//
// On the TPU the triangles stream through VMEM in blocks along a sequential
// grid axis, the running best is carried in scratch across grid steps, block
// lists per 4096-ray step come from an XLA-side slab test, and the winner's
// row is re-extracted after every block; all of that exists because VMEM
// holds ~12 MB. Here the planes stay in global memory (a 191k-triangle scene's
// 24 MB sit in the 50 MB L2), each thread orders its own blocks, and the row
// is copied once after the traversal.
//
// What bounds it on this card: operations and divergence, not bytes. A ray
// slab-tests every block box (24 at 191k triangles) and the 128 cluster boxes
// of each block it visits (~20 float operations a box), and runs ~30
// operations per triangle of each cluster it enters; the flat closest-hit
// kernel would test all 2,984 cluster boxes. Lanes of a warp that visit
// different blocks or clusters serialize. Later work: warp-cooperative
// traversal, shared-memory staging of a visited block's cluster boxes, and
// folding the block level into the closest-hit kernel.
//
// Numerics: the pair and box tests are hit_common.cuh's, shared with the
// closest-hit kernel, so t and rows are bit-identical to the plain versions
// (ops/blocked_hit.py, ops/closest_hit.py) wherever the ids agree.

#include "hit_common.cuh"

using namespace rtt;

namespace {

constexpr int kMaxBlocks = 64;  // ops/blocked_hit.py:MAX_BLOCKS

template <bool kWantAttrs>
__global__ void __launch_bounds__(kThreads)
blocked_hit_kernel(const float* __restrict__ rays, int R,
                   const float* __restrict__ sph, int SP, int has_spheres,
                   const float* __restrict__ tri,
                   const float* __restrict__ clu, int n_clusters,
                   const float* __restrict__ blk, int n_blocks,
                   int block_clusters, const int* __restrict__ copy_map,
                   float t_min, float* __restrict__ t_out,
                   int* __restrict__ id_out, float* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i);
  float best_t = INFINITY;
  int best = -1;
  if (r.alive) {
    float t, tn, tf;
    // ---- spheres: the lowest ids, visited in id order -------------------
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
    // ---- top level: entered blocks, sorted near-to-far ------------------
    float near[kMaxBlocks];
    int order[kMaxBlocks];
    int n_enter = 0;
    for (int b = 0; b < n_blocks; ++b) {
      slab(blk + b * kBoxCols, r, t_min, &tn, &tf);
      if (!(tf >= tn && tn <= best_t)) continue;
      int j = n_enter++;
      for (; j > 0 && near[j - 1] > tn; --j) {  // stable: equal keys by id
        near[j] = near[j - 1];
        order[j] = order[j - 1];
      }
      near[j] = tn;
      order[j] = b;
    }
    // ---- middle and bottom levels: clusters, then triangles -------------
    for (int e = 0; e < n_enter && near[e] <= best_t; ++e) {
      const int c_end = min((order[e] + 1) * block_clusters, n_clusters);
      for (int c = order[e] * block_clusters; c < c_end; ++c) {
        slab(clu + c * kBoxCols, r, t_min, &tn, &tf);
        if (!(tf >= tn && tn <= best_t)) continue;
        const int base = c * kCluster;
        for (int k = 0; k < kCluster; ++k) {
          const int id = SP + base + k;
          if (triangle_hit(tri + (base + k) * kTriCols, r, t_min, &t) &&
              (t < best_t || (t == best_t && id < best))) {
            best_t = t;
            best = id;
          }
        }
      }
    }
  }
  write_hit(i, R, best_t, best, SP, sph, tri, copy_map, t_out, id_out,
            kWantAttrs ? rows : nullptr);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok),
// or cudaErrorInvalidValue without launching when n_blocks > kMaxBlocks or
// block_clusters < 1. All pointers are device pointers to contiguous arrays:
//   rays (7, R) f32; sph (SP, 16) f32; tri (TP, 32) f32;
//   clu (>= n_clusters, 8) f32; blk (>= n_blocks, 8) f32, block b spanning
//   clusters [b * block_clusters, (b + 1) * block_clusters); copy_map
//   (2, 26) i32; t_out (R,) f32; id_out (R,) i32; rows (26, R) f32, read
//   only when want_attrs != 0.
int rtt_blocked_hit(const float* rays, int R, const float* sph, int SP,
                    int has_spheres, const float* tri, const float* clu,
                    int n_clusters, const float* blk, int n_blocks,
                    int block_clusters, const int* copy_map, float t_min,
                    int want_attrs, float* t_out, int* id_out, float* rows,
                    void* stream) {
  if (n_blocks > kMaxBlocks || block_clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const dim3 block(kThreads);
  const dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_attrs) {
    blocked_hit_kernel<true><<<grid, block, 0, s>>>(
        rays, R, sph, SP, has_spheres, tri, clu, n_clusters, blk, n_blocks,
        block_clusters, copy_map, t_min, t_out, id_out, rows);
  } else {
    blocked_hit_kernel<false><<<grid, block, 0, s>>>(
        rays, R, sph, SP, has_spheres, tri, clu, n_clusters, blk, n_blocks,
        block_clusters, copy_map, t_min, t_out, id_out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_blocked_hit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
