// Streaming closest-hit kernel (large scenes) for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:
// _make_blocked_kernel (want_attrs=True and False, textured=True and False),
// called there through _nearest_hit_blocked_call, with its per-step block
// lists (_block_lists), by nearest_hit_attrs_pallas / nearest_hit_pallas on
// scenes past the resident kernel's budget (_use_blocked).
//
// What it computes is the closest-hit kernel's (closest_hit.cu): for every ray
// i the closest sphere or triangle hit with t >= t_min, ids spheres [0, SP)
// and triangles [SP, SP + TP), t = +inf and id 0 on a miss or a dead lane,
// and with kWantAttrs the winner's 26-column merged-table row (zero on a
// miss), 40 columns from the 48-column triangle planes with kTextured (a
// textured scene's rows; only write_hit's widths differ).
//
// How: a four-level hierarchy over the triangles, which are ordered so that
// each run of 64 (a cluster), of 8 clusters (a super) and of block_clusters
// clusters (a block, 8192 triangles on the main path) is spatially tight.
// Only real blocks, ceil(n_clusters / block_clusters), and real clusters,
// ceil(num_tris / 64), are swept: boxes made only of padding are +-inf and
// would pass every slab test. A block's and a super's box span their real
// clusters only.
//
// On the TPU the triangles stream through VMEM in blocks along a sequential
// grid axis, the running best is carried in scratch across grid steps, block
// lists per 4096-ray step come from an XLA-side slab test, and the winner's
// row is re-extracted after every block; all of that exists because VMEM
// holds ~12 MB. Here the planes stay in global memory (a 191k-triangle
// scene's 9 MB of geometry rows sit in the 50 MB L2), a warp streams the
// boxes and geometry of the blocks it visits through its own shared memory,
// and the row is copied once after the traversal.
//
// What bounds it on this card: instructions issued, not bytes. A ray-per-
// thread traversal spends them on 4-byte global loads for every operand, on
// warps whose lanes visit different blocks one after the other with the
// other lanes idle, and on a per-thread sorted block list in local memory.
// What the design does about it (the traversal core is hit_common.cuh's,
// shared with the closest-hit kernel):
//   * the block boxes are staged into the thread block's shared memory in
//     rounds of 64 (2 KB); every lane slab-tests a round's boxes for its ray;
//   * within a round a warp visits blocks together, in the order of each
//     block's nearest entry over the warp's lanes: lane b keeps block b's
//     key (lane b again for block b + 32) in a register, the next block is a
//     redux minimum and a ballot away, and the round's walk ends when the
//     nearest block left starts past every live lane's best. The best
//     carries into the next round. No list, no sort, no local memory, and
//     no bound on the number of blocks (the reference's streaming grid has
//     none either);
//   * on entering a block the warp stages its super and cluster boxes (16 +
//     128 boxes, 4.6 KB) into its own box buffer by cp.async; the lanes that
//     enter the block test supers, then the clusters of the supers they
//     enter, and the warp walks the union of entered clusters, each
//     cluster's 3,072 bytes of geometry rows arriving by cp.async in one of
//     two tiles while the cluster before it is tested;
//   * where few lanes enter a cluster, the 32 lanes share each entering
//     ray's 64 triangle tests (hit_common.cuh:test_cluster), which is where
//     an incoherent wavefront spends its time.
// Shared memory: 2 KB of block boxes plus 8 warps x (4,640 bytes of boxes +
// 6,144 of tiles) = 88 KB, so two thread blocks fit an SM. Rounds share the
// 2 KB: every warp, its rays dead or not, takes each round's barriers.
//
// Ties: blocks are not visited in id order within a round, so a candidate
// wins when (t, id) is lexicographically smaller than the best, and a box is
// culled only when it starts strictly farther than the best (tn <= best_t
// enters). A lower-id triangle at an equal t in a block visited later still
// wins, so the result does not depend on the visiting order: the lowest id
// wins a tie, as in the closest-hit kernel and both plain versions.
//
// Numerics: the pair and box tests are hit_common.cuh's, shared with the
// closest-hit kernel, so t and rows are bit-identical to the plain versions
// (ops/blocked_hit.py, ops/closest_hit.py) wherever the ids agree.

#include "hit_common.cuh"

using namespace rtt;

namespace {

constexpr int kMaxBlocks = 64;  // block boxes a round stages: 2 keys a lane
// a block's boxes are staged a page at a time: up to kPageClusters cluster
// boxes and the supers over them (one more when the page starts inside one)
constexpr int kPageClusters = 128;
constexpr int kPageSupers = kPageClusters / kSuper + 1;
constexpr int kPageBoxes = kPageSupers + kPageClusters;
constexpr unsigned kVisited = 0xffffffffu;  // above every float's key
constexpr size_t kSharedBytes =
    (2 * kMaxBlocks + kWarps * 2 * kPageBoxes) * sizeof(float4) +
    kWarps * 2 * kTileFloats * sizeof(float);

// The warp visits the clusters [c0, c1) of one block for the lanes of
// `enter`: a page of boxes at a time into box_s, then group by group.
__device__ __forceinline__ void visit_block(
    const Ray& r, bool enter, float t_min, int lane, int c0, int c1,
    const float* __restrict__ clu, const float* __restrict__ sup,
    const float* __restrict__ geo, int SP, float4* box_s, float* tiles,
    float* best_t, int* best) {
  for (int p0 = c0; p0 < c1; p0 += kPageClusters) {
    const int p1 = min(p0 + kPageClusters, c1);
    const int s0 = p0 / kSuper, n_sup = (p1 - 1) / kSuper - s0 + 1;
    float4* clu_s = box_s + 2 * kPageSupers;
    __syncwarp();  // the page before this one has been read
    copy_boxes_async(box_s, sup + s0 * kBoxCols, n_sup, lane, 32);
    copy_boxes_async(clu_s, clu + p0 * kBoxCols, p1 - p0, lane, 32);
    copy_commit();
    copy_wait<0>();
    __syncwarp();
    for (int g0 = p0; g0 < p1; g0 += kGroup)
      visit_group<false>(r, enter, t_min, lane, box_s, s0, clu_s, p0, g0,
                         min(g0 + kGroup, p1), geo, SP, tiles, best_t, best);
  }
}

// The warp walks the n_round blocks whose boxes lie in blk_s (blocks b0 on)
// nearest-first for its lanes, folding hits into each lane's best.
__device__ __forceinline__ void visit_round(
    const Ray& r, float t_min, int lane, const float4* blk_s, int b0,
    int n_round, int n_clusters, int block_clusters,
    const float* __restrict__ clu, const float* __restrict__ sup,
    const float* __restrict__ geo, int SP, float4* box_s, float* tiles,
    float* best_t, int* best) {
  // ---- each block's nearest entry over the warp's lanes ------------------
  // lane b keeps the key of block b in key_lo and of block b + 32 in key_hi
  unsigned key_lo = kVisited, key_hi = kVisited;
  float tn, tf;
  for (int b = 0; b < n_round; ++b) {
    unsigned key = kVisited;
    if (r.alive) {
      slab4(blk_s + 2 * b, r, t_min, &tn, &tf);
      if (tf >= tn && tn <= *best_t) key = float_key(tn);
    }
    key = __reduce_min_sync(kFull, key);
    if (lane == (b & 31)) {
      if (b < 32) key_lo = key; else key_hi = key;
    }
  }
  // ---- blocks, nearest first for the warp ---------------------------------
  for (;;) {
    const unsigned nearest = __reduce_min_sync(kFull, min(key_lo, key_hi));
    if (nearest == kVisited) break;
    // no block left starts nearer than this one for any lane: the walk ends
    // once that is past the best of every live lane
    const unsigned farthest_best =
        __reduce_max_sync(kFull, r.alive ? float_key(*best_t) : 0u);
    if (nearest > farthest_best) break;
    int b;
    const unsigned in_lo = __ballot_sync(kFull, key_lo == nearest);
    if (in_lo) {
      b = __ffs(in_lo) - 1;
      if (lane == b) key_lo = kVisited;
    } else {
      b = __ffs(__ballot_sync(kFull, key_hi == nearest)) - 1;
      if (lane == b) key_hi = kVisited;
      b += 32;
    }
    bool enter = false;
    if (r.alive) {
      slab4(blk_s + 2 * b, r, t_min, &tn, &tf);
      enter = tf >= tn && tn <= *best_t;
    }
    if (!__any_sync(kFull, enter)) continue;
    visit_block(r, enter, t_min, lane, (b0 + b) * block_clusters,
                min((b0 + b + 1) * block_clusters, n_clusters), clu, sup, geo,
                SP, box_s, tiles, best_t, best);
  }
}

// Two blocks an SM is what the shared memory allows: up to 128 registers.
template <bool kWantAttrs, bool kTextured>
__global__ void __launch_bounds__(kThreads, 2)
blocked_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const unsigned char* __restrict__ alive, int R,
                   const float* __restrict__ sph, int SP, int n_spheres,
                   const float* __restrict__ geo,
                   const float* __restrict__ tri,
                   const float* __restrict__ clu, int n_clusters,
                   const float* __restrict__ sup,
                   const float* __restrict__ blk, int n_blocks,
                   int block_clusters, const int* __restrict__ copy_map,
                   float t_min, float* __restrict__ t_out,
                   int* __restrict__ id_out, float* __restrict__ rows) {
  extern __shared__ float4 shared[];
  float4* blk_s = shared;  // a round's kMaxBlocks boxes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* box_s = blk_s + 2 * kMaxBlocks + warp * 2 * kPageBoxes;
  float* tiles =
      reinterpret_cast<float*>(blk_s + 2 * kMaxBlocks +
                               kWarps * 2 * kPageBoxes) +
      warp * 2 * kTileFloats;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const Ray r = load_ray_rows(o, d, alive, R, i);
  const bool warp_live = __any_sync(kFull, r.alive);
  float best_t = INFINITY;
  int best = -1;
  // ---- spheres: the lowest ids, visited in id order -----------------------
  if (r.alive) closest_sphere(sph, n_spheres, r, t_min, &best_t, &best);
  for (int b0 = 0; b0 < n_blocks; b0 += kMaxBlocks) {
    const int n_round = min(kMaxBlocks, n_blocks - b0);
    if (b0) __syncthreads();  // every warp is done with the round before
    copy_boxes_async(blk_s, blk + b0 * kBoxCols, n_round, threadIdx.x,
                     kThreads);
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    if (warp_live)
      visit_round(r, t_min, lane, blk_s, b0, n_round, n_clusters,
                  block_clusters, clu, sup, geo, SP, box_s, tiles, &best_t,
                  &best);
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
  return v == 2 ? blocked_hit_kernel<true, true>
       : v == 1 ? blocked_hit_kernel<true, false>
                : blocked_hit_kernel<false, false>;
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

// Bytes of dynamic shared memory a launch takes.
int rtt_blocked_hit_shared_bytes() { return static_cast<int>(kSharedBytes); }

// Thread blocks an SM keeps resident of a variant; 0 when the shared memory
// does not fit.
int rtt_blocked_hit_blocks_per_sm(int want_attrs, int textured) {
  const int v = variant(want_attrs, textured);
  if (allow(v, kSharedBytes) != cudaSuccess) {
    cudaGetLastError();  // a size that does not fit is an answer, not a fault
    return 0;
  }
  return resident_blocks(kernel_of(v), kSharedBytes);
}

// Launches the kernel on `stream` and returns the CUDA error (0 = ok), or
// cudaErrorInvalidValue without launching when block_clusters < 1. All
// pointers are device pointers to contiguous arrays:
//   o, d (R, 3) f32; alive (R,) bytes or null (all alive); sph (SP, 16) f32,
//   its first n_spheres rows the real spheres; geo (TP, 12) f32; tri
//   (TP, 32) f32, (TP, 48) when textured != 0; clu (>= n_clusters, 8) f32;
//   sup (ceil(n_clusters / 8), 8) f32, super s spanning clusters
//   [8 s, 8 s + 8); blk (>= n_blocks, 8) f32, block b spanning clusters
//   [b * block_clusters, (b + 1) * block_clusters); copy_map (2, 26) i32,
//   (2, 40) when textured; t_out (R,) f32; id_out (R,) i32; rows (26, R)
//   f32, (40, R) when textured, written only when want_attrs != 0.
int rtt_blocked_hit(const float* o, const float* d,
                    const unsigned char* alive, int R, const float* sph,
                    int SP, int n_spheres, const float* geo,
                    const float* tri, const float* clu, int n_clusters,
                    const float* sup, const float* blk, int n_blocks,
                    int block_clusters, const int* copy_map, float t_min,
                    int want_attrs, int textured, float* t_out, int* id_out,
                    float* rows, void* stream) {
  if (block_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const int v = variant(want_attrs, textured);
  auto kernel = kernel_of(v);
  const cudaError_t err = allow(v, kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreads);
  const dim3 grid((R + kThreads - 1) / kThreads);
  kernel<<<grid, block, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      o, d, alive, R, sph, SP, n_spheres, geo, tri, clu, n_clusters, sup,
      blk, n_blocks, block_clusters, copy_map, t_min, t_out, id_out, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
