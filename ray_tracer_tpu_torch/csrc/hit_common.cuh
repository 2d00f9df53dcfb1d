// Shared device code of the port's ray-query kernels (closest_hit.cu,
// anyhit.cu, blocked_hit.cu): plane layouts, the ray loads, the sphere, box
// and triangle tests, and the warp-cooperative traversal core of all three.
//
// Every expression keeps the association of the plain PyTorch versions
// (ops/closest_hit.py:_sphere_pairs and _mt_pairs, ops/anyhit.py:_slab_pairs,
// which follow the reference's pallas_intersect.py helpers of the same
// names), e.g. (d0*n0 + d1*n1) + d2*n2 and inv = 1/det; t = t_num*inv. The
// libraries are built with -fmad=false and without --use_fast_math
// (utils/build.py), so each test rounds as the plain version's does.
//
// The traversal core (visit_group and below) answers two kinds of query,
// a template argument: the closest hit (closest_hit.cu, blocked_hit.cu) and
// whether anything blocks a shadow segment (anyhit.cu). One warp works on
// its 32 rays together:
//   * boxes are read from shared memory as float4 pairs; the caller stages
//     them there with cp.async (16 bytes a thread);
//   * over a group of up to 32 clusters every lane slab-tests the group's
//     supers (boxes over runs of 8 clusters) and the clusters of the supers
//     it enters, the warp forms the union of the entered clusters
//     (__reduce_or_sync) and walks it once in ascending order;
//   * each cluster of the union is brought into one of the warp's two
//     3,072-byte tile buffers with cp.async while the one before it is
//     tested: its 64 geometry rows [a | e1 | e2 | n], 48 bytes each;
//   * where at least kDenseLanes lanes enter a cluster, each of them tests
//     the 64 triangles (float4 broadcast reads); where fewer do, the warp
//     takes the entering rays one at a time, all 32 lanes testing two
//     triangles each against the ray (rows at a 48-byte stride: float4
//     reads without bank conflicts), and reduces to the closest (redux) or,
//     for a shadow query, to whether any test blocks (one ballot).
//     A sparse or incoherent wavefront so costs ~100 instructions per
//     (ray, cluster) instead of 64 triangle tests with most lanes idle.
// Closest hit: a candidate wins when (t, id) is lexicographically smaller
// than the best, and a box is culled only when it starts strictly farther
// than the best (tn <= best_t enters), so the result does not depend on the
// visiting order or on which lane tests a pair: the lowest id wins a t-tie.
// Shadow query: a box is entered when it starts before the segment's end
// (tn < t_max, the plain version's rule), a lane stops testing at its first
// blocking triangle and leaves the live lanes, and the walk ends once no
// live lane is unblocked. Blocking is an OR, so the order does not matter.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rtt {

constexpr int kCluster = 64;   // triangles per cluster (culling unit)
constexpr int kSuper = 8;      // clusters per super box
constexpr int kGroup = 32;     // clusters per traversal group (a mask word)
constexpr int kSphCols = 16;   // _pack_spheres columns
constexpr int kTriCols = 32;   // _pack_tris columns (untextured)
constexpr int kGeoCols = 12;   // _pack_geo columns: a e1 e2 n
constexpr int kBoxCols = 8;    // box plane columns: lo(3) hi(3) pad(2)
constexpr int kRows = 26;      // merged-table width (untextured)
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = kCluster * kGeoCols;  // one cluster's geometry
constexpr int kTileChunks = kTileFloats / 4;      // ... in 16-byte chunks
// Lanes entering a cluster from which each tests all 64 triangles itself.
// The shared tests cost ~100 instructions per entering ray, the 64 own tests
// ~2,560 per cluster; on an H100, 24 was the fastest of 0, 12, 24, 28 and 33
// on primary and secondary 1080p wavefronts (PERF.md, "Design steps
// measured").
constexpr int kDenseLanes = 24;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDetEps = 1e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float invdx, invdy, invdz;
  bool alive;
};

// a huge finite stand-in for a zero direction component avoids 0*inf
__device__ __forceinline__ void set_inverse(Ray* r) {
  r->invdx = 1.0f / (r->dx == 0.0f ? 1e-30f : r->dx);
  r->invdy = 1.0f / (r->dy == 0.0f ? 1e-30f : r->dy);
  r->invdz = 1.0f / (r->dz == 0.0f ? 1e-30f : r->dz);
}

// Ray i of o, d (R, 3) and alive (R,) bytes, null for all alive, as the
// renderer holds them. A lane past the end (i >= R) is a dead ray: its warp
// still needs it for the collectives.
__device__ __forceinline__ Ray load_ray_rows(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ alive, int R, int i) {
  Ray r;
  if (i < R) {
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.alive = alive == nullptr || alive[i] != 0;
  } else {
    r.ox = r.oy = r.oz = 0.0f;
    r.dx = r.dy = r.dz = 1.0f;
    r.alive = false;
  }
  set_inverse(&r);
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

// The closest valid sphere of the first n rows of the sphere plane sph
// (the real spheres; the rows after them are padding) in id order, folded
// into (best_t, best) where strictly closer: the lowest id wins a tie.
__device__ __forceinline__ void closest_sphere(const float* __restrict__ sph,
                                               int n, const Ray& r,
                                               float t_min, float* best_t,
                                               int* best) {
  const float a_quad = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  float t;
  for (int s = 0; s < n; ++s) {
    const float* p = sph + s * kSphCols;
    if (!(p[4] > 0.5f)) continue;  // valid column
    if (sphere_hit(p, r, a_quad, t_min, &t) && t < *best_t) {
      *best_t = t;
      *best = s;
    }
  }
}

// Slab test of the box [lo, hi]: the ray is inside it for t in [tn, tf]
// (entered when tf >= tn), tn clamped below at t_min.
__device__ __forceinline__ void slab_bounds(float lox, float loy, float loz,
                                            float hix, float hiy, float hiz,
                                            const Ray& r, float t_min,
                                            float* tn, float* tf) {
  const float t1x = (lox - r.ox) * r.invdx, t2x = (hix - r.ox) * r.invdx;
  const float t1y = (loy - r.oy) * r.invdy, t2y = (hiy - r.oy) * r.invdy;
  const float t1z = (loz - r.oz) * r.invdz, t2z = (hiz - r.oz) * r.invdz;
  *tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
              fmaxf(fminf(t1z, t2z), t_min));
  *tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// ... of a box plane row held as two float4 (shared memory)
__device__ __forceinline__ void slab4(const float4* box, const Ray& r,
                                      float t_min, float* tn, float* tf) {
  const float4 b0 = box[0], b1 = box[1];
  slab_bounds(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, t_min, tn, tf);
}

// Moller-Trumbore (cross/determinant form) against the triangle a, e1, e2,
// n = e1 x e2: whether det >= 1e-6 (back faces culled), u, v >= 0,
// u + v <= 1 and t >= t_min, and t.
__device__ __forceinline__ bool triangle_test(
    float ax, float ay, float az, float e1x, float e1y, float e1z, float e2x,
    float e2y, float e2z, float nx, float ny, float nz, const Ray& r,
    float t_min, float* t_out) {
  const float aox = r.ox - ax, aoy = r.oy - ay, aoz = r.oz - az;
  const float det = -((r.dx * nx + r.dy * ny) + r.dz * nz);
  const float t_num = (aox * nx + aoy * ny) + aoz * nz;
  const float daox = aoy * r.dz - aoz * r.dy;  // ao x d
  const float daoy = aoz * r.dx - aox * r.dz;
  const float daoz = aox * r.dy - aoy * r.dx;
  const float u_num = (e2x * daox + e2y * daoy) + e2z * daoz;
  const float v_num = -((e1x * daox + e1y * daoy) + e1z * daoz);
  const float inv = 1.0f / det;
  const float t = t_num * inv;
  const float u = u_num * inv;
  const float v = v_num * inv;
  *t_out = t;
  return det >= kDetEps && t >= t_min && u >= 0.0f && v >= 0.0f &&
         u + v <= 1.0f;
}

// ... against a geometry row held as three float4 (shared memory)
__device__ __forceinline__ bool triangle_hit4(const float4& q0,
                                              const float4& q1,
                                              const float4& q2, const Ray& r,
                                              float t_min, float* t_out) {
  return triangle_test(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x,
                       q2.y, q2.z, q2.w, r, t_min, t_out);
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

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (cp.async, 16 bytes a thread)
// ---------------------------------------------------------------------------

// Starts the copy of the 16 bytes at global address src to shared address
// dst; both 16-byte aligned.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g)
               : "memory");
}

// Closes the group of this thread's copies started since the last commit.
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's groups are still in flight.
// The other threads' copies are visible only after a barrier behind it.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copy of `boxes` box rows (32 bytes each) from src to dst,
// thread `rank` of `n_threads` taking every n_threads-th 16-byte chunk.
__device__ __forceinline__ void copy_boxes_async(float4* dst,
                                                 const float* __restrict__ src,
                                                 int boxes, int rank,
                                                 int n_threads) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int k = rank; k < 2 * boxes; k += n_threads)
    copy16_async(dst + k, src4 + k);
}

// ---------------------------------------------------------------------------
// Warp-cooperative traversal core
// ---------------------------------------------------------------------------

// Order-preserving map from float to unsigned (and back), for redux.sync,
// which reduces integers only: a < b as floats iff key(a) < key(b).
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Whether the candidate (t, id) beats the best so far: closer, or as close
// with a lower id.
__device__ __forceinline__ bool closer(float t, int id, float best_t,
                                       int best) {
  return t < best_t || (t == best_t && id < best);
}

// Whether a box the ray is inside for t in [tn, tf] (tf >= tn) is entered:
// by a closest-hit query unless it starts farther than the best so far,
// `bound` (tn <= best_t: an equal-t hit of a lower id is still found); by a
// shadow query unless it starts at or past the segment's end, `bound`
// (tn < t_max, the rule of ops/anyhit.py:anyhit_reference).
template <bool kAny>
__device__ __forceinline__ bool enters(float tn, float tf, float bound) {
  return kAny ? (tf >= tn && tn < bound) : (tf >= tn && tn <= bound);
}

// The warp tests the cluster whose geometry rows lie in `tile` (shared) and
// whose first triangle has id id0, for the lanes of `entering` (warp-uniform,
// not 0; `enter` is this lane's bit). All 32 lanes call it. Rows of padding
// in the scene's last cluster are degenerate triangles and hit nothing.
//   closest hit (kAny false): the hits are folded into each entering lane's
//     (best_t, best);
//   shadow query (kAny true): *best_t is the segment's end t_max, which
//     does not change, and *best becomes 1 at the lane's first blocking hit
//     (t < t_max). A dense lane stops testing there; the shared branch
//     answers each entering ray with one ballot, no minimum and no id.
template <bool kAny>
__device__ __forceinline__ void test_cluster(const float* tile, int id0,
                                             unsigned entering, bool enter,
                                             const Ray& r, float t_min,
                                             int lane, float* best_t,
                                             int* best) {
  const float4* q = reinterpret_cast<const float4*>(tile);
  if (__popc(entering) >= kDenseLanes) {
    // many lanes: each tests the 64 triangles against its own ray
    if (enter) {
      float t;
      for (int k = 0; k < kCluster; ++k) {
        if constexpr (kAny) {
          if (triangle_hit4(q[3 * k], q[3 * k + 1], q[3 * k + 2], r, t_min,
                            &t) &&
              t < *best_t) {
            *best = 1;
            break;
          }
        } else {
          if (triangle_hit4(q[3 * k], q[3 * k + 1], q[3 * k + 2], r, t_min,
                            &t) &&
              closer(t, id0 + k, *best_t, *best)) {
            *best_t = t;
            *best = id0 + k;
          }
        }
      }
    }
    return;
  }
  // few lanes: the entering rays one at a time, lane l testing triangles l
  // and l + 32 against the ray
  const float4 a0 = q[3 * lane], a1 = q[3 * lane + 1], a2 = q[3 * lane + 2];
  const float4 b0 = q[3 * (lane + 32)], b1 = q[3 * (lane + 32) + 1],
               b2 = q[3 * (lane + 32) + 2];
  while (entering) {
    const int j = __ffs(entering) - 1;
    entering &= entering - 1;
    Ray rj;
    rj.ox = __shfl_sync(kFull, r.ox, j);
    rj.oy = __shfl_sync(kFull, r.oy, j);
    rj.oz = __shfl_sync(kFull, r.oz, j);
    rj.dx = __shfl_sync(kFull, r.dx, j);
    rj.dy = __shfl_sync(kFull, r.dy, j);
    rj.dz = __shfl_sync(kFull, r.dz, j);
    float t0, t1;
    if constexpr (kAny) {
      // blocked when any of the 64 tests hits before the segment's end
      const bool h0 = triangle_hit4(a0, a1, a2, rj, t_min, &t0) &&
                      t0 < *best_t;
      const bool h1 = triangle_hit4(b0, b1, b2, rj, t_min, &t1) &&
                      t1 < *best_t;
      if (__any_sync(kFull, h0 || h1) && lane == j) *best = 1;
    } else {
      // the closest by redux, the lowest id on a tie
      const unsigned never = float_key(INFINITY);
      if (!triangle_hit4(a0, a1, a2, rj, t_min, &t0)) t0 = INFINITY;
      if (!triangle_hit4(b0, b1, b2, rj, t_min, &t1)) t1 = INFINITY;
      const unsigned k_min =
          __reduce_min_sync(kFull, min(float_key(t0), float_key(t1)));
      if (k_min == never) continue;
      const float t = key_float(k_min);
      int id;
      const unsigned w0 = __ballot_sync(kFull, t0 == t);
      if (w0) {
        id = id0 + __ffs(w0) - 1;
      } else {
        id = id0 + 32 + __ffs(__ballot_sync(kFull, t1 == t)) - 1;
      }
      if (lane == j && closer(t, id, *best_t, *best)) {
        *best_t = t;
        *best = id;
      }
    }
  }
}

// Starts the warp's copy of cluster c's geometry rows (geo: (TP, 12) in
// global memory) into `tile` (shared, kTileFloats floats).
__device__ __forceinline__ void copy_cluster_async(
    float* tile, const float* __restrict__ geo, int c, int lane) {
  float4* dst = reinterpret_cast<float4*>(tile);
  const float4* src = reinterpret_cast<const float4*>(geo) +
                      static_cast<size_t>(c) * kTileChunks;
#pragma unroll
  for (int k = 0; k < kTileChunks / 32; ++k)
    copy16_async(dst + lane + 32 * k, src + lane + 32 * k);
  copy_commit();
}

// The warp visits the clusters [g0, g1) (at most kGroup of them) for its 32
// rays; all 32 lanes call it, `live` marking the lanes that take part
// (for a shadow query: alive and not yet blocked).
//   sup_s, clu_s: shared-memory boxes (two float4 each) of the supers from
//     s_base on and of the clusters from c_base on; super s spans clusters
//     [8 s, 8 s + 8), clipped here to [g0, g1);
//   geo: the (TP, 12) geometry plane in global memory; SP: the id of
//     triangle 0; tiles: the warp's two tile buffers (2 kTileFloats floats);
//   best_t, best: the lane's state, as test_cluster<kAny> says.
template <bool kAny>
__device__ __forceinline__ void visit_group(
    const Ray& r, bool live, float t_min, int lane, const float4* sup_s,
    int s_base, const float4* clu_s, int c_base, int g0, int g1,
    const float* __restrict__ geo, int SP, float* tiles, float* best_t,
    int* best) {
  // this lane's entered clusters, bit c - g0
  unsigned mine = 0;
  if (live) {
    float tn, tf;
    for (int s = g0 / kSuper; s <= (g1 - 1) / kSuper; ++s) {
      slab4(sup_s + 2 * (s - s_base), r, t_min, &tn, &tf);
      if (!enters<kAny>(tn, tf, *best_t)) continue;
      const int c_end = min((s + 1) * kSuper, g1);
      for (int c = max(s * kSuper, g0); c < c_end; ++c) {
        slab4(clu_s + 2 * (c - c_base), r, t_min, &tn, &tf);
        if (enters<kAny>(tn, tf, *best_t)) mine |= 1u << (c - g0);
      }
    }
  }
  unsigned todo = __reduce_or_sync(kFull, mine);  // the warp's union
  if (!todo) return;
  int cur = __ffs(todo) - 1, buf = 0;
  todo &= todo - 1;
  copy_cluster_async(tiles, geo, g0 + cur, lane);
  while (cur >= 0) {
    int next = -1;
    if (todo) {  // the next cluster's copy flies while this one is tested
      next = __ffs(todo) - 1;
      todo &= todo - 1;
      copy_cluster_async(tiles + (buf ^ 1) * kTileFloats, geo, g0 + next,
                         lane);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncwarp();  // every lane's chunks of the current tile have landed
    bool enter = false;
    if ((mine >> cur) & 1u) {
      if constexpr (kAny) {
        enter = !*best;  // the segment's end stays: only a block since
      } else {
        // the best may have come closer since the mask was made: test again
        float tn, tf;
        slab4(clu_s + 2 * (g0 + cur - c_base), r, t_min, &tn, &tf);
        enter = tf >= tn && tn <= *best_t;
      }
    }
    const unsigned entering = __ballot_sync(kFull, enter);
    if (entering)
      test_cluster<kAny>(tiles + buf * kTileFloats,
                         SP + (g0 + cur) * kCluster, entering, enter, r,
                         t_min, lane, best_t, best);
    __syncwarp();  // the tile is free for the copy after next
    if constexpr (kAny) {
      // every live lane blocked: the walk ends, its copy in flight landed
      if (!__any_sync(kFull, live && !*best)) {
        copy_wait<0>();
        return;
      }
    }
    cur = next;
    buf ^= 1;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;  // devices whose granted size is remembered

// Allows `kernel` shared_bytes of dynamic shared memory on the current device
// (above 48 KB a launch needs the attribute). `granted` is the caller's record
// for this kernel, kMaxDevices zeroed entries: the runtime is asked only when
// a launch needs more than the device was granted before, so a path's
// launches pay for it once. The error of a size the device cannot give is
// returned like a launch error.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t shared_bytes, size_t* granted) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && shared_bytes <= granted[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared_bytes));
  if (err == cudaSuccess && known) granted[device] = shared_bytes;
  return err;
}

// The thread blocks of kThreads with shared_bytes of dynamic shared memory
// that an SM keeps resident of `kernel`, which has been allowed that much;
// 0 when the query fails.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t shared_bytes) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, shared_bytes) != cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace rtt
