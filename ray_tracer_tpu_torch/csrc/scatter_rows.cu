// Scatter-add of per-ray cotangent rows into the merged attribute table, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels ray_tracer_tpu/ops/pallas_intersect.py:
//   * _make_scatter_soa_kernel (via _scatter_rows_soa_call and
//     scatter_rows_soa_pallas): cotangents in SoA orientation g (W, R);
//   * _make_scatter_kernel (via _scatter_rows_call and scatter_rows_pallas):
//     the row-major form g (R, W).
// One kernel covers both: the caller passes the strides of g.
//
// What it computes: out = zeros((n_rows, W)); for every ray r and column c
// with 0 <= ids[r] < n_rows, out[ids[r], c] += g[c, r]. Ids outside
// [0, n_rows) are dropped: the backward of the winner-row extraction routes
// miss lanes to n_rows (ray_tracer_tpu/ops/intersect.py:_winner_rows_bwd).
// W is any width from 1 to 65,535 (26 untextured, 40 with textures).
//
// What bounds it on this card: bytes, once the atomics are few. At 1080p the
// kernel reads 2,073,600 x (26 + 1) x 4 B = 224 MB of cotangents and ids
// (67 us at 3.35 TB/s). One f32 atomicAdd per (ray, column) is ~54 M
// atomics, and on a mesh scene ~130 primary rays share each triangle: the
// 16x8 blocked pixel order puts them in the same warps, and atomics to one
// address serialize in L2. What the design does about it:
//   * one thread per ray, a warp on 32 consecutive rays: each lane reads its
//     id once and walks the W columns; for one column the warp reads 32
//     consecutive floats of SoA g, kLoads columns in flight at a time;
//   * the lanes of equal ids are grouped once per ray (__match_any_sync;
//     the dropped ones share a group that never adds) and each group sums a
//     column in a fixed tree of shuffles (the partners found once per
//     ray), so its lowest lane makes one atomic add for the group;
//   * a column in which the whole warp holds zeros is skipped (one vote):
//     real cotangents are mostly zero (the sphere columns of a triangle
//     winner, and miss lanes, which the backward zeroes), and adding +-0 to
//     a sum that starts at +0 never changes it.
// Pre-reducing across the thread block in shared memory as well measured
// slower on dense cotangents and on a step's bounce-0 ones, faster only on
// the sparse bounce 1 (PERF.md, the scatter-add's design table).
//
// Numerics: the groups' sums are added into a float64 table (the caller's
// `wide`, zeroed here), which is then rounded into out. Real cotangents
// share a sign, and a sphere's entry sums ~1e5 lanes at 1080p: f32 atomics
// in arrival order err there by more than 1e-5 of the sum, and atom.add.f32
// flushes subnormal values to zero; f64 atomics keep both, so what is left
// is each group's f32 tree (at most 5 adds) and the final rounding. The
// order of the atomics varies from run to run, so two runs can differ in
// the last bit where a sum lies next to a rounding boundary.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rays per thread block, one a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLoads = 8;      // columns whose loads a lane keeps in flight
constexpr int kRounds = 5;     // tree rounds that sum 32 lanes
constexpr int kDropped = -1;   // the id of every dropped lane's group

// A lane's group: the lanes of its warp that hold its id.
struct Group {
  int rank;           // lanes of the group below this one
  int src[kRounds];   // round k's partner: the lane of rank + 2^k where rank
                      // is a multiple of 2^(k+1) and that lane exists, else
                      // this lane itself
  int rounds;         // warp-uniform: the rounds the largest group needs
};

// The group of this lane's key (a valid id, or kDropped) and its partners.
__device__ __forceinline__ Group group_of(int key, bool valid, int lane) {
  Group grp;
  const unsigned peers = __match_any_sync(kFull, key);
  grp.rank = __popc(peers & ((1u << lane) - 1u));
  const int size = __popc(peers);
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int o = 1 << k;
    grp.src[k] = (grp.rank % (2 * o) == 0 && grp.rank + o < size)
                     ? static_cast<int>(__fns(peers, 0, grp.rank + o + 1))
                     : lane;
  }
  const int largest = __reduce_max_sync(kFull, valid ? size : 1);
  grp.rounds = 32 - __clz(largest - 1);  // ceil(log2(largest))
  return grp;
}

// The sum of v over the lane's group, at the group's lowest lane (rank 0):
// round k adds the partial sum 2^k ranks up, so every group sums in the
// same order. All 32 lanes call it.
__device__ __forceinline__ float group_sum(float v, const Group& grp,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (k < grp.rounds) {  // warp-uniform
      const float other = __shfl_sync(kFull, v, grp.src[k]);
      if (grp.src[k] != lane) v += other;
    }
  }
  return v;
}


__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int* __restrict__ ids,
                    const float* __restrict__ g, int R, int W,
                    long long col_stride, long long ray_stride, int n_rows,
                    double* __restrict__ wide) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  int id = r < R ? ids[r] : kDropped;
  const bool valid = id >= 0 && id < n_rows;
  if (!valid) id = kDropped;
  const Group grp = group_of(id, valid, lane);
  const bool leader = valid && grp.rank == 0;
  const float* gr = g + static_cast<long long>(r) * ray_stride;
  double* row = wide + static_cast<long long>(valid ? id : 0) * W;
  for (int c0 = 0; c0 < W; c0 += kLoads) {
    float v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      v[k] = valid && c0 + k < W ? gr[(c0 + k) * col_stride] : 0.0f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (c0 + k >= W || !__any_sync(kFull, v[k] != 0.0f)) continue;
      const float s = group_sum(v[k], grp, lane);
      if (leader && s != 0.0f) atomicAdd(row + c0 + k, static_cast<double>(s));
    }
  }
}

// out = wide, rounded to f32
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const double* __restrict__ wide, long long n,
              float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < n) out[i] = static_cast<float>(wide[i]);
}

}  // namespace

extern "C" {

// Scatter-adds g into wide (n_rows, W) f64, zeroed first, and rounds it
// into out (n_rows, W) f32, on `stream`. Returns cudaGetLastError() (0 =
// ok). Device pointers: ids (R,) i32; g with element (column c, ray r) at
// g[c * col_stride + r * ray_stride] ((W, R) SoA: col_stride R, ray_stride
// 1; (R, W) rows: 1 and W); wide and out contiguous.
int rtt_scatter_rows(const int* ids, const float* g, int R, int W,
                     long long col_stride, long long ray_stride, int n_rows,
                     double* wide, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 0 || W <= 0 || W > 65535 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_rows) * W;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaMemsetAsync(wide, 0, n * sizeof(double), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0)
    scatter_rows_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        ids, g, R, W, col_stride, ray_stride, n_rows, wide);
  narrow_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(wide, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
