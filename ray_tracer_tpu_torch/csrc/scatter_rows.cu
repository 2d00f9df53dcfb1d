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
//
// Layout: one thread per (ray, column). blockIdx.y is the column and the
// threads of a block run along the ray axis, so a warp reads 32 consecutive
// rays of one SoA column (coalesced) and 32 consecutive ids. The output is
// zeroed with cudaMemsetAsync on the caller's stream, then every live value
// is added with an f32 atomicAdd into out[id * W + c]. Zero cotangents are
// skipped: adding +-0 to a sum that starts at +0 never changes it, and the
// backward hands the kernel many (the unselected sphere or triangle
// columns of each winner).
//
// What bounds it on this card: atomics on few addresses, not bytes. At 1080p
// the kernel reads 2,073,600 x 26 x 4 B = 216 MB of cotangents (65 us at
// 3.35 TB/s), but on a mesh scene ~130 primary rays share each triangle and
// the 16x8 blocked pixel order puts them in the same warps, so atomics to
// one address serialize in L2. Pre-reducing runs of equal ids in a warp or a
// block (shared memory) before the global atomic, and a deterministic
// sort-by-id segmented sum, are later work. The summation order of the
// atomics varies from run to run, so results agree with the plain version
// to f32 rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block, along the ray axis

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int* __restrict__ ids,
                    const float* __restrict__ g, int R, int W,
                    long long col_stride, long long ray_stride, int n_rows,
                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (r >= R) return;
  const int id = ids[r];
  if (id < 0 || id >= n_rows) return;
  const float v = g[c * col_stride + r * ray_stride];
  if (v != 0.0f) atomicAdd(out + static_cast<long long>(id) * W + c, v);
}

}  // namespace

extern "C" {

// Zeroes out (n_rows, W) f32 and scatter-adds g into it, on `stream`.
// Returns cudaGetLastError() (0 = ok). Device pointers: ids (R,) i32;
// g with element (column c, ray r) at g[c * col_stride + r * ray_stride]
// ((W, R) SoA: col_stride R, ray_stride 1; (R, W) rows: 1 and W);
// out (n_rows, W) f32, contiguous.
int rtt_scatter_rows(const int* ids, const float* g, int R, int W,
                     long long col_stride, long long ray_stride, int n_rows,
                     float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 0 || W <= 0 || W > 65535 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_rows) * W * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (R > 0 && n_rows > 0) {
    const dim3 block(kThreads);
    const dim3 grid((R + kThreads - 1) / kThreads, W);
    scatter_rows_kernel<<<grid, block, 0, s>>>(ids, g, R, W, col_stride,
                                               ray_stride, n_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
