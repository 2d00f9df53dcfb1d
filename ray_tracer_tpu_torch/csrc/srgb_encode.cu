// The linear -> 8-bit sRGB encode of a float32 image, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package encodes on the host in numpy
// (ray_tracer_tpu/io/image.py: to_uint8), and so did the port: a blocking
// copy of the float image into pageable memory, then numpy's clip, power,
// flip and cast, ~25 ms on one core for an 800x800 viewer frame. This kernel
// does it on the card (ray_tracer_tpu_torch/io/image.py: to_uint8 takes it
// for CUDA tensors), and the copy to the host carries a quarter of the
// bytes.
//
// What it computes: out[r, c] = the 8-bit level of x[rows - 1 - r, c] (of
// x[r, c] without `flip`), for rows of row_len values. Not by the curve: the
// card's powf may be 2 ulp off numpy's float32 power, which would move a
// value next to a level boundary. The numpy encode is monotone in x, so
// level k starts at one float32 threshold t_k; the wrapper finds the 255
// thresholds once with numpy's own encode (io/image.srgb_thresholds) and
// the kernel returns the number of thresholds <= x (srgb_encode.cuh). That
// equals the numpy encode bit for bit wherever the table does.
//
// What bounds it on this card: bytes. At 800x800x3 it reads 7.68 MB and
// writes 1.92 MB, 2.9 us at 3.35 TB/s; 1080p is 24.9 MB + 6.2 MB, 9.3 us.
// What the design does about it:
//   * one thread writes 4 bytes with one 32-bit store, fed by one 16-byte
//     load where a row holds a multiple of 4 values (800 x 3 and 1920 x 3
//     do), so a warp reads 512 and writes 128 consecutive bytes;
//   * the table (1,020 B) travels as a kernel argument and each block copies
//     it into shared memory, padded so that the 8 probes of a search meet
//     few bank conflicts; nothing stays on the device between calls;
//   * no transcendental function and no division by a float: 8 compares a
//     value.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "srgb_encode.cuh"

namespace {

constexpr int kThreads = 256;    // threads a block, 4 output bytes each
constexpr int kMaxBlocks = 1056; // 8 blocks of 256 threads on each of 132 SMs

struct Thresholds {
  float t[srgb::kLevels];
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    srgb_encode_kernel(const float* __restrict__ x,
                       unsigned char* __restrict__ out, int n, int rows,
                       int row_len, bool flip,
                       const __grid_constant__ Thresholds thresholds) {
  __shared__ float table[srgb::kTableWords];
  for (int k = threadIdx.x; k < srgb::kLevels; k += blockDim.x)
    table[srgb::slot(k)] = thresholds.t[k];
  __syncthreads();
  const int groups = (n + 3) / 4;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += gridDim.x * blockDim.x)
    srgb::encode_group<kVec>(x, out, g, n, rows, row_len, flip, table);
}

}  // namespace

extern "C" {

// out (rows, row_len) u8 = the levels of x (rows, row_len) f32, rows taken
// in reverse where `flip`, on `stream`. Device pointers, both contiguous;
// rows * row_len < 2^31 - 3. `thresholds`: 255 ascending floats in host
// memory, copied into the launch's arguments. Returns cudaGetLastError()
// (0 = ok).
int rtt_srgb_encode(const float* x, unsigned char* out, int rows, int row_len,
                    int flip, const float* thresholds, void* stream) {
  const int n = rows * row_len;
  if (n > 0) {
    Thresholds tab;
    std::memcpy(tab.t, thresholds, sizeof tab.t);
    const int groups = (n + 3) / 4;
    const int blocks = groups / kThreads + (groups % kThreads != 0);
    const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (row_len % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0)
      srgb_encode_kernel<true><<<grid, kThreads, 0, s>>>(
          x, out, n, rows, row_len, flip != 0, tab);
    else
      srgb_encode_kernel<false><<<grid, kThreads, 0, s>>>(
          x, out, n, rows, row_len, flip != 0, tab);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
