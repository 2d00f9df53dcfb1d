// The body of the linear -> 8-bit sRGB encode (srgb_encode.cu): the level
// of one value by its search of the threshold table, and the four output
// bytes of one thread. It uses no CUDA built-in beyond float4, so the tests
// compile it as host C++ with __device__ and __forceinline__ defined away
// (tests/test_torch_srgb_encode.py).

#pragma once

namespace srgb {

constexpr int kLevels = 255;                     // thresholds of levels 1..255
constexpr int kTableWords = kLevels + kLevels / 32;  // the padded table

// Where threshold k lies in the padded table: one word of padding after
// every 32 puts the probes of one search step, which all lie at the same
// offset modulo 32 in the plain table, in different banks.
__device__ __forceinline__ int slot(int k) { return k + (k >> 5); }

// The level of x: the number of thresholds <= x, by a branchless search of
// the ascending table in 8 steps of 128, 64, ..., 1 (they add up to 255, so
// no probe passes entry 254). A comparison with NaN is false: NaN gives 0,
// as numpy's cast of NaN to uint8 does on x86; -inf and x < 0 give 0, +inf
// and x > 1 give 255, as the clip to [0, 1] does.
__device__ __forceinline__ unsigned level(const float* table, float x) {
  int pos = 0;
#pragma unroll
  for (int step = 128; step > 0; step >>= 1)
    pos += table[slot(pos + step - 1)] <= x ? step : 0;
  return static_cast<unsigned>(pos);
}

// Output bytes [4g, 4g + 4) of the n = rows * row_len of the image, each
// the level of its input value; with `flip`, output row r reads input row
// rows - 1 - r. kVec (row_len % 4 == 0 and x 16-byte aligned): the four
// bytes lie in one row and come from one float4 load. Otherwise each byte
// finds its own row, and the last group of an n that 4 does not divide is
// stored byte by byte. `out` is 4-byte aligned.
template <bool kVec>
__device__ __forceinline__ void encode_group(const float* x,
                                             unsigned char* out, int g,
                                             int n, int rows, int row_len,
                                             bool flip, const float* table) {
  const int e = 4 * g;
  if (kVec) {
    const int r = e / row_len;
    const int src = (flip ? rows - 1 - r : r) * row_len + (e - r * row_len);
    const float4 v = *reinterpret_cast<const float4*>(x + src);
    *reinterpret_cast<unsigned*>(out + e) =
        level(table, v.x) | level(table, v.y) << 8 |
        level(table, v.z) << 16 | level(table, v.w) << 24;
    return;
  }
  const int m = n - e < 4 ? n - e : 4;
  unsigned b[4] = {0, 0, 0, 0};
  for (int i = 0; i < m; ++i) {
    const int o = e + i, r = o / row_len;
    b[i] = level(table, x[flip ? (rows - 1 - r) * row_len + (o - r * row_len)
                                : o]);
  }
  if (m == 4) {
    *reinterpret_cast<unsigned*>(out + e) =
        b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
  } else {
    for (int i = 0; i < m; ++i) out[e + i] = static_cast<unsigned char>(b[i]);
  }
}

}  // namespace srgb
