// Helpers shared by the kernels of csrc/: map addressing and bounds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Base of query q's map in a stacked [M, H, W] array (map_idx[Q]), or the
// single [H, W] map when map_idx is null.
__device__ __forceinline__ const float* map_base(const float* maps,
                                                 const int* map_idx, int q,
                                                 int h, int w) {
  return maps + (map_idx != nullptr ? (int64_t)map_idx[q] * h * w : 0);
}

// Whether cell (x, y) lies on an h x w map; 64-bit so that any int32 cell
// index plus a window offset is tested without overflow.
__device__ __forceinline__ bool on_map(int64_t x, int64_t y, int h, int w) {
  return x >= 0 && x < w && y >= 0 && y < h;
}

// Map value at (x, y), or 0 (Unknown) off the map.
__device__ __forceinline__ float read_cell(const float* m, int h, int w,
                                           int64_t x, int64_t y) {
  return on_map(x, y, h, w) ? __ldg(m + y * w + x) : 0.0f;
}
