// Correlative window scores: score[q, t, a, b] = sum_beam w[q, beam] *
// M[iy[q, t, beam] + dy, ix[q, t, beam] + dx], dx = a - win_x,
// dy = b - win_y; an off-map read is 0 (Unknown).
//
// Replaces the TPU kernel
// my_lidar_graph_slam_tpu/ops/pallas/correlate_mxu.py::window_scores_mxu
// (body _kernel_bb) and its 7x7 block assembly window_scores_mxu_wide
// (ops/matchers_mxu.py): this kernel takes any window directly.
//
// What bounds it on an H100: map reads. Each output needs one read per
// weighted beam (up to 1024), so at the loop-detection shape of the
// default config (4 x 401 x 41 x 41 outputs, 384 beams) it issues ~1e9
// 4-byte reads against ~1e9 FMAs, while the bytes that must come from
// device memory are only the inputs (a 9.4 MB map, ~5 MB of cells) and
// the output. The TPU kernel
// avoided scalar gathers with one-hot matmuls on VMEM tiles; on Hopper a
// gather from L1/L2 is cheap, so the design is the plain one:
//  * one thread per (q, t, dx, dy); dx is the fastest thread index, so a
//    warp reads neighbouring map columns of one row (coalesced), and all
//    threads of a block share (q, t), so the loads of ix/iy/w are
//    broadcasts;
//  * the map stays in global memory: a 1536^2 float map is 9.4 MB and
//    stays resident in the 50 MB L2, neighbouring thetas reuse it in L1;
//  * beams are summed in order in a register; zero-weight beams are
//    skipped, so far-off padded beams neither fault nor cost reads;
//  * every address is bounds-checked in 64-bit integers before it is
//    formed;
//  * map_idx (optional, [Q]) selects the base of a stacked [M, H, W] map.
// Making it fast (shared-memory map patches, several outputs per thread)
// is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void window_scores_kernel(const float* __restrict__ maps, int h,
                                     int w, const int* __restrict__ ix,
                                     const int* __restrict__ iy,
                                     const float* __restrict__ weight,
                                     const int* __restrict__ map_idx, int nt,
                                     int nb, int win_x, int win_y,
                                     float* __restrict__ out) {
  const int wxn = 2 * win_x + 1;
  const int wyn = 2 * win_y + 1;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= wxn * wyn) return;
  const int t = blockIdx.y;
  const int q = blockIdx.z;
  const int a = cell % wxn;  // dx index (fast)
  const int b = cell / wxn;  // dy index
  const int64_t dx = a - win_x;
  const int64_t dy = b - win_y;

  const float* m =
      maps + (map_idx != nullptr ? (int64_t)map_idx[q] * h * w : 0);
  const int64_t row = ((int64_t)q * nt + t) * nb;
  const int* ixr = ix + row;
  const int* iyr = iy + row;
  const float* wr = weight + (int64_t)q * nb;

  float s = 0.0f;
  for (int beam = 0; beam < nb; ++beam) {
    const float wb = wr[beam];
    if (wb == 0.0f) continue;
    const int64_t x = (int64_t)ixr[beam] + dx;
    const int64_t y = (int64_t)iyr[beam] + dy;
    if (x >= 0 && x < w && y >= 0 && y < h) s += wb * m[y * w + x];
  }
  out[(((int64_t)q * nt + t) * wxn + a) * wyn + b] = s;
}

}  // namespace

extern "C" int window_scores_f32(const float* maps, int h, int w,
                                 const int* ix, const int* iy,
                                 const float* weight, const int* map_idx,
                                 int q, int nt, int nb, int win_x, int win_y,
                                 float* out, void* stream) {
  const int cells = (2 * win_x + 1) * (2 * win_y + 1);
  int threads = ((cells + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((cells + threads - 1) / threads, nt, q);
  window_scores_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      maps, h, w, ix, iy, weight, map_idx, nt, nb, win_x, win_y, out);
  return (int)cudaGetLastError();
}
