// Greedy-endpoint cost at the 7 central-difference poses of each query:
// raw[q, p] = sum over masked beams of table[c_min(q, p, beam)], where
// c_min is the smallest dx^2 + dy^2 over the usable cells of the beam's
// (2k+1)^2 kernel (a cell is usable when its hit and missed values are both
// known, hit >= thr and missed <= thr), and table[2(k+1)^2] is the value of
// a beam with no usable cell. The caller turns raw into the cost and the
// covariance (cost = -scaling * raw, cov = g g^T + 0.01 I).
//
// Replaces the TPU kernel
// my_lidar_graph_slam_tpu/ops/pallas/greedy_cost_mxu.py::greedy_cost_cov_mxu
// (body _kernel, selector _selector_matrix), which served only
// kernel_size == 1 and only while a beam's read set fit a 17-row tile.
// This kernel takes any kernel_size and any range.
//
// What bounds it on an H100: launch latency and map reads. Per beam it reads
// 2 (2k+3)^2 + 4 (2k+1)^2 map cells (86 at k = 1), about 1e5 reads per
// call at the main path's shapes, all served from L2; the TPU
// kernel's one-hot matmuls existed only to avoid scalar gathers, which
// Hopper does natively. The design:
//  * one block per query, threads over beams;
//  * each thread reads its beam's hit and missed cells once for the five
//    axis poses (base, +-x, +-y: an extended (2k+3)^2 patch around the
//    base cells, since a +-resolution pose shift moves every cell by exactly
//    one), and the (2k+1)^2 kernels of the two theta poses, as
//    ops/cost.py:141-196 of the JAX package dedups them;
//  * like the TPU kernel's class-count matmul, it counts beams per
//    (pose, distance class) instead of summing floats: integer counts in
//    shared memory are exact in any order, and the 7 sums
//    sum_c count * table[c] are then formed in a fixed order without FMA
//    contraction, so the result does not change from run to run and equals
//    the plain version bit for bit;
//  * the distance-class values come from a table the caller computes in
//    PyTorch, and the cell preparation (cos, sin, floor) stays in PyTorch
//    as well, shared with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoses = 7;

__device__ __forceinline__ float read_cell(const float* m, int h, int w,
                                           int64_t x, int64_t y) {
  return (x >= 0 && x < w && y >= 0 && y < h) ? m[y * w + x] : 0.0f;
}

__device__ __forceinline__ bool usable(float hv, float mv, float thr) {
  return hv != 0.0f && mv != 0.0f && hv >= thr && mv <= thr;
}

// cells: int32 [Q, 4, 3, NB] = (hit x, hit y, missed x, missed y) for the
// (base, +theta, -theta) angles. Dynamic shared memory: int [7 * C].
__global__ void greedy_cost_kernel(const float* __restrict__ maps, int h,
                                   int w, const int* __restrict__ cells,
                                   const unsigned char* __restrict__ mask,
                                   const int* __restrict__ map_idx,
                                   const float* __restrict__ table, int nb,
                                   int k, float thr, float* __restrict__ raw) {
  extern __shared__ int counts[];
  const int q = blockIdx.x;
  const int none = 2 * (k + 1) * (k + 1);
  const int num_classes = none + 1;
  for (int i = threadIdx.x; i < kPoses * num_classes; i += blockDim.x)
    counts[i] = 0;
  __syncthreads();

  const float* m =
      maps + (map_idx != nullptr ? (int64_t)map_idx[q] * h * w : 0);
  const int* c = cells + (int64_t)q * 12 * nb;
  const unsigned char* mk = mask + (int64_t)q * nb;
  // Pose order (base, +x, +y, +theta, -x, -y, -theta); the axis poses'
  // cell shifts (sx, sy).
  const int shift_pose[5] = {0, 1, 2, 4, 5};
  const int shift_x[5] = {0, 1, 0, -1, 0};
  const int shift_y[5] = {0, 0, 1, 0, -1};

  for (int beam = threadIdx.x; beam < nb; beam += blockDim.x) {
    if (mk[beam] == 0) continue;
    int cmin[kPoses];
    for (int p = 0; p < kPoses; ++p) cmin[p] = none;

    // Axis poses from the extended patch around the base cells.
    const int64_t hx = c[(0 * 3 + 0) * nb + beam];
    const int64_t hy = c[(1 * 3 + 0) * nb + beam];
    const int64_t mx = c[(2 * 3 + 0) * nb + beam];
    const int64_t my = c[(3 * 3 + 0) * nb + beam];
    for (int ey = -k - 1; ey <= k + 1; ++ey) {
      for (int ex = -k - 1; ex <= k + 1; ++ex) {
        const float hv = read_cell(m, h, w, hx + ex, hy + ey);
        const float mv = read_cell(m, h, w, mx + ex, my + ey);
        if (!usable(hv, mv, thr)) continue;
        for (int s = 0; s < 5; ++s) {
          const int dx = ex - shift_x[s];
          const int dy = ey - shift_y[s];
          if (dx < -k || dx > k || dy < -k || dy > k) continue;
          const int cls = dx * dx + dy * dy;
          const int p = shift_pose[s];
          if (cls < cmin[p]) cmin[p] = cls;
        }
      }
    }
    // Theta poses: their rotated endpoints need their own kernels.
    for (int a = 1; a <= 2; ++a) {
      const int p = a == 1 ? 3 : 6;
      const int64_t thx = c[(0 * 3 + a) * nb + beam];
      const int64_t thy = c[(1 * 3 + a) * nb + beam];
      const int64_t tmx = c[(2 * 3 + a) * nb + beam];
      const int64_t tmy = c[(3 * 3 + a) * nb + beam];
      for (int dy = -k; dy <= k; ++dy) {
        for (int dx = -k; dx <= k; ++dx) {
          const float hv = read_cell(m, h, w, thx + dx, thy + dy);
          const float mv = read_cell(m, h, w, tmx + dx, tmy + dy);
          if (!usable(hv, mv, thr)) continue;
          const int cls = dx * dx + dy * dy;
          if (cls < cmin[p]) cmin[p] = cls;
        }
      }
    }
    for (int p = 0; p < kPoses; ++p)
      atomicAdd(&counts[p * num_classes + cmin[p]], 1);
  }
  __syncthreads();

  if (threadIdx.x < kPoses) {
    const int p = threadIdx.x;
    float acc = 0.0f;
    for (int cls = 0; cls < num_classes; ++cls)
      acc = __fadd_rn(acc, __fmul_rn((float)counts[p * num_classes + cls],
                                     table[cls]));
    raw[q * kPoses + p] = acc;
  }
}

}  // namespace

extern "C" int greedy_cost_f32(const float* maps, int h, int w,
                               const int* cells, const unsigned char* mask,
                               const int* map_idx, const float* table, int q,
                               int nb, int k, float thr, float* raw,
                               void* stream) {
  const size_t shared = sizeof(int) * kPoses * (2 * (k + 1) * (k + 1) + 1);
  greedy_cost_kernel<<<q, kThreads, shared, (cudaStream_t)stream>>>(
      maps, h, w, cells, mask, map_idx, table, nb, k, thr, raw);
  return (int)cudaGetLastError();
}
