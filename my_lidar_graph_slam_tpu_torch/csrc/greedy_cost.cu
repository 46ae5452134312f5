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
// What bounds it on an H100: latency. Per beam it reads 2 (2k+3)^2 +
// 4 (2k+1)^2 map cells (86 at k = 1), ~3e4 reads per call at the main
// path's shapes, all from L2; the bytes and operations take nanoseconds,
// so a call costs one launch plus the longest chain of dependent reads.
// The design keeps that chain short:
//  * the grid covers (beam chunk, q): one thread per beam, 64 beams to a
//    block, so a call of Q queries of 384 beams runs 6 Q blocks over the
//    card instead of Q;
//  * the body is a template on k, instantiated fully unrolled for k = 1
//    (the default config) and k = 2, so all of a beam's reads can be in
//    flight at once; any other kernel_size takes the same body with k read
//    at run time;
//  * each thread reads its beam's hit and missed cells once for the five
//    axis poses (base, +-x, +-y: an extended (2k+3)^2 patch around the base
//    cells, since a +-resolution pose shift moves every cell by exactly
//    one), and the (2k+1)^2 kernels of the two theta poses, as
//    ops/cost.py:141-196 of the JAX package dedups them;
//  * like the TPU kernel's class-count matmul, it counts beams per
//    (pose, distance class) instead of summing floats: a block counts in
//    shared memory and adds its counts to a global int32 [Q, 7, C] buffer,
//    both with integer atomics, which are exact in any order;
//  * one launch: the last block to finish (a __threadfence and an atomic
//    ticket tell it so) forms the 7 Q sums sum_c count * table[c] in class
//    order without FMA contraction, so the result does not change from run
//    to run and equals the plain version bit for bit, and then zeroes the
//    counts and the ticket for the next call. The scratch
//    (int32 [1 + Q * 7 * C]: ticket, counts) is the wrapper's, allocated
//    zeroed once per device and stream, so calls on one stream run in
//    order over it and two streams never share it;
//  * the distance-class values come from a table the caller computes in
//    PyTorch, and the cell preparation (cos, sin, floor) stays in PyTorch
//    as well, shared with the plain version.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kPoses = 7;

__device__ __forceinline__ bool usable(float hv, float mv, float thr) {
  return hv != 0.0f && mv != 0.0f && hv >= thr && mv <= thr;
}

// cells: int32 [Q, 4, 3, NB] = (hit x, hit y, missed x, missed y) for the
// (base, +theta, -theta) angles. Dynamic shared memory: int [7 * C].
// KT > 0 fixes k at compile time; KT == 0 reads k_rt.
template <int KT>
__global__ void __launch_bounds__(kThreads)
    greedy_cost_kernel(const float* __restrict__ maps, int h, int w,
                       const int* __restrict__ cells,
                       const unsigned char* __restrict__ mask,
                       const int* __restrict__ map_idx,
                       const float* __restrict__ table, int nq, int nb,
                       int k_rt, float thr, int* __restrict__ scratch,
                       float* __restrict__ raw) {
  extern __shared__ int counts[];
  __shared__ bool last;
  const int k = KT > 0 ? KT : k_rt;
  const int q = blockIdx.y;
  const int none = 2 * (k + 1) * (k + 1);
  const int num_classes = none + 1;
  const int per_query = kPoses * num_classes;
  int* ticket = scratch;
  int* gcounts = scratch + 1;
  for (int i = threadIdx.x; i < per_query; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const int beam = blockIdx.x * blockDim.x + threadIdx.x;
  if (beam < nb && mask[(int64_t)q * nb + beam] != 0) {
    const float* m = map_base(maps, map_idx, q, h, w);
    const int* c = cells + (int64_t)q * 12 * nb + beam;
    // Pose order (base, +x, +y, +theta, -x, -y, -theta); the axis poses'
    // cell shifts (sx, sy).
    const int shift_pose[5] = {0, 1, 2, 4, 5};
    const int shift_x[5] = {0, 1, 0, -1, 0};
    const int shift_y[5] = {0, 0, 1, 0, -1};
    int cmin[kPoses];
#pragma unroll
    for (int p = 0; p < kPoses; ++p) cmin[p] = none;

    // Axis poses from the extended patch around the base cells.
    const int64_t hx = c[(0 * 3 + 0) * nb];
    const int64_t hy = c[(1 * 3 + 0) * nb];
    const int64_t mx = c[(2 * 3 + 0) * nb];
    const int64_t my = c[(3 * 3 + 0) * nb];
#pragma unroll
    for (int ey = -k - 1; ey <= k + 1; ++ey) {
#pragma unroll
      for (int ex = -k - 1; ex <= k + 1; ++ex) {
        const float hv = read_cell(m, h, w, hx + ex, hy + ey);
        const float mv = read_cell(m, h, w, mx + ex, my + ey);
        if (!usable(hv, mv, thr)) continue;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const int dx = ex - shift_x[s];
          const int dy = ey - shift_y[s];
          if (dx < -k || dx > k || dy < -k || dy > k) continue;
          const int cls = dx * dx + dy * dy;
          const int p = shift_pose[s];
          cmin[p] = min(cmin[p], cls);
        }
      }
    }
    // Theta poses: their rotated endpoints need their own kernels.
#pragma unroll
    for (int a = 1; a <= 2; ++a) {
      const int p = a == 1 ? 3 : 6;
      const int64_t thx = c[(0 * 3 + a) * nb];
      const int64_t thy = c[(1 * 3 + a) * nb];
      const int64_t tmx = c[(2 * 3 + a) * nb];
      const int64_t tmy = c[(3 * 3 + a) * nb];
#pragma unroll
      for (int dy = -k; dy <= k; ++dy) {
#pragma unroll
        for (int dx = -k; dx <= k; ++dx) {
          const float hv = read_cell(m, h, w, thx + dx, thy + dy);
          const float mv = read_cell(m, h, w, tmx + dx, tmy + dy);
          if (usable(hv, mv, thr)) cmin[p] = min(cmin[p], dx * dx + dy * dy);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPoses; ++p)
      atomicAdd(&counts[p * num_classes + cmin[p]], 1);
  }
  __syncthreads();

  // The block's counts into the global buffer, then a ticket.
  int* gq = gcounts + (int64_t)q * per_query;
  for (int i = threadIdx.x; i < per_query; i += blockDim.x)
    if (counts[i] != 0) atomicAdd(&gq[i], counts[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!last) return;

  // Last block: every other block's counts are in L2; read them past L1.
  __threadfence();
  for (int i = threadIdx.x; i < nq * kPoses; i += blockDim.x) {
    const int* ci = gcounts + (int64_t)(i / kPoses) * per_query +
                    (i % kPoses) * num_classes;
    float acc = 0.0f;
    for (int cls = 0; cls < num_classes; ++cls)
      acc = __fadd_rn(acc, __fmul_rn((float)__ldcg(ci + cls), table[cls]));
    raw[i] = acc;
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < (int64_t)nq * per_query; i += blockDim.x)
    gcounts[i] = 0;
  if (threadIdx.x == 0) *ticket = 0;
}

template <int KT>
int launch(const float* maps, int h, int w, const int* cells,
           const unsigned char* mask, const int* map_idx, const float* table,
           int q, int nb, int k, float thr, int* scratch, float* raw,
           cudaStream_t stream) {
  const size_t shared = sizeof(int) * kPoses * (2 * (k + 1) * (k + 1) + 1);
  const int chunks = nb > 0 ? (nb + kThreads - 1) / kThreads : 1;
  greedy_cost_kernel<KT><<<dim3(chunks, q), kThreads, shared, stream>>>(
      maps, h, w, cells, mask, map_idx, table, q, nb, k, thr, scratch, raw);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: int32 [1 + q * 7 * (2(k+1)^2 + 1)], zero on entry; zero again
// when the launch has finished.
extern "C" int greedy_cost_f32(const float* maps, int h, int w,
                               const int* cells, const unsigned char* mask,
                               const int* map_idx, const float* table, int q,
                               int nb, int k, float thr, int* scratch,
                               float* raw, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1:
      return launch<1>(maps, h, w, cells, mask, map_idx, table, q, nb, k, thr,
                       scratch, raw, s);
    case 2:
      return launch<2>(maps, h, w, cells, mask, map_idx, table, q, nb, k, thr,
                       scratch, raw, s);
    default:
      return launch<0>(maps, h, w, cells, mask, map_idx, table, q, nb, k, thr,
                       scratch, raw, s);
  }
}
