// Log-odds ray-cast of K scans into each of M maps, scans in order, in one
// launch: every cell a beam passes before its hit cell gets the miss
// increment, the hit cell the hit increment, and each touched cell is
// clamped to +-lo_max after each scan (grid_map_builder.cpp:145-186,
// binary_bayes_grid_cell.hpp:90-99).
//
// Replaces no Pallas kernel: the JAX package casts with XLA's scatter-add
// (ops/raycast.py::integrate_scans_stacked of either package, whose plain
// PyTorch path stays as the CPU path and this kernel's yardstick). On the
// card that path sent every (beam, step) entry, the ones past the hit cell,
// off the map or on padded beams clamped onto border cells with value 0,
// through PyTorch's sort-based index_put_(accumulate=True), whose runs of
// thousands of duplicate indices are summed by one thread each.
//
// What bounds it on an H100: latency. A scan of 181 beams touches some
// 10^4-10^5 cells of a map of 1-2.4 M cells; the bytes take microseconds
// at 3.35 TB/s, and the scans must be applied one after another, each
// behind a barrier. The design:
//  * one cluster of kCluster thread blocks per map (blockIdx.x / kCluster),
//    so the M maps of a stacked rebuild run side by side and cluster.sync()
//    (a hardware barrier, no grid-wide sync) orders a map's scans;
//  * per scan, each block works out the beams of the scan into shared
//    memory (difference to the hit cell, misses to walk, the hit cell),
//    with the float32 operations of trace_cells_batched one by one
//    (__fmul_rn and friends: no FMA contraction; true division by the
//    resolution; cosf/sinf; floorf; rintf for torch.round), so the kernel
//    picks the very cells of the plain walk. The threads of the cluster
//    then share the scan's (beam, slot) pairs, the slots being the miss
//    steps and then the hit, and recompute each pair's cell in registers;
//    pairs past a beam's misses, off the map or of a beam out of its gate
//    touch nothing;
//  * phase A: each touched cell gets an integer atomicAdd on a per-cell
//    uint32 count (misses in the low 16 bits, hits in the high 16);
//  * phase B: the same walk again; each visit takes the count with
//    atomicExch(count, 0), and the one visit that gets it non-zero writes
//    lo = clamp(lo + n_miss * lo_miss + n_hit * lo_hit) and observed = 1.
//    Integer counts and one writer per cell make a launch bit-reproducible,
//    and phase B leaves every count at zero again: the caller's scratch
//    (uint32 [M, H, W], zero on entry) needs no clearing between launches;
//  * untouched cells are left alone: a map within the clamp stays within
//    it, so this equals the plain path's whole-map clamp.
// Per scan: the beams, phase A, cluster.sync(), phase B, cluster.sync().

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr unsigned kHit = 1u << 16;

struct Scan {
  float px, py, pt, rmin, rmax;
  int six, siy;
};

__device__ __forceinline__ int cell_of(float p, float o, float res) {
  return (int)floorf(__fdiv_rn(__fsub_rn(p, o), res));
}

__device__ __forceinline__ Scan load_scan(const float* poses,
                                          const float* range_min,
                                          const float* range_max, int64_t row,
                                          float ox, float oy, float res) {
  Scan s;
  s.px = poses[3 * row];
  s.py = poses[3 * row + 1];
  s.pt = poses[3 * row + 2];
  s.rmin = range_min[row];
  s.rmax = range_max[row];
  s.six = cell_of(s.px, ox, res);
  s.siy = cell_of(s.py, oy, res);
  return s;
}

// One beam: (dx, dy) from the sensor cell to the hit cell, the number of
// miss steps to walk (0 for a beam out of its gate), and the hit cell's
// flat index or -1 (out of the gate or off the map).
__device__ __forceinline__ int4 beam_of(const Scan& s, float r, float a,
                                        bool valid, float ox, float oy,
                                        float res, int h, int w,
                                        int max_steps) {
  const bool use = valid && r > s.rmin && r < s.rmax;
  const float wa = __fadd_rn(s.pt, a);
  const int hix = cell_of(__fadd_rn(s.px, __fmul_rn(r, cosf(wa))), ox, res);
  const int hiy = cell_of(__fadd_rn(s.py, __fmul_rn(r, sinf(wa))), oy, res);
  int4 b;
  b.x = hix - s.six;
  b.y = hiy - s.siy;
  b.z = use ? min(max(abs(b.x), abs(b.y)), max_steps) : 0;
  b.w = use && on_map(hix, hiy, h, w) ? hiy * w + hix : -1;
  return b;
}

// The flat cell of slot ``step`` of beam ``b``: miss steps 0 .. b.z - 1,
// then the hit at step == max_steps; -1 where the slot touches nothing.
__device__ __forceinline__ int cell_at(const Scan& s, int4 b, int step,
                                       int max_steps, int h, int w) {
  if (step == max_steps) return b.w;
  if (step >= b.z) return -1;
  const float n = (float)max(max(abs(b.x), abs(b.y)), 1);
  const float frac = __fdiv_rn((float)step, n);
  const int x = s.six + (int)rintf(__fmul_rn(frac, (float)b.x));
  const int y = s.siy + (int)rintf(__fmul_rn(frac, (float)b.y));
  return on_map(x, y, h, w) ? y * w + x : -1;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    raycast_kernel(float* __restrict__ log_odds,
                   unsigned char* __restrict__ observed,
                   const float* __restrict__ origins,
                   const float* __restrict__ poses,
                   const float* __restrict__ ranges,
                   const float* __restrict__ angles,
                   const unsigned char* __restrict__ valid,
                   const unsigned char* __restrict__ active,
                   const float* __restrict__ range_min,
                   const float* __restrict__ range_max,
                   const float* __restrict__ lo_miss_p,
                   const float* __restrict__ lo_hit_p, int k, int nb, int h,
                   int w, float res, int max_steps, float lo_max,
                   unsigned* __restrict__ counts) {
  __shared__ int4 beams[kThreads];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / kCluster;
  const int64_t cells = (int64_t)h * w;
  float* lo = log_odds + m * cells;
  unsigned char* ob = observed + m * cells;
  unsigned* cnt = counts + m * cells;
  const float ox = origins[2 * m];
  const float oy = origins[2 * m + 1];
  const float lo_miss = *lo_miss_p;
  const float lo_hit = *lo_hit_p;
  const int slots = max_steps + 1;
  const int chunks = (nb + kThreads - 1) / kThreads;

  for (int j = 0; j < k; ++j) {
    const int64_t row = (int64_t)m * k + j;
    if (active != nullptr && active[row] == 0) continue;
    const Scan s = load_scan(poses, range_min, range_max, row, ox, oy, res);
    for (int phase = 0; phase < 2; ++phase) {
      for (int c = 0; c < chunks; ++c) {
        const int b0 = c * kThreads;
        const int nbc = min(kThreads, nb - b0);
        if (phase == 0 || chunks > 1) {
          __syncthreads();
          if (threadIdx.x < nbc) {
            const int64_t i = row * nb + b0 + threadIdx.x;
            beams[threadIdx.x] = beam_of(s, ranges[i], angles[i],
                                         valid[i] != 0, ox, oy, res, h, w,
                                         max_steps);
          }
          __syncthreads();
        }
        for (int i = rank * kThreads + threadIdx.x; i < nbc * slots;
             i += kCluster * kThreads) {
          const int b = i / slots;
          const int step = i - b * slots;
          const int cell = cell_at(s, beams[b], step, max_steps, h, w);
          if (cell < 0) continue;
          if (phase == 0) {
            atomicAdd(cnt + cell, step == max_steps ? kHit : 1u);
            continue;
          }
          const unsigned n = atomicExch(cnt + cell, 0u);
          if (n == 0) continue;
          float v = __ldcg(lo + cell);
          if (n & 0xffffu) v = __fadd_rn(v, __fmul_rn((float)(n & 0xffffu),
                                                       lo_miss));
          if (n >> 16) v = __fadd_rn(v, __fmul_rn((float)(n >> 16), lo_hit));
          __stcg(lo + cell, fminf(fmaxf(v, -lo_max), lo_max));
          ob[cell] = 1;
        }
      }
      // Phase A's counts are complete before any block applies them, and
      // every block has applied them before the next scan counts.
      cluster.sync();
    }
  }
}

}  // namespace

// In place on log_odds f32[M, H, W] and observed u8[M, H, W]; origins
// f32[M, 2]; poses (sensor poses) f32[M, K, 3]; ranges, angles f32 and
// valid u8 [M, K, NB]; active u8[M, K] or null (every row); range_min,
// range_max f32[M, K]; lo_miss, lo_hit f32 scalars on the device; counts
// u32[M, H, W], zero on entry and zero again when the launch has finished.
extern "C" int raycast_f32(float* log_odds, unsigned char* observed,
                           const float* origins, const float* poses,
                           const float* ranges, const float* angles,
                           const unsigned char* valid,
                           const unsigned char* active,
                           const float* range_min, const float* range_max,
                           const float* lo_miss, const float* lo_hit, int m,
                           int k, int nb, int h, int w, float res,
                           int max_steps, float lo_max, unsigned* counts,
                           void* stream) {
  raycast_kernel<<<kCluster * m, kThreads, 0, (cudaStream_t)stream>>>(
      log_odds, observed, origins, poses, ranges, angles, valid, active,
      range_min, range_max, lo_miss, lo_hit, k, nb, h, w, res, max_steps,
      lo_max, counts);
  return (int)cudaGetLastError();
}
