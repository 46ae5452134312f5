// Correlative window scores: score[q, t, a, b] = sum_beam w[q, beam] *
// M[iy[q, t, beam] + dy, ix[q, t, beam] + dx], dx = a - win_x,
// dy = b - win_y; an off-map read is 0 (Unknown).
//
// Replaces the TPU kernel
// my_lidar_graph_slam_tpu/ops/pallas/correlate_mxu.py::window_scores_mxu
// (body _kernel_bb) and its 7x7 block assembly window_scores_mxu_wide
// (ops/matchers_mxu.py): this kernel takes any window directly.
//
// What bounds it on an H100: L1 reads of the map. Each output needs one map
// value per live beam, and no value is shared between two outputs of one
// beam, so at the loop-detection shape of the default config (4 x 401 x
// 41 x 41 outputs, ~181 live beams) the kernel makes ~5.7e8 map reads for
// as many FMAs; the map (<= 9.4 MB) stays in the 50 MB L2, and neighbouring
// thetas reuse each other's lines in L1. No operand is shared across
// outputs, so there is nothing for the tensor cores to multiply. The design
// spends as few instructions as it can around each read:
//  * one block per (q, theta); it compacts the row's live beams (w != 0) in
//    beam order into shared memory, up to `chunk` beam slots at a time, as
//    records: an int32 offset of the window's corner for a beam whose whole
//    window lies on the map (interior), or (ix, iy) for a border beam, with
//    the weight beside it. A beam whose window lies wholly off the map is
//    dropped. Padding beams cost nothing in the hot loop;
//  * each thread owns `rows` outputs of one dx column (R consecutive dy):
//    per interior beam it reads one record (a shared-memory broadcast) and
//    then R map values at fixed offsets from it, with no bounds test; the
//    border beams take a second, checked loop;
//  * the beams are split over `splits` groups of threads (for a small
//    window, so that the frontend's 5x5 call fills the card), and within a
//    group alternate between two partial sums; the groups' sums are added
//    in group order through shared memory, so two launches on the same
//    inputs give the same bits;
//  * the block's outputs go through shared memory and leave coalesced.
// The launch geometry (rows, splits, slots, chunk, stage) is chosen by the
// wrapper (ops/cuda/correlate.py::launch_geometry), which mirrors the
// shared-memory size computed here.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Counts {
  int interior, border;
};

// Compacts the live beams of beam slots [c0, c1) of one (q, theta) row, in
// slot order, into s_in (interior) and s_bd (border). s_cnt holds 2 * 32
// per-warp counts and the 2 running totals. Ends with a barrier.
__device__ Counts compact(const int* ixr, const int* iyr, const float* wr,
                          int c0, int c1, int h, int w, int win_x, int win_y,
                          int2* s_in, int4* s_bd, int* s_cnt) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* totals = s_cnt + 64;
  if (tid == 0) totals[0] = totals[1] = 0;
  __syncthreads();
  for (int base = c0; base < c1; base += blockDim.x) {
    const int j = base + tid;
    bool in = false, bd = false;
    int64_t x = 0, y = 0;
    float wb = 0.0f;
    if (j < c1) {
      wb = wr[j];
      if (wb != 0.0f) {
        x = ixr[j];
        y = iyr[j];
        const bool off = x + win_x < 0 || x - win_x >= w || y + win_y < 0 ||
                         y - win_y >= h;
        in = x - win_x >= 0 && x + win_x < w && y - win_y >= 0 &&
             y + win_y < h;
        bd = !in && !off;
      }
    }
    const unsigned bin = __ballot_sync(kFull, in);
    const unsigned bbd = __ballot_sync(kFull, bd);
    if (lane == 0) {
      s_cnt[warp] = __popc(bin);
      s_cnt[32 + warp] = __popc(bbd);
    }
    __syncthreads();
    int pin = totals[0], pbd = totals[1];
    for (int k = 0; k < warp; ++k) {
      pin += s_cnt[k];
      pbd += s_cnt[32 + k];
    }
    if (in)
      s_in[pin + __popc(bin & below)] =
          make_int2((int)((y - win_y) * w + (x - win_x)), __float_as_int(wb));
    if (bd)
      s_bd[pbd + __popc(bbd & below)] =
          make_int4((int)x, (int)y, __float_as_int(wb), 0);
    __syncthreads();
    if (tid == 0) {
      const int warps = blockDim.x >> 5;
      for (int k = 0; k < warps; ++k) {
        totals[0] += s_cnt[k];
        totals[1] += s_cnt[32 + k];
      }
    }
    __syncthreads();
  }
  return Counts{totals[0], totals[1]};
}

// Threads: splits groups of `slots` threads (a multiple of 32). A slot is
// (dx index a, row group g) of the window; its R outputs are rows g*R ..
// g*R+R-1 (rows past the window repeat the last row and are not stored).
template <int R>
__global__ void __launch_bounds__(512)
    window_scores_kernel(const float* __restrict__ maps, int h, int w,
                         const int* __restrict__ ix,
                         const int* __restrict__ iy,
                         const float* __restrict__ weight,
                         const int* __restrict__ map_idx, int nt, int nb,
                         int win_x, int win_y, int splits, int slots,
                         int chunk, int stage, float* __restrict__ out) {
  const int wxn = 2 * win_x + 1;
  const int wyn = 2 * win_y + 1;
  const int cells = wxn * wyn;
  const int groups = (wyn + R - 1) / R;
  const int total_slots = wxn * groups;
  const int passes = (total_slots + slots - 1) / slots;

  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_bd = reinterpret_cast<int4*>(smem);            // [chunk]
  int2* s_in = reinterpret_cast<int2*>(s_bd + chunk);    // [chunk]
  float* s_red = reinterpret_cast<float*>(s_in + chunk); // [splits*R*slots]
  float* s_tile = s_red + (splits > 1 ? splits * R * slots : 0);  // [cells]
  int* s_cnt = reinterpret_cast<int*>(s_tile + (stage ? cells : 0));

  const int tid = threadIdx.x;
  const int split = tid / slots;
  const int local = tid - split * slots;
  const int64_t qt = blockIdx.x;
  const int q = (int)(qt / nt);
  const float* m = map_base(maps, map_idx, q, h, w);
  const int* ixr = ix + qt * nb;
  const int* iyr = iy + qt * nb;
  const float* wr = weight + (int64_t)q * nb;

  for (int pass = 0; pass < passes; ++pass) {
    const int slot = pass * slots + local;
    const int a = slot % wxn;
    const int g = min(slot / wxn, groups - 1);
    int row[R];
    int rowoff[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      row[r] = min(g * R + r, wyn - 1);
      rowoff[r] = row[r] * w + a;
    }
    float acc0[R], acc1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.0f;

    for (int c0 = 0; c0 < nb; c0 += chunk) {
      const Counts n = compact(ixr, iyr, wr, c0, min(c0 + chunk, nb), h, w,
                               win_x, win_y, s_in, s_bd, s_cnt);
      // Interior beams: no bounds tests, two independent partial sums.
      int i = split;
      for (; i + splits < n.interior; i += 2 * splits) {
        const int2 r0 = s_in[i];
        const int2 r1 = s_in[i + splits];
        const float* p0 = m + r0.x;
        const float* p1 = m + r1.x;
        const float w0 = __int_as_float(r0.y);
        const float w1 = __int_as_float(r1.y);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc0[r] = fmaf(w0, __ldg(p0 + rowoff[r]), acc0[r]);
          acc1[r] = fmaf(w1, __ldg(p1 + rowoff[r]), acc1[r]);
        }
      }
      if (i < n.interior) {
        const int2 r0 = s_in[i];
        const float* p0 = m + r0.x;
        const float w0 = __int_as_float(r0.y);
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc0[r] = fmaf(w0, __ldg(p0 + rowoff[r]), acc0[r]);
      }
      // Border beams: every read checked.
      for (int j = split; j < n.border; j += splits) {
        const int4 b = s_bd[j];
        const float wb = __int_as_float(b.z);
        const int x = b.x - win_x + a;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int y = b.y - win_y + row[r];
          const float v = (x >= 0 && x < w && y >= 0 && y < h)
                              ? __ldg(m + (int64_t)y * w + x)
                              : 0.0f;
          acc1[r] = fmaf(wb, v, acc1[r]);
        }
      }
      __syncthreads();  // the next chunk rewrites the records
    }

    float tot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tot[r] = acc0[r] + acc1[r];
    if (splits > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        s_red[(split * R + r) * slots + local] = tot[r];
      __syncthreads();
      if (split == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v = s_red[r * slots + local];
          for (int k = 1; k < splits; ++k)
            v += s_red[(k * R + r) * slots + local];
          tot[r] = v;
        }
      }
      __syncthreads();  // s_red is rewritten by the next pass
    }
    if (split == 0 && slot < total_slots) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = g * R + r;
        if (b < wyn) {
          if (stage)
            s_tile[a * wyn + b] = tot[r];
          else
            out[qt * cells + a * wyn + b] = tot[r];
        }
      }
    }
  }
  if (stage) {
    __syncthreads();
    for (int i = tid; i < cells; i += blockDim.x)
      out[qt * cells + i] = s_tile[i];
  }
}

template <int R>
int launch(const float* maps, int h, int w, const int* ix, const int* iy,
           const float* weight, const int* map_idx, int q, int nt, int nb,
           int win_x, int win_y, int splits, int slots, int chunk, int stage,
           float* out, cudaStream_t stream) {
  const int cells = (2 * win_x + 1) * (2 * win_y + 1);
  const size_t shared =
      (size_t)chunk * (sizeof(int4) + sizeof(int2)) +
      sizeof(float) * ((splits > 1 ? (size_t)splits * R * slots : 0) +
                       (stage ? (size_t)cells : 0)) +
      sizeof(int) * 66;
  window_scores_kernel<R><<<(unsigned)q * nt, splits * slots, shared,
                            stream>>>(maps, h, w, ix, iy, weight, map_idx, nt,
                                      nb, win_x, win_y, splits, slots, chunk,
                                      stage, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_scores_f32(const float* maps, int h, int w,
                                 const int* ix, const int* iy,
                                 const float* weight, const int* map_idx,
                                 int q, int nt, int nb, int win_x, int win_y,
                                 int rows, int splits, int slots, int chunk,
                                 int stage, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define K1_CASE(R)                                                          \
  case R:                                                                   \
    return launch<R>(maps, h, w, ix, iy, weight, map_idx, q, nt, nb, win_x, \
                     win_y, splits, slots, chunk, stage, out, s);
  switch (rows) {
    K1_CASE(1)
    K1_CASE(2)
    K1_CASE(3)
    K1_CASE(4)
    K1_CASE(5)
    K1_CASE(6)
    K1_CASE(7)
    K1_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K1_CASE
}
