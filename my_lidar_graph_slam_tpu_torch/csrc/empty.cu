// An empty kernel, launched the way the port's kernels are (ctypes, the
// caller's stream, one block): its time is the floor under any launch.
// Not on the SLAM path; chip_smoke.py times it beside the kernels.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
