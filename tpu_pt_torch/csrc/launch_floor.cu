// launch_floor: a kernel that does nothing, launched on a given grid.
//
// A measurement aid, not a port of anything: the time between two CUDA
// events around it, and its duration in a profiler trace, are what either
// way of timing reports for a launch that does no work.  The pair kernels
// run a few microseconds; their times are read against this floor.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Returns cudaGetLastError().
extern "C" int launch_floor_launch(int blocks, int threads, void* stream) {
  if (blocks > 0 && threads > 0)
    launch_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
