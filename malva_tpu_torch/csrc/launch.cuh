// Host side of a timed launch, shared by the call-step kernels (K1, K4).
//
// The launcher records an optional pair of CUDA events on the launch
// stream just before and just after the kernel, inside one C call.  ctypes
// releases the GIL for the whole call, so no other Python thread can hold
// the host between the start event and the launch, and the time between the
// two events is the kernel's device time.  Either event may be null (not
// timed).  Returns the first CUDA error, or 0.
#pragma once

#include <cuda_runtime.h>

namespace malva {

template <typename Launch>
int launch_timed(void* start, void* stop, cudaStream_t stream, Launch launch) {
  if (start) {
    const cudaError_t e = cudaEventRecord((cudaEvent_t)start, stream);
    if (e != cudaSuccess) return (int)e;
  }
  launch(stream);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return stop ? (int)cudaEventRecord((cudaEvent_t)stop, stream) : 0;
}

}  // namespace malva
