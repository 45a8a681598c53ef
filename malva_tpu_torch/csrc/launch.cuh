// What the kernels' launches share: on the device, the asynchronous
// copies into shared memory (K1, K2, K3, K6, K7); on the host, the size of a
// persistent grid (K1, K2, K3) and the timed launch of the call-step
// kernels (K1, K4, K5).
//
// The timed launcher records an optional pair of CUDA events on the launch
// stream just before and just after the kernel, inside one C call.  ctypes
// releases the GIL for the whole call, so no other Python thread can hold
// the host between the start event and the launch, and the time between the
// two events is the kernel's device time.  Either event may be null (not
// timed).  Returns the first CUDA error, or 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace malva {

// A slot block of the routed call step (route.cu's K6 and K7 write them,
// shard_step.cu's SlotPolicy reads hop 2's): kSlotHead header words
// ([rows, 0, 0, 0]), then cap rows as planes, the packed contexts (cap x N
// words), then one plane of cap words per further column: kHop1Cols in
// hop 1 (counter, context word less the owner's first word, context bit,
// Bloom-word owner), kHop2Cols in hop 2 (counter, "context known").
// ops/kernels.py checks its copy of these numbers against the library's
// (malva_slot_layout) before it launches any of the three.
constexpr int64_t kSlotHead = 4;
constexpr int kHop1Cols = 4, kHop2Cols = 2;

// A 16-byte copy from device memory into shared memory that the thread
// does not wait for (cp.async, through L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The same for 4 bytes (cp.async through L1: the words of a context row
// that one lane copies share their lines with its neighbours').
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of n bytes into shared memory, by the whole block:
// 16-byte cp.async copies where `src` is 16-byte aligned, single bytes
// (done on return) for the rest.  Commits one group of copies.
__device__ inline void copy_async(uint8_t* dst, const uint8_t* __restrict__ src, int n,
                                  bool aligned) {
  const int done = aligned ? n / 16 * 16 : 0;
  for (int q = 16 * threadIdx.x; q < done; q += 16 * blockDim.x) cp_async16(dst + q, src + q);
  for (int q = done + threadIdx.x; q < n; q += blockDim.x) dst[q] = src[q];
  cp_async_commit();
}

// Into *grid, the blocks of a persistent grid: as many as fit on the
// current card at once, and no more than `blocks`, the work's blocks.
// Returns the first CUDA error, or 0.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int64_t blocks, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(blocks < resident ? blocks : resident);
  return 0;
}

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
