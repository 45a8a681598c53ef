// What the kernels' launches share: on the device, the asynchronous
// copies into shared memory (K1, K2, K3, K6, K7); on the host, the size of a
// persistent grid (K1, K2, K3) and the timed launch of the call-step
// kernels (K1, K4, K5).
//
// The timed launcher records an optional pair of CUDA events on the launch
// stream just before and just after the kernel, inside one C call.  ctypes
// releases the GIL for the whole call, so no other Python thread can hold
// the host between the start event and the launch.  On a stream with no
// work queued the device would still take the start event at once and then
// wait for the host to push the kernel, so a timed launch first queues a
// hold: a one-thread kernel that waits until the host has queued the stop
// event (a word of pinned host memory), with a 10 ms time-out.  The time
// between the two events is then the kernel's device time, however slow the
// host is.  Either event may be null (not timed).  Returns the first CUDA
// error, or 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

constexpr unsigned long long kHoldTimeoutNs = 10000000ull;

// Waits until the host has released hold `seq` (the word at `flag` has
// reached it, in wrapping order), or for kHoldTimeoutNs.
static __global__ void hold_kernel(const volatile unsigned* flag, unsigned seq) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while ((int)(*flag - seq) < 0) {
    __nanosleep(256);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > kHoldTimeoutNs) break;
  }
}

// The pinned host word that releases the holds, mapped for every card, or
// null where it cannot be allocated.
static volatile unsigned* hold_flag() {
  static volatile unsigned* const flag = [] {
    void* p = nullptr;
    if (cudaHostAlloc(&p, sizeof(unsigned), cudaHostAllocMapped | cudaHostAllocPortable) !=
        cudaSuccess)
      return (volatile unsigned*)nullptr;
    *(volatile unsigned*)p = 0;
    return (volatile unsigned*)p;
  }();
  return flag;
}

static std::atomic<unsigned> hold_seq{0};

// Raises the word to `seq` unless a later hold has already been released.
static void hold_release(volatile unsigned* flag, unsigned seq) {
  unsigned* w = (unsigned*)flag;
  unsigned cur = __atomic_load_n(w, __ATOMIC_ACQUIRE);
  while ((int)(seq - cur) > 0 &&
         !__atomic_compare_exchange_n(w, &cur, seq, false, __ATOMIC_RELEASE, __ATOMIC_ACQUIRE)) {
  }
}

template <typename Launch>
int launch_timed(void* start, void* stop, cudaStream_t stream, Launch launch) {
  volatile unsigned* flag = nullptr;
  unsigned seq = 0;
  cudaError_t e = cudaSuccess;
  if (start) {
    flag = hold_flag();
    if (!flag) return (int)cudaErrorMemoryAllocation;
    seq = hold_seq.fetch_add(1) + 1;
    hold_kernel<<<1, 1, 0, stream>>>(flag, seq);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaEventRecord((cudaEvent_t)start, stream);
  }
  if (e == cudaSuccess) {
    launch(stream);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess && stop) e = cudaEventRecord((cudaEvent_t)stop, stream);
  if (flag) hold_release(flag, seq);
  return (int)e;
}

}  // namespace malva
