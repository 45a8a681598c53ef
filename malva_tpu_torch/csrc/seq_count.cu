// K3: the sample counter's front end, one thread per window position.
//
// Has no Pallas counterpart: it replaces the XLA front end of
// malva_tpu/count/device_count.py:64 make_seq_sort_count_step, which
// stacks a (chunk, ref_k) byte matrix of the windows (1.4 GB at
// chunk = 2^25, ref_k = 43) and then validates, canonicalizes and packs it
// column by column.  Here each thread reads its ref_k bytes of the raw
// read chunk (reads joined by 0xFF separators), and writes one validity
// byte and, for a pure-ACGT window, its canonical 2-bit key of
// ceil(ref_k / 32) 64-bit words (zeros for an invalid window).
//
// Bound: the ref_k overlapping byte reads per thread come through L1 from
// one coalesced stretch of the chunk; the writes are 8 * ceil(ref_k / 32)
// + 1 bytes per position, coalesced.  The compaction, sort and run count
// that follow are torch's (count/device_count.py of the port).
#include <cuda_runtime.h>

#include "lanes.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;

__global__ void seq_pack_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int ref_k,
                                uint64_t* __restrict__ keys, uint8_t* __restrict__ valid) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pos) return;
  const int w = (ref_k + 31) / 32;
  uint64_t words[kMaxWords64];
  const bool ok = canonical_window(seq + p, ref_k, words);
  for (int i = 0; i < w; ++i) keys[p * w + i] = ok ? words[i] : 0;
  valid[p] = ok;
}

}  // namespace

extern "C" {

int malva_seq_pack(const void* seq, int64_t n_pos, int ref_k, void* keys, void* valid,
                   void* stream) {
  if (n_pos > 0)
    seq_pack_kernel<<<(int)((n_pos + kThreads - 1) / kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>((const uint8_t*)seq, n_pos, ref_k,
                                              (uint64_t*)keys, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
