// K2: the reference context scan, one thread per reference position.
//
// Replaces malva_tpu/ops/pallas_kernels.py:222 make_window_hash_fn together
// with the XLA rest of index/device.py:697 make_ref_scan_step_pallas.  Per
// position: the strcmp/RCN canonical form of the centered k-mer and its
// XXH3, the alt-filter probe, and for a hit the canonical ref_k-window's
// XXH3 and an atomicOr of its bit into the context filter.
//
// Bound: the 43 overlapping byte reads per thread come through L1 from
// one coalesced stretch of the chunk; then one random 4-byte read of the
// alt filter per position and a rare atomicOr.  The sequence is read as
// uint8 straight from the chunk: no uint32 widening and no 128-lane halo
// (those were Mosaic workarounds), and the TPU's sort+dedup scatter-OR
// becomes one atomicOr.
#include <cuda_runtime.h>

#include "lanes.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;

// Hash-only mode: the TPU kernel's outputs c_hi, c_lo, x_hi, x_lo, one
// plane of n_pos words each.
__global__ void window_hash_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k,
                                   int ref_k, uint32_t* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pos) return;
  uint8_t buf[kMaxLen];
  canonical_bytes(seq + p + (ref_k - k) / 2, k, buf);
  const uint64_t c = xxh3_64(buf, k);
  canonical_bytes(seq + p, ref_k, buf);
  const uint64_t x = xxh3_64(buf, ref_k);
  out[p] = (uint32_t)(c >> 32);
  out[n_pos + p] = (uint32_t)c;
  out[2 * n_pos + p] = (uint32_t)(x >> 32);
  out[3 * n_pos + p] = (uint32_t)x;
}

__global__ void ref_scan_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k,
                                int ref_k, const uint32_t* __restrict__ bf_words,
                                uint32_t* __restrict__ ctx_words, uint64_t size_bits) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pos) return;
  uint8_t buf[kMaxLen];
  canonical_bytes(seq + p + (ref_k - k) / 2, k, buf);
  if (!bit_is_set(bf_words, bloom_index(xxh3_64(buf, k), size_bits))) return;
  canonical_bytes(seq + p, ref_k, buf);
  const uint64_t cidx = bloom_index(xxh3_64(buf, ref_k), size_bits);
  atomicOr(ctx_words + (cidx >> 5), 1u << (cidx & 31));
}

int grid_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int malva_window_hash(const void* seq, int64_t n_pos, int k, int ref_k, void* out,
                      void* stream) {
  if (n_pos > 0)
    window_hash_kernel<<<grid_for(n_pos), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, n_pos, k, ref_k, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int malva_ref_scan(const void* seq, int64_t n_pos, int k, int ref_k, const void* bf_words,
                   void* ctx_words, int64_t size_bits, void* stream) {
  if (n_pos > 0)
    ref_scan_kernel<<<grid_for(n_pos), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, n_pos, k, ref_k, (const uint32_t*)bf_words,
        (uint32_t*)ctx_words, (uint64_t)size_bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
