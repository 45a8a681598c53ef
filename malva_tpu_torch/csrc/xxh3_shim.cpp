// XXH3_64bits (seed 0) for the C++ baseline (ref_hotloop.cpp), over this
// package's own XXH3 (xxh3.cuh, the kernels' body, read through a byte
// pointer), so that the baseline needs no copy of the xxHash library.  It
// takes only the two lengths the loop hashes, the centre (k = 35) and the
// context (ref_k = 43), each a call with a constant length, and aborts on
// any other: it is not a general XXH3.
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>

#include "xxh3.cuh"

extern "C" uint64_t XXH3_64bits(const void* data, size_t len) {
  const malva::BytePtr in{static_cast<const uint8_t*>(data)};
  if (len == 35) return malva::xxh3_64(in, 35);
  if (len == 43) return malva::xxh3_64(in, 43);
  fprintf(stderr, "xxh3_shim: XXH3_64bits of %zu bytes; only 35 and 43 are built\n", len);
  abort();
}
