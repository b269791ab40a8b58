// What every kernel library of the port shares: the block size and the
// error string the Python side reads after a launch fails.  Each .cu file
// is its own shared library, so each defines repro_error_string once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int THREADS = 256;                  // threads per block

// Blocks for a grid-stride loop over n elements: one element per thread
// up to 16 blocks per SM of an H100 (132 SMs), then each thread loops.
inline unsigned stride_blocks(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = 132LL * 16;
  return static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
