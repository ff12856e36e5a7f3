// Shared pieces of the port's search kernels: launch shape and the binary
// search every kernel runs.  Header only; each kernel source is built on its
// own (see repro_torch/kernels/_build.py, which hashes this file too).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kIntPad = 0x7fffffff;

// First position in row[0, n) whose value is >= key (n when there is none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int n,
                                           int key) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Blocks along x cover `n` threads' worth of work.
inline unsigned int blocks_for(int n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace
