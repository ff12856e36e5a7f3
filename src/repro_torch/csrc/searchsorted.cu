// Batched searchsorted for Hopper (sm_90a): out[b, i] = #{a[b, :] < q[b, i]}.
//
// Replaces the TPU kernel src/repro/kernels/searchsorted.py::_ss_kernel
// (searchsorted_pallas_call), the membership kernel inside the batched search
// (ca_search_batch, backend "pallas" there, "chained" here).  Same function:
// each row of a is ascending int32 (an INT32_MAX tail is never < q, so the
// count over a padded row equals the count over its valid part); q is any
// order; the output is int32.
//
// What bounds it on this card: the bytes of a, q and the output.  Each query
// costs ceil(log2 m) + 1 dependent loads from one row, far below the card's
// integer rate; a row is at most a few hundred KB, so the repeated reads of
// the binary searches land in the 50 MB L2.
//
// What the design does about it: the simple, right version.  The TPU kernel
// had no fast scalar search, so it compared a (BQ x BA) tile densely and
// summed rows, visiting every block of a for every block of q.  Here one
// thread owns one query and binary-searches its row in global memory:
// O(log m) loads instead of O(m) compares.  Keeping a row in shared memory is
// later work.
//
// Entry point: searchsorted_launch (plain C, loaded with ctypes).  One launch
// on the caller's stream, no allocation, no synchronisation; returns the
// cudaError_t of the launch (0 on success).

#include "search.cuh"

namespace {

__global__ void searchsorted_kernel(const int* __restrict__ a,
                                    const int* __restrict__ q, int rows, int m,
                                    int nq, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t slot = static_cast<size_t>(r) * nq + i;
    out[slot] = lower_bound(a + static_cast<size_t>(r) * m, m, __ldg(q + slot));
  }
}

}  // namespace

extern "C" int searchsorted_launch(const int* a, const int* q, int rows, int m,
                                   int nq, int* out, void* stream) {
  if (rows <= 0 || nq <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(nq), rows < kMaxGridY ? rows : kMaxGridY);
  searchsorted_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, q, rows, m, nq, out);
  return static_cast<int>(cudaGetLastError());
}
