// Sorted-set membership for Hopper (sm_90a): found/pos of each query in a.
//
// Replaces the TPU kernel src/repro/kernels/intersect.py::_membership_kernel
// (membership_pallas_call), the CA intersection of the chained query path
// (run_query_chained here, run_query_pallas there).  Same function: a is
// ascending and unique int32 of length na; for each query q[i],
// found[i] = q[i] is in a, pos[i] = its index in a on a hit and 0 on a miss
// (the TPU kernel zeroes pos before its first block and writes only hits).
//
// What bounds it on this card: the bytes of a, q and the two outputs.  Each
// query costs ceil(log2 na) + 1 dependent loads, far below the integer rate;
// the lists of one query are at most a few hundred KB, so the repeated reads
// land in the 50 MB L2.
//
// What the design does about it: the simple, right version.  The TPU kernel
// compared each block of queries densely against a window of blocks of a,
// with the window starts computed on the host.  Here one thread owns one query
// and binary-searches all of a in global memory: exact lengths, no padding to
// a block multiple, no host window pass, and the queries need not be sorted.
//
// Entry point: intersect_launch (plain C, loaded with ctypes).  One launch on
// the caller's stream, no allocation, no synchronisation; returns the
// cudaError_t of the launch (0 on success).

#include "search.cuh"

namespace {

__global__ void intersect_kernel(const int* __restrict__ a, int na,
                                 const int* __restrict__ q, int nq,
                                 unsigned char* __restrict__ found,
                                 int* __restrict__ pos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int key = __ldg(q + i);
  const int p = lower_bound(a, na, key);
  const bool hit = p < na && __ldg(a + p) == key;
  found[i] = static_cast<unsigned char>(hit ? 1 : 0);
  pos[i] = hit ? p : 0;
}

}  // namespace

extern "C" int intersect_launch(const int* a, int na, const int* q, int nq,
                                unsigned char* found, int* pos, void* stream) {
  if (nq <= 0) return 0;
  if (na < 0) return static_cast<int>(cudaErrorInvalidValue);
  intersect_kernel<<<blocks_for(nq), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, na, q, nq, found,
                                                          pos);
  return static_cast<int>(cudaGetLastError());
}
