// Sorted-set membership for Hopper (sm_90a): the CA intersection of one
// chained query, and found/pos of each query in one list.
//
// Replaces the TPU kernel src/repro/kernels/intersect.py::_membership_kernel
// (membership_pallas_call), the CA intersection of the chained query path
// (run_query_chained here, run_query_pallas there).  Its function: a is
// ascending and unique int32 of length na; for each query q[i],
// found[i] = q[i] is in a, pos[i] = its index in a on a hit and 0 on a miss
// (the TPU kernel zeroes pos before its first block and writes only hits).
//
// Two entry points:
//   intersect_lists_launch: the whole intersection of one chained query in
//     one launch.  L0 (the shortest list) and the k-1 other lists are views
//     of one int32 buffer; table[j] = (ids offset, ndesc offset, length) of
//     list j, j = 0 for L0.  Outputs ca[i] = L0[i] is in every other list,
//     and nd[j, i] = list j's NDesc at L0[i]'s position in it (position 0 on
//     a miss), nd[0] = L0's NDesc;
//   intersect_launch: found/pos of unsorted queries in one list (one thread
//     per query, a binary search of a in global memory).
//
// What bounds it on this card: the bytes of the lists and the outputs.  Each
// L0 entry costs one search per other list, far below the integer rate; what
// a thread that binary-searches global memory waits on is ceil(log2 na) + 1
// dependent loads, and what a chained query waits on is its launches: before
// this design it made one launch per other list, and two more for the CA
// mask and the NDesc gather.
//
// What the design does about it (intersect_lists): one launch per query.
// L0 is ascending, so a block's tile of 256 consecutive L0 entries meets one
// narrow window of each other list, as the TPU kernel's host-computed block
// windows used.  For each list a warp finds the window (the lower bound of
// the tile's first id, the upper bound of its last) by a 33-ary search, 4
// rounds of loads for 10^5 ids; the block stages the window into shared
// memory with 16-byte cp.async (plain loads for the unaligned head and tail,
// since the lists sit at any int32 offset of the buffer), or, when it holds
// more than kStage - 3 ids, every step-th id of it; then each thread searches
// shared memory (and, for a sample, one segment of fewer than step ids in
// global memory, one or two 128-byte lines).  Two staging buffers let the
// next list's copy run while this list is searched.  ca and nd are written
// once per entry, with no atomics.
//
// Both entry points are plain C, exported to Python by pyentry.cuh as the
// module intersect: one launch on the caller's stream, no allocation, no
// synchronisation; they return the cudaError_t of the launch (0 on success).

#include "pyentry.cuh"
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

// One block per tile of kThreads L0 entries; dynamic shared memory: two
// staging buffers, then the k-1 windows.
__global__ void intersect_lists_kernel(const int* __restrict__ buf,
                                       const int* __restrict__ table, int k,
                                       int n, unsigned char* __restrict__ ca,
                                       int* __restrict__ nd) {
  extern __shared__ __align__(16) int smem[];
  const int slot0 = blockIdx.x * blockDim.x;
  const int slot1 = min(slot0 + static_cast<int>(blockDim.x), n);
  const int i = slot0 + threadIdx.x;
  const int* ids0 = buf + __ldg(table);
  if (i < n) nd[i] = __ldg(buf + __ldg(table + 1) + i);
  bool all = true;
  tile_membership(
      slot0, slot1, k - 1,
      [&](int j) {
        const int* t = table + 3 * (j + 1);
        return RowList{buf + __ldg(t), __ldg(t + 2)};
      },
      [&](int s) { return __ldg(ids0 + s); }, smem + 2 * kStage, smem,
      [&](int j, int s, bool found, int p) {
        const int* t = table + 3 * (j + 1);
        nd[static_cast<size_t>(j + 1) * n + s] =
            __ldg(buf + __ldg(t + 1) + (found ? p : 0));
        all = all && found;
      });
  if (i < n) ca[i] = static_cast<unsigned char>(all ? 1 : 0);
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

extern "C" int intersect_lists_launch(const int* buf, const int* table, int k,
                                      int n, unsigned char* ca, int* nd,
                                      void* stream) {
  if (n <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * static_cast<size_t>(kStage) + 2 * (k - 1)) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        intersect_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  intersect_lists_kernel<<<blocks_for(n), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(buf, table, k,
                                                                n, ca, nd);
  return static_cast<int>(cudaGetLastError());
}

PYENTRY_MODULE(intersect, PYENTRY_FN(intersect_launch),
               PYENTRY_FN(intersect_lists_launch))
