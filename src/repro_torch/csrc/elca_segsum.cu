// ELCA child sums for Hopper (sm_90a):
//   out[kk, i] = sum over j with par[j] == ca[i] of nd[kk, j].
//
// Replaces the TPU kernel src/repro/kernels/elca_segsum.py::_segsum_kernel
// (elca_segsum_pallas_call), the ELCA step of the chained query path.  Same
// function on the inputs the chained path gives it: ca [mi] int32 ascending,
// its real ids unique (an INT32_MAX tail may repeat: no parent id is
// INT32_MAX); par [mj] int32 parent ids, -1 for none; nd [k, mj] int32;
// out [k, mi] int32.
//
// What bounds it on this card: the bytes of the inputs and the output.  Each
// j costs ceil(log2 mi) + 1 dependent loads and k integer atomics, far below
// the integer rate.
//
// What the design does about it: the simple, right version.  A TPU has no
// scatter, so its kernel built the dense (BI x BJ) equality mask tile by tile
// and contracted it with the k NDesc rows: O(mi * mj) compares.  Here one
// thread owns one j, binary-searches its parent id in ca and adds its k NDesc
// values into the parent's sums with integer atomicAdd: O(mj log mi) work,
// exact in any order, so the output is identical run to run.  The output is
// zeroed by a memset queued in the same launch sequence (no separate
// allocation and fill by the caller).
//
// Entry point: elca_segsum_launch (plain C, loaded with ctypes).  A memset and
// one kernel on the caller's stream, no allocation, no synchronisation;
// returns the first cudaError_t seen (0 on success).

#include "search.cuh"

namespace {

__global__ void segsum_kernel(const int* __restrict__ ca, int mi,
                              const int* __restrict__ par,
                              const int* __restrict__ nd, int mj, int k,
                              int* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= mj) return;
  const int p = __ldg(par + j);
  if (p < 0) return;
  const int i = lower_bound(ca, mi, p);
  if (i >= mi || __ldg(ca + i) != p) return;
  for (int kk = 0; kk < k; ++kk) {
    atomicAdd(out + static_cast<size_t>(kk) * mi + i,
              __ldg(nd + static_cast<size_t>(kk) * mj + j));
  }
}

}  // namespace

extern "C" int elca_segsum_launch(const int* ca, int mi, const int* par,
                                  const int* nd, int mj, int k, int* out,
                                  void* stream) {
  if (mi < 0 || mj < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mi == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int) * static_cast<size_t>(k) * mi, s);
  if (err != cudaSuccess || mj == 0) return static_cast<int>(err);
  segsum_kernel<<<blocks_for(mj), kThreads, 0, s>>>(ca, mi, par, nd, mj, k,
                                                     out);
  return static_cast<int>(cudaGetLastError());
}
