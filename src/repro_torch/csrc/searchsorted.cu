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
// costs one search of its row, far below the card's integer rate; a row is
// at most a few hundred KB, so repeated reads of it land in the 50 MB L2.
// What a query waits on is latency: a binary search of a row in global
// memory is ceil(log2 m) + 1 dependent loads (17 for the service's rows of
// 131,072 ids).
//
// What the design does about it.  The TPU kernel had no fast scalar search,
// so it compared a (BQ x BA) tile densely and summed rows.  Here one block
// owns a tile of kTile queries of one row (kPerThread a thread, read and
// written coalesced), and each thread searches shared memory:
//   * a row of at most kStage - 3 ids is staged whole with cp.async
//     (search.cuh::stage_window) while the keys load;
//   * a longer row: the block takes the tile's least and greatest key, two
//     warps find their lower bounds in the row by a 33-ary search
//     (search.cuh::warp_bound, 4 rounds of loads for 10^5 ids), and the
//     block stages that window, since every answer of the tile lies in it:
//     whole up to kStage - 3 ids, else every step-th id, and then a thread
//     finishes in one segment of fewer than step ids in global memory
//     (staged_lower_bound).
// Queries in any order work: a tile of scattered keys has a wide window,
// which is sampled.  The service's queries are each row's ascending L0 ids,
// so a tile's window is a few thousand ids at most and is searched in shared
// memory alone, and a tile of INT32_MAX padding has an empty window.  Tiles
// of 512 queries measured fastest on the service's calls: more, shorter
// blocks wait less on their window search (PERF.md).
//
// Entry point: searchsorted_launch (plain C; exported to Python by
// pyentry.cuh as the module searchsorted).  One launch on the caller's
// stream, no allocation, no synchronisation; returns the cudaError_t of the
// launch (0 on success).

#include "pyentry.cuh"
#include "search.cuh"

namespace {

constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;  // queries a block

// The tile's window of a row too long to stage whole: from the block's least
// and greatest key (`key`: this thread's, of the queries first + u * kThreads
// + tid < nq), their lower bounds in the row by two warps; returns row[lower
// bound of least, lower bound of greatest) as staged (whole or sampled).
// Every thread calls it.
__device__ __forceinline__ Staged search_window(const int* __restrict__ row, int m,
                                                const int (&key)[kPerThread], int first,
                                                int nq, int* lows, int* highs,
                                                int* window) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  int lo_key = kIntPad;
  int hi_key = -kIntPad - 1;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (first + u * kThreads + tid < nq) {
      lo_key = min(lo_key, key[u]);
      hi_key = max(hi_key, key[u]);
    }
  }
  lo_key = __reduce_min_sync(0xffffffffu, lo_key);
  hi_key = __reduce_max_sync(0xffffffffu, hi_key);
  if ((tid & 31) == 0) {
    lows[warp] = lo_key;
    highs[warp] = hi_key;
  }
  __syncthreads();
  if (warp < 2) {
    int bound = warp == 0 ? kIntPad : -kIntPad - 1;
    for (int w = 0; w < kThreads / 32; ++w) {
      bound = warp == 0 ? min(bound, lows[w]) : max(bound, highs[w]);
    }
    // the lower bound of every key of the tile lies in [lower bound of the
    // least key, lower bound of the greatest]
    bound = warp_bound(row, m, bound, false);
    if ((tid & 31) == 0) window[warp] = bound;
  }
  __syncthreads();
  return staged_of(row, window[0], window[1]);
}

__global__ void __launch_bounds__(kThreads)
    searchsorted_kernel(const int* __restrict__ a, const int* __restrict__ q,
                        int rows, int m, int nq, int* __restrict__ out) {
  __shared__ __align__(16) int stage[kStage];
  __shared__ int lows[kThreads / 32], highs[kThreads / 32], window[2];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const bool whole = m <= kStage - 3;  // every row staged whole, no window
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int* row = a + static_cast<size_t>(r) * m;
    const size_t q0 = static_cast<size_t>(r) * nq;
    int key[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = first + u * kThreads + tid;
      key[u] = i < nq ? __ldg(q + q0 + i) : 0;
    }
    // a whole row is staged while the keys are in flight
    const Staged s = whole ? staged_of(row, 0, m)
                           : search_window(row, m, key, first, nq, lows, highs, window);
    stage_window(row, s, stage);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = first + u * kThreads + tid;
      if (i < nq) {
        bool found;
        out[q0 + i] = staged_lower_bound(row, s, stage, key[u], found);
      }
    }
    __syncthreads();  // the next row stages into the same buffer
  }
}

}  // namespace

extern "C" int searchsorted_launch(const int* a, const int* q, int rows, int m,
                                   int nq, int* out, void* stream) {
  if (rows <= 0 || nq <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kTile - 1) / kTile, rows < kMaxGridY ? rows : kMaxGridY);
  searchsorted_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, q, rows, m, nq, out);
  return static_cast<int>(cudaGetLastError());
}

PYENTRY_MODULE(searchsorted, PYENTRY_FN(searchsorted_launch))
