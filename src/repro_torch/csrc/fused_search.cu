// Fused keyword search for Hopper (sm_90a): membership -> CA mask ->
// SLCA / ELCA / CA keep rule over one PlanCache-packed batch.
//
// Replaces the TPU kernel src/repro/kernels/fused_search.py::_fused_kernel
// (the pallas_call built in _fused_variant).  Same function, same outputs:
// for each packed row r and L0 slot i,
//   ca[i]       = i < n0[r] and ids0[r,i] is in every other list of row r
//   SLCA keeps a CA that no CA names as its parent,
//   ELCA keeps a CA when nd[k,i] - sum over CA children j of nd[k,j] >= 1
//        for every keyword k,
//   CA   keeps every CA;
// keep_ids[r,i] = ids0[r,i] where kept, else INT32_MAX; keep_mask is 0/1.
//
// What bounds it on this card: the bytes of the packed batch.  Every L0 entry
// costs O(k log mo) compares against 4-byte ids, far below the card's integer
// rate, so the least time is (inputs read once + outputs written once) over
// HBM bandwidth.  The posting lists of one round are a few MB at most, so the
// binary searches' repeated reads land in the 50 MB L2, not in HBM.
//
// What the design does about it: it is the simple, right version.  The TPU
// kernel kept L0 resident in VMEM and streamed host-computed block windows of
// the other lists through a dense (L0 x block) compare; that VMEM budget is
// what capped its L0 bucket at 8192.  Here each thread owns one L0 entry and
// binary-searches the other lists in global memory (pass 1), one thread per
// CA finds its parent's L0 position by binary search and adds into the
// parent's counters with integer atomics, exact in any order (pass 2), and a
// last pass applies the keep rule (pass 3).  No shared-memory budget, so no
// cap on m0, and no host window bookkeeping.  Keeping L0 in shared memory and
// fusing the three passes into one launch are later work.
//
// Entry point: fused_search_launch (plain C, loaded with ctypes).  It launches
// the three passes on the caller's stream, allocates nothing, does not
// synchronise, and returns the first cudaError_t seen (0 on success).  The
// scratch it is given (ca, ndo, cnt, sums) needs no initialisation.

#include "search.cuh"

namespace {

constexpr int kSlca = 0;
constexpr int kElca = 1;
constexpr int kCa = 2;

// Pass 1: membership of each L0 entry in the k-1 other lists (their INT_PAD
// tails keep every row sorted; a real id never equals INT_PAD), plus the
// matching NDesc for ELCA.  Only slots below n0 may become CAs, which also
// kills the pad == pad matches.  It also zeroes the slot's pass-2 counters
// (the child count, and the k sums for ELCA), so the wrapper needs no
// memset: pass 2 starts after pass 1 ends on the same stream.
__global__ void membership_kernel(const int* __restrict__ ids0,
                                  const int* __restrict__ n0,
                                  const int* __restrict__ other_ids,
                                  const int* __restrict__ other_nd, int rows,
                                  int m0, int k1, int mo, int elca,
                                  int* __restrict__ ca, int* __restrict__ ndo,
                                  int* __restrict__ cnt,
                                  int* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m0) return;
  const int k = k1 + 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t slot = static_cast<size_t>(r) * m0 + i;
    cnt[slot] = 0;
    if (elca) {
      for (int kk = 0; kk < k; ++kk) {
        sums[(static_cast<size_t>(r) * k + kk) * m0 + i] = 0;
      }
    }
    const int id = ids0[slot];
    int is_ca = i < n0[r];
    for (int kk = 0; kk < k1 && is_ca; ++kk) {
      const size_t base = (static_cast<size_t>(r) * k1 + kk) * mo;
      const int p = lower_bound(other_ids + base, mo, id);
      is_ca = p < mo && other_ids[base + p] == id;
      if (is_ca && elca) {
        ndo[(static_cast<size_t>(r) * k1 + kk) * m0 + i] = other_nd[base + p];
      }
    }
    ca[slot] = is_ca;
  }
}

// Pass 2: each CA whose parent (pid0 holds parent ids, -1 at a root) is a CA
// of the same row adds 1 to the parent's child count and, for ELCA, its NDesc
// per keyword to the parent's sums.  Integer atomics: exact in any order.
__global__ void parent_kernel(const int* __restrict__ ids0,
                              const int* __restrict__ pid0,
                              const int* __restrict__ nd0,
                              const int* __restrict__ n0,
                              const int* __restrict__ ca,
                              const int* __restrict__ ndo, int rows, int m0,
                              int k1, int elca, int* __restrict__ cnt,
                              int* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m0) return;
  const int k = k1 + 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row0 = static_cast<size_t>(r) * m0;
    if (!ca[row0 + i]) continue;
    const int pid = pid0[row0 + i];
    if (pid < 0) continue;
    const int n = min(n0[r], m0);
    const int p = lower_bound(ids0 + row0, n, pid);
    if (p >= n || ids0[row0 + p] != pid || !ca[row0 + p]) continue;
    atomicAdd(cnt + row0 + p, 1);
    if (elca) {
      const size_t sbase = static_cast<size_t>(r) * k * m0;
      atomicAdd(sums + sbase + p, nd0[row0 + i]);
      for (int kk = 0; kk < k1; ++kk) {
        atomicAdd(sums + sbase + static_cast<size_t>(kk + 1) * m0 + p,
                  ndo[(static_cast<size_t>(r) * k1 + kk) * m0 + i]);
      }
    }
  }
}

// Pass 3: the keep rule, written in L0 order (ascending, no compaction).
__global__ void keep_kernel(const int* __restrict__ ids0,
                            const int* __restrict__ nd0,
                            const int* __restrict__ ca,
                            const int* __restrict__ ndo,
                            const int* __restrict__ cnt,
                            const int* __restrict__ sums, int rows, int m0,
                            int k1, int semantics, int* __restrict__ keep_ids,
                            unsigned char* __restrict__ keep_mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m0) return;
  const int k = k1 + 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t slot = static_cast<size_t>(r) * m0 + i;
    int keep = ca[slot];
    if (keep && semantics == kSlca) {
      keep = cnt[slot] == 0;
    } else if (keep && semantics == kElca) {
      const size_t sbase = static_cast<size_t>(r) * k * m0;
      keep = nd0[slot] - sums[sbase + i] >= 1;
      for (int kk = 0; kk < k1 && keep; ++kk) {
        keep = ndo[(static_cast<size_t>(r) * k1 + kk) * m0 + i] -
                   sums[sbase + static_cast<size_t>(kk + 1) * m0 + i] >=
               1;
      }
    }
    keep_ids[slot] = keep ? ids0[slot] : kIntPad;
    keep_mask[slot] = static_cast<unsigned char>(keep ? 1 : 0);
  }
}

}  // namespace

extern "C" int fused_search_launch(
    const int* ids0, const int* pid0, const int* nd0, const int* other_ids,
    const int* other_nd, const int* n0, int rows, int m0, int k1, int mo,
    int semantics, int* keep_ids, unsigned char* keep_mask, int* ca, int* ndo,
    int* cnt, int* sums, void* stream) {
  if (rows <= 0 || m0 <= 0) return 0;
  if (k1 < 0 || (k1 > 0 && mo <= 0) || semantics < kSlca || semantics > kCa) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const dim3 grid(blocks_for(m0), rows < kMaxGridY ? rows : kMaxGridY);
  const int elca = semantics == kElca;

  membership_kernel<<<grid, block, 0, s>>>(ids0, n0, other_ids, other_nd, rows,
                                           m0, k1, mo, elca, ca, ndo, cnt,
                                           sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (semantics != kCa) {
    parent_kernel<<<grid, block, 0, s>>>(ids0, pid0, nd0, n0, ca, ndo, rows,
                                         m0, k1, elca, cnt, sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  keep_kernel<<<grid, block, 0, s>>>(ids0, nd0, ca, ndo, cnt, sums, rows, m0,
                                     k1, semantics, keep_ids, keep_mask);
  return static_cast<int>(cudaGetLastError());
}
