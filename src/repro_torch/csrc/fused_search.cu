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
// searches' repeated reads land in the 50 MB L2.  What a call actually waits
// on is latency: its launches, the round trips of the CA mask, counts and
// sums through global memory between them, the dependent loads of binary
// searches in global memory, and atomics on one address (every release
// node's parent is the root).
//
// What the design does about it.  Two routes, chosen by the wrapper from the
// shape (rows, k, m0, semantics) alone (kernels/fused_search.py::route):
//   rows: one block per packed row, one launch, no scratch.  The row's L0
//     state lives in shared memory for the whole call, as the TPU kernel kept
//     L0 in VMEM: ids, the CA mask, and the child count (SLCA) or the k-1
//     gathered NDesc and the k sums (ELCA).  Membership stages each other
//     list's window for each tile of L0 through shared memory
//     (search.cuh::tile_membership, as the intersect kernel does), searching
//     only the list's valid length other_n; each CA finds its parent by a
//     binary search of L0 in shared memory and adds into the parent's count
//     or sums with shared-memory integer atomics, exact in any order, one
//     per parent among a warp's lanes (group_add); barriers separate the
//     phases, and the keep rule writes the outputs.
//     It takes any row whose state fits in 227 KB; the wrapper sends it rows
//     of at most 2,048 slots, which one block does in at most four tiles of
//     512;
//   tiles: for longer rows, which one block would walk too slowly (a batch
//     of one row of 65,536 slots would leave 131 SMs idle), three launches
//     over tiles of 256 slots: membership (the same staged windows, over
//     other_n) with each CA's parent position (a search of L0 staged in
//     shared memory, whole or sampled), parents (global integer atomics,
//     one per parent among a warp's lanes), keep.  The wrapper gives it scratch planes, which the first launch
//     initialises.
//
// Entry point: fused_search_launch (plain C, loaded with ctypes).  It launches
// the route's kernels on the caller's stream, allocates nothing, does not
// synchronise, and returns the first cudaError_t seen (0 on success).

#include "search.cuh"

namespace {

constexpr int kSlca = 0;
constexpr int kElca = 1;
constexpr int kCa = 2;
constexpr int kRouteRows = 0;
constexpr int kRouteTiles = 1;
constexpr int kRowThreads = 512;  // the rows route's block, for m0 >= 512
constexpr int kSmemMax = 232448;  // shared memory a block can have (227 KB)

// Threads of the rows route's block for rows of m0 slots: whole warps, at
// least two (tile_membership's windows take one warp each).
inline int row_threads(int m0) {
  return m0 >= kRowThreads ? kRowThreads : (m0 <= 64 ? 64 : (m0 + 31) / 32 * 32);
}

// Bytes of the rows route's shared memory; kernels/fused_search.py::route
// computes the same.
inline size_t row_smem(int m0, int k1, int semantics) {
  const int nt = row_threads(m0);
  const size_t jobs = static_cast<size_t>((m0 + nt - 1) / nt) * k1;
  size_t ints = 2 * static_cast<size_t>(kStage) + 2 * jobs + m0;  // stage, win, ids
  if (semantics == kSlca) ints += m0;                              // cnt
  if (semantics == kElca) ints += static_cast<size_t>(2 * k1 + 1) * m0;  // ndo, sums
  return ints * sizeof(int) + m0;                                  // + ca bytes
}

// Adds v of every lane in `group` (lanes of one warp that add into the same
// address, __match_any_sync) into *addr with one atomic.  Many CAs share a
// parent (at 20,000 releases every release's is the root), and atomics on
// one address serialise.
__device__ __forceinline__ void group_add(int* addr, int v, unsigned group) {
  const int total = __reduce_add_sync(group, v);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(group) - 1) atomicAdd(addr, total);
}

// The valid length of other list j of row r (the bucket when other_n is not
// given: its INT_PAD tail keeps the row sorted, and no real id equals it).
__device__ __forceinline__ int other_len(const int* __restrict__ other_n,
                                         int r, int k1, int j, int mo) {
  return other_n ? min(__ldg(other_n + static_cast<size_t>(r) * k1 + j), mo) : mo;
}

// ---- rows route ----------------------------------------------------------- //

__global__ void fused_rows_kernel(
    const int* __restrict__ ids0, const int* __restrict__ pid0,
    const int* __restrict__ nd0, const int* __restrict__ other_ids,
    const int* __restrict__ other_nd, const int* __restrict__ n0,
    const int* __restrict__ other_n, int m0, int k1, int mo, int semantics,
    int* __restrict__ keep_ids, unsigned char* __restrict__ keep_mask) {
  extern __shared__ __align__(16) int smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int jobs = (m0 + nt - 1) / nt * k1;
  int* stage = smem;
  int* win = stage + 2 * kStage;
  int* ids = win + 2 * jobs;
  int* cnt = ids + m0;   // SLCA: [m0]
  int* ndo = ids + m0;   // ELCA: [k1][m0], then sums [k][m0]
  int* sums = ndo + static_cast<size_t>(k1) * m0;
  unsigned char* ca = reinterpret_cast<unsigned char*>(
      ids + m0 + (semantics == kSlca ? m0 : semantics == kElca ? (2 * k1 + 1) * m0 : 0));

  const size_t row0 = static_cast<size_t>(r) * m0;
  const int n = min(__ldg(n0 + r), m0);
  for (int s = tid; s < m0; s += nt) {
    if (s < n) ids[s] = __ldg(ids0 + row0 + s);
    ca[s] = s < n;
    if (semantics == kSlca) cnt[s] = 0;
    if (semantics == kElca) {
      for (int kk = 0; kk <= k1; ++kk) sums[static_cast<size_t>(kk) * m0 + s] = 0;
    }
  }
  __syncthreads();

  const int* lists = other_ids + static_cast<size_t>(r) * k1 * mo;  // row r's
  const int* lists_nd = other_nd + static_cast<size_t>(r) * k1 * mo;
  tile_membership(
      0, n, k1,
      [&](int j) {
        return RowList{lists + static_cast<size_t>(j) * mo, other_len(other_n, r, k1, j, mo)};
      },
      [&](int s) { return ids[s]; }, win, stage,
      [&](int j, int s, bool found, int p) {
        if (!found) ca[s] = 0;
        if (semantics == kElca) {
          ndo[static_cast<size_t>(j) * m0 + s] =
              found ? __ldg(lists_nd + static_cast<size_t>(j) * mo + p) : 0;
        }
      });
  __syncthreads();

  if (semantics != kCa) {
    for (int base = 0; base < n; base += nt) {  // every lane runs each round
      const int s = base + tid;
      int p = -1;
      if (s < n && ca[s]) {
        const int pid = __ldg(pid0 + row0 + s);
        p = pid < 0 ? n : smem_lower_bound(ids, n, pid);
        if (p >= n || ids[p] != pid || !ca[p]) p = -1;
      }
      const unsigned adders = __ballot_sync(0xffffffffu, p >= 0);
      if (p < 0) continue;
      const unsigned group = __match_any_sync(adders, p);
      if (semantics == kSlca) {
        group_add(cnt + p, 1, group);
      } else {
        group_add(sums + p, __ldg(nd0 + row0 + s), group);
        for (int kk = 0; kk < k1; ++kk) {
          group_add(sums + static_cast<size_t>(kk + 1) * m0 + p,
                    ndo[static_cast<size_t>(kk) * m0 + s], group);
        }
      }
    }
    __syncthreads();
  }

  for (int s = tid; s < m0; s += nt) {
    bool keep = ca[s];
    if (keep && semantics == kSlca) {
      keep = cnt[s] == 0;
    } else if (keep && semantics == kElca) {
      keep = __ldg(nd0 + row0 + s) - sums[s] >= 1;
      for (int kk = 0; kk < k1 && keep; ++kk) {
        keep = ndo[static_cast<size_t>(kk) * m0 + s] -
                   sums[static_cast<size_t>(kk + 1) * m0 + s] >= 1;
      }
    }
    keep_ids[row0 + s] = keep ? ids[s] : kIntPad;
    keep_mask[row0 + s] = static_cast<unsigned char>(keep ? 1 : 0);
  }
}

// ---- tiles route ---------------------------------------------------------- //

// Pass 1: membership of one tile of kThreads L0 slots of row r in the k-1
// other lists (staged windows over their valid lengths), plus the matching
// NDesc for ELCA.  Only slots below n0 may become CAs.  Then, for SLCA and
// ELCA, each CA's parent position in L0 (-1 when its parent is not in L0):
// the block stages the row's valid L0 ids (whole, or every step-th id past
// kStage - 3) and searches there, where a binary search of L0 in global
// memory would wait on some 16 dependent loads.  It also zeroes the slot's
// pass-2 counters (the child count, and the k sums for ELCA), so the wrapper
// needs no memset: pass 2 starts after pass 1 ends on the same stream.
__global__ void membership_kernel(const int* __restrict__ ids0,
                                  const int* __restrict__ pid0,
                                  const int* __restrict__ n0,
                                  const int* __restrict__ other_ids,
                                  const int* __restrict__ other_nd,
                                  const int* __restrict__ other_n, int rows,
                                  int m0, int k1, int mo, int semantics,
                                  int* __restrict__ ca, int* __restrict__ ndo,
                                  int* __restrict__ cnt,
                                  int* __restrict__ sums,
                                  int* __restrict__ ppos) {
  extern __shared__ __align__(16) int smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = k1 + 1;
  const int elca = semantics == kElca;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row0 = static_cast<size_t>(r) * m0;
    if (i < m0) {
      cnt[row0 + i] = 0;
      if (elca) {
        for (int kk = 0; kk < k; ++kk) sums[(static_cast<size_t>(r) * k + kk) * m0 + i] = 0;
      }
    }
    const int n = min(__ldg(n0 + r), m0);
    const int slot0 = blockIdx.x * blockDim.x;
    const int* lists = other_ids + static_cast<size_t>(r) * k1 * mo;
    const int* lists_nd = other_nd + static_cast<size_t>(r) * k1 * mo;
    bool all = i < n;
    tile_membership(
        slot0, min(slot0 + static_cast<int>(blockDim.x), n), k1,
        [&](int j) {
          return RowList{lists + static_cast<size_t>(j) * mo, other_len(other_n, r, k1, j, mo)};
        },
        [&](int s) { return __ldg(ids0 + row0 + s); }, smem + 2 * kStage, smem,
        [&](int j, int s, bool found, int p) {
          all = all && found;
          if (elca) {
            ndo[(static_cast<size_t>(r) * k1 + j) * m0 + s] =
                found ? __ldg(lists_nd + static_cast<size_t>(j) * mo + p) : 0;
          }
        });
    if (i < m0) ca[row0 + i] = all;
    if (semantics != kCa && slot0 < n) {
      // tile_membership ended with a barrier (or used no shared memory)
      const int* l0 = ids0 + row0;
      const Staged w = staged_of(l0, 0, n);
      stage_window(l0, w, smem);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      int p = -1;
      const int pid = all ? __ldg(pid0 + row0 + i) : -1;
      if (pid >= 0) {
        bool found;
        const int q = staged_lower_bound(l0, w, smem, pid, found);
        p = found ? q : -1;
      }
      if (i < m0) ppos[row0 + i] = p;
      __syncthreads();  // the next row stages into the same buffer
    }
  }
}

// Pass 2: each CA whose parent (at ppos, from pass 1) is a CA of the same row
// adds 1 to the parent's child count (SLCA) or, for ELCA, its NDesc per
// keyword to the parent's sums.  Integer atomics, exact in any order, one
// per parent among a warp's lanes (group_add).
__global__ void parent_kernel(const int* __restrict__ nd0,
                              const int* __restrict__ ca,
                              const int* __restrict__ ppos,
                              const int* __restrict__ ndo, int rows, int m0,
                              int k1, int elca, int* __restrict__ cnt,
                              int* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = k1 + 1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row0 = static_cast<size_t>(r) * m0;
    int p = -1;
    if (i < m0 && ca[row0 + i]) {
      p = ppos[row0 + i];
      if (p >= 0 && !ca[row0 + p]) p = -1;
    }
    const unsigned adders = __ballot_sync(0xffffffffu, p >= 0);
    if (p < 0) continue;
    const unsigned group = __match_any_sync(adders, p);
    if (!elca) {
      group_add(cnt + row0 + p, 1, group);
      continue;
    }
    const size_t sbase = static_cast<size_t>(r) * k * m0;
    group_add(sums + sbase + p, nd0[row0 + i], group);
    for (int kk = 0; kk < k1; ++kk) {
      group_add(sums + sbase + static_cast<size_t>(kk + 1) * m0 + p,
                ndo[(static_cast<size_t>(r) * k1 + kk) * m0 + i], group);
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

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int fused_search_launch(
    const int* ids0, const int* pid0, const int* nd0, const int* other_ids,
    const int* other_nd, const int* n0, const int* other_n, int rows, int m0,
    int k1, int mo, int semantics, int route, int* keep_ids,
    unsigned char* keep_mask, int* ca, int* ndo, int* cnt, int* sums,
    int* ppos, void* stream) {
  if (rows <= 0 || m0 <= 0) return 0;
  if (k1 < 0 || (k1 > 0 && mo <= 0) || semantics < kSlca || semantics > kCa) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == kRouteRows) {
    const size_t smem = row_smem(m0, k1, semantics);
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    err = allow_smem(reinterpret_cast<const void*>(fused_rows_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_rows_kernel<<<rows, row_threads(m0), smem, s>>>(
        ids0, pid0, nd0, other_ids, other_nd, n0, other_n, m0, k1, mo, semantics,
        keep_ids, keep_mask);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRouteTiles) return static_cast<int>(cudaErrorInvalidValue);

  const dim3 block(kThreads);
  const dim3 grid(blocks_for(m0), rows < kMaxGridY ? rows : kMaxGridY);
  const int elca = semantics == kElca;
  const size_t smem = (2 * static_cast<size_t>(kStage) + 2 * k1) * sizeof(int);
  err = allow_smem(reinterpret_cast<const void*>(membership_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  membership_kernel<<<grid, block, smem, s>>>(ids0, pid0, n0, other_ids,
                                              other_nd, other_n, rows, m0, k1,
                                              mo, semantics, ca, ndo, cnt, sums,
                                              ppos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (semantics != kCa) {
    parent_kernel<<<grid, block, 0, s>>>(nd0, ca, ppos, ndo, rows, m0, k1,
                                         elca, cnt, sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  keep_kernel<<<grid, block, 0, s>>>(ids0, nd0, ca, ndo, cnt, sums, rows, m0,
                                     k1, semantics, keep_ids, keep_mask);
  return static_cast<int>(cudaGetLastError());
}
