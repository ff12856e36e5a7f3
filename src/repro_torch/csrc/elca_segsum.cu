// ELCA child sums for Hopper (sm_90a):
//   out[kk, i] = sum over j with par[j] == ca[i] of nd[kk, j].
//
// Replaces the TPU kernel src/repro/kernels/elca_segsum.py::_segsum_kernel
// (elca_segsum_pallas_call), the ELCA step of the chained query path.  Same
// function: ca [mi] int32 ascending, its real ids unique (an INT32_MAX tail
// may repeat); par [mj] int32 parent ids, -1 (any negative) for none; nd
// [k, mj] int32; out [k, mi] int32.  Nothing else is assumed of par: not
// that a parent precedes its child, nor that mj == mi.
//
// What bounds it on this card: the bytes of the inputs and the output.  Each
// j costs one search of ca and k integer adds, far below the integer rate.
// What a call waited on before this design was contention, and launches:
// one global atomicAdd per (child, keyword), and at 20,000 releases the
// chained path's Q2 and Q3 calls (mj = 20,001, k = 3 and 4) name two distinct
// parents, so 60,000-80,000 adds landed on a few addresses, which the card
// serialises (20-25 us a call); and 24 of its 36 calls have at most 1,024
// children, where a memset and a kernel of a few microseconds each are
// the whole cost.
//
// What the design does about it.  A TPU has no scatter, so its kernel built
// the dense (BI x BJ) equality mask tile by tile and contracted it with the
// k NDesc rows.  Here each thread takes one child:
//   * its parent's index comes from ca staged in shared memory with cp.async
//     (search.cuh::stage_window: whole up to kStage - 3 ids, else one id in
//     every kMinStep or more, and then one segment of fewer ids in global
//     memory, within two or three 128-byte lines; ca reaches 60,001 ids, 240
//     KB, above a block's 227 KB, and every block stages it, so fewer
//     samples read less of L2).  The parent id and NDesc load while ca is
//     staged;
//   * children of one parent among a warp's lanes (__match_any_sync) add up
//     in the warp first (search.cuh::group_add).
// Then two routes, chosen from the shapes:
//   dense: a call of at most kOneBlock children whose output fits kDenseInts
//     ints (most calls of the chained path) runs as one block that adds into
//     the whole output in shared memory and writes it once: no memset, no
//     global atomic;
//   tiles: blocks of kThreads children, after a memset of out.  A block's
//     parents go into a table in shared memory (open addressing over twice
//     as many slots as a tile can name parents, min(k, kMaxKeywords) integer
//     sums a key, more keywords in more passes), flushed with one global
//     atomicAdd per parent and keyword; a parent only one lane of its warp
//     names is added straight into out.  A star (every child under one
//     parent) sends one add per block and keyword to the parent, mj /
//     kThreads in all.
// Integer adds are exact in any order, so the output is identical run to run.
// One child a thread and blocks of 256 measured fastest on the main path's
// calls (PERF.md).
//
// Entry point: elca_segsum_launch (plain C; exported to Python by
// pyentry.cuh as the module elca_segsum).  One kernel (tiles: after a memset)
// on the caller's stream, no allocation, no synchronisation; returns the
// first cudaError_t seen (0 on success).

#include "pyentry.cuh"
#include "search.cuh"

namespace {

constexpr int kMinStep = 64;       // ids a sample of ca covers, at least
constexpr int kOneBlock = 1024;    // children the dense route takes (one block)
constexpr int kDenseInts = 16384;  // k * mi the dense route adds up (64 KB), at most
constexpr int kSlots = 2 * kThreads;  // table keys of a tile (a power of two)
constexpr int kMaxKeywords = 32;   // sums a table key holds in one pass
constexpr int kPrefetch = 4;       // keywords whose NDesc a thread loads with par
constexpr int kDirect = -2;        // slot of a parent added straight into out

// Ints of the staging buffer for ca: whole with its 16-byte phase (up to 3
// ints before it), or the samples; a multiple of 4, so what follows it stays
// 16-byte aligned.
__host__ __device__ inline int stage_ints(int mi) {
  return (mi <= kStage - 3 ? mi + 6 : kStage) & ~3;
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Child j's parent id (-1: none) and its first kPrefetch NDesc values, loaded
// while ca is staged.
struct Child {
  int p;
  int v[kPrefetch];
};

__device__ __forceinline__ Child load_child(const int* __restrict__ par,
                                            const int* __restrict__ nd, int mj,
                                            int k, int j) {
  Child c;
  c.p = j < mj ? __ldg(par + j) : -1;
#pragma unroll
  for (int kk = 0; kk < kPrefetch; ++kk) {
    c.v[kk] = j < mj && kk < k ? __ldg(nd + static_cast<size_t>(kk) * mj + j) : 0;
  }
  return c;
}

// The index of parent id p in ca (staged as s into stage); -1 when p is none
// or not in ca.
__device__ __forceinline__ int parent_index(const int* __restrict__ ca,
                                            const Staged& s, const int* stage,
                                            int p) {
  if (p < 0) return -1;
  bool found;
  const int pos = staged_lower_bound(ca, s, stage, p, found);
  return found ? pos : -1;
}

// Calls add(kk, value) for keywords [k0, k0 + kw) of child j, prefetched
// values first.
template <class Add>
__device__ __forceinline__ void each_keyword(const Child& c,
                                             const int* __restrict__ nd, int mj,
                                             int j, int k0, int kw, Add add) {
#pragma unroll
  for (int kk = 0; kk < kPrefetch; ++kk) {
    if (k0 == 0 && kk < kw) add(kk, c.v[kk]);
  }
  for (int kk = k0 == 0 ? kPrefetch : 0; kk < kw; ++kk) {
    add(kk, __ldg(nd + static_cast<size_t>(k0 + kk) * mj + j));
  }
}

// The dense route: the whole call in one block, one child a thread.  out
// adds up in shared memory (acc [k][mi]) and is written once, so it needs no
// zeroing and no global atomic.
__global__ void __launch_bounds__(kOneBlock)
    segsum_dense_kernel(const int* __restrict__ ca, int mi,
                        const int* __restrict__ par, const int* __restrict__ nd,
                        int mj, int k, int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  int* stage = smem;
  int* acc = smem + stage_ints(mi);  // [k][mi]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = k * mi;

  const Child c = load_child(par, nd, mj, k, tid);
  const Staged s = staged_of(ca, 0, mi, kMinStep);
  stage_window(ca, s, stage);
  cp_async_commit();
  for (int t = tid; t < n; t += nt) acc[t] = 0;
  cp_async_wait<0>();
  __syncthreads();

  const int i = parent_index(ca, s, stage, c.p);
  const unsigned group = __match_any_sync(0xffffffffu, i);
  if (i >= 0) {  // the same for every lane of the group
    each_keyword(c, nd, mj, tid, 0, k, [&](int kk, int val) {
      if (group == 1u << (tid & 31)) {
        atomicAdd(acc + kk * mi + i, val);
      } else {
        group_add(acc + kk * mi + i, val, group);
      }
    });
  }
  __syncthreads();
  for (int t = tid; t < n; t += nt) out[t] = acc[t];
}

// The slot of `key` (>= 0) in the open-addressed table `keys` (kSlots
// entries, -1 = empty), claimed if absent.  A tile names at most kThreads
// parents, half the slots, so the probe ends.
__device__ __forceinline__ int table_slot(int* keys, int key) {
  unsigned h = (static_cast<unsigned>(key) * 2654435761u) & (kSlots - 1);
  while (true) {
    const int prev = atomicCAS(keys + h, -1, key);
    if (prev == -1 || prev == key) return static_cast<int>(h);
    h = (h + 1) & (kSlots - 1);
  }
}

// The tiles route: kThreads children a block, one a thread, adding into out,
// which a memset zeroed first.
__global__ void __launch_bounds__(kThreads)
    segsum_tiles_kernel(const int* __restrict__ ca, int mi,
                        const int* __restrict__ par, const int* __restrict__ nd,
                        int mj, int k, int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  int* stage = smem;
  int* keys = smem + stage_ints(mi);  // [kSlots]: parent index, -1 = empty
  int* sums = keys + kSlots;          // [min(k, kMaxKeywords)][kSlots]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = blockIdx.x * kThreads + tid;

  const Child c = load_child(par, nd, mj, k, j);
  const Staged s = staged_of(ca, 0, mi, kMinStep);
  stage_window(ca, s, stage);
  cp_async_commit();
  for (int t = tid; t < kSlots; t += kThreads) keys[t] = -1;
  for (int t = tid; t < min(k, kMaxKeywords) * kSlots; t += kThreads) sums[t] = 0;
  cp_async_wait<0>();
  __syncthreads();

  // A parent that only this lane of the warp adds to is added straight into
  // out (slot kDirect); the lanes of a parent shared in the warp claim a
  // table slot once, by their first lane.
  const int i = parent_index(ca, s, stage, c.p);
  const unsigned group = __match_any_sync(0xffffffffu, i);
  const int leader = __ffs(group) - 1;
  int sl = kDirect;
  if (i >= 0 && lane == leader && group != (1u << lane)) sl = table_slot(keys, i);
  const int slot = __shfl_sync(0xffffffffu, sl, leader);

  for (int k0 = 0; k0 < k; k0 += kMaxKeywords) {
    const int kw = min(k - k0, kMaxKeywords);
    if (k0 > 0) {
      __syncthreads();  // the last pass is flushed
      for (int t = tid; t < kw * kSlots; t += kThreads) sums[t] = 0;
      __syncthreads();  // the sums are zero
    }
    if (i >= 0) {  // the same for every lane of the group
      each_keyword(c, nd, mj, j, k0, kw, [&](int kk, int val) {
        if (slot == kDirect) {
          atomicAdd(out + static_cast<size_t>(k0 + kk) * mi + i, val);
        } else {
          group_add(sums + kk * kSlots + slot, val, group);
        }
      });
    }
    __syncthreads();  // the table is complete
    for (int t = tid; t < kSlots; t += kThreads) {
      const int key = keys[t];
      if (key < 0) continue;
      for (int kk = 0; kk < kw; ++kk) {
        const int val = sums[kk * kSlots + t];
        if (val != 0) atomicAdd(out + static_cast<size_t>(k0 + kk) * mi + key, val);
      }
    }
  }
}

}  // namespace

extern "C" int elca_segsum_launch(const int* ca, int mi, const int* par,
                                  const int* nd, int mj, int k, int* out,
                                  void* stream) {
  if (mi < 0 || mj < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mi == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mj <= kOneBlock && static_cast<long long>(k) * mi <= kDenseInts) {
    int threads = 32;  // whole warps, a power of two, one child each
    while (threads < mj) threads *= 2;
    const size_t smem = sizeof(int) * (stage_ints(mi) + static_cast<size_t>(k) * mi);
    err = allow_smem(reinterpret_cast<const void*>(segsum_dense_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    segsum_dense_kernel<<<1, threads, smem, st>>>(ca, mi, par, nd, mj, k, out);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(k) * mi, st);
  if (err != cudaSuccess || mj == 0) return static_cast<int>(err);
  const int kw = k < kMaxKeywords ? k : kMaxKeywords;
  const size_t smem =
      sizeof(int) * (stage_ints(mi) + kSlots + static_cast<size_t>(kw) * kSlots);
  err = allow_smem(reinterpret_cast<const void*>(segsum_tiles_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_tiles_kernel<<<(mj + kThreads - 1) / kThreads, kThreads, smem, st>>>(
      ca, mi, par, nd, mj, k, out);
  return static_cast<int>(cudaGetLastError());
}

PYENTRY_MODULE(elca_segsum, PYENTRY_FN(elca_segsum_launch))
