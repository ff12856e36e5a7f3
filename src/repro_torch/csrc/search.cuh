// Shared pieces of the port's search kernels: launch shape, the binary
// searches every kernel runs, the staged windows of a sorted row in shared
// memory (searchsorted, elca_segsum) and the staged-window membership of a
// tile of sorted keys that the intersect and fused kernels share, and the
// warp-combined atomic add (fused_search, elca_segsum).  Header only; each
// kernel source is built on its own (see repro_torch/kernels/_build.py, which
// hashes this file too).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kIntPad = 0x7fffffff;

// Ints in one staging buffer of tile_membership (two buffers, 32 KB in all).
// A window of up to kStage - 3 ids is staged whole; a longer one is sampled
// every `step` ids so that at most kStage samples are staged.
constexpr int kStage = 4096;

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

// The same over a row in shared memory.
__device__ __forceinline__ int smem_lower_bound(const int* row, int n,
                                                int key) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The lower bound (upper == false: first value >= key) or upper bound (first
// value > key) of key in row[0, n), found by all 32 lanes of a warp together:
// each round the lanes probe 32 evenly spaced positions of [lo, hi) and a
// ballot keeps the gap between the last probe before key and the first one
// after it, so a round cuts the interval 33-fold (4 rounds of dependent loads
// for 10^5 ids, where one thread needs 17).  Every lane returns the bound.
__device__ __forceinline__ int warp_bound(const int* __restrict__ row, int n,
                                          int key, bool upper) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const long long len = hi - lo;
    const int q = lo + static_cast<int>((lane + 1) * len / 33);
    const int v = __ldg(row + q);
    const int c = __popc(__ballot_sync(0xffffffffu, upper ? v <= key : v < key));
    // probes lie in [lo, hi), ascending with the lane; lanes [0, c) are below
    const int new_lo = c > 0 ? lo + static_cast<int>(c * len / 33) + 1 : lo;
    hi = c < 32 ? lo + static_cast<int>((c + 1) * len / 33) : hi;
    lo = new_lo;
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One sorted list of ids in global memory: row[0, n).
struct RowList {
  const int* row;
  int n;
};

// A window row[lo, hi) staged in a buffer of kStage ints.  step == 1: the
// whole window, buf[shift + g - lo] = row[g], where shift (0..3) puts row[g]
// and buf[shift + g - lo] on the same 16-byte phase, so the aligned middle is
// copied 16 bytes at a time.  step > 1: a sample, buf[t] = row[lo + t * step]
// for t < count.
struct Staged {
  int lo, hi, step, shift, count;
};

//
// A sample takes at least min_step ids a step: every sample is a separate
// 32-byte read, so a kernel whose every block stages the same long row reads
// less of L2 with fewer samples, while the segment a search finishes in stays
// within one or two 128-byte lines up to a step of 32.
__device__ __forceinline__ Staged staged_of(const int* row, int lo, int hi,
                                            int min_step = 2) {
  const int w = hi - lo;
  Staged s{lo, hi, 1, 0, w};
  if (w <= kStage - 3) {
    s.shift = static_cast<int>((reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
  } else {
    // at least 2, for 4,094-4,096 ids too
    s.step = max(max(2, min_step), (w + kStage - 1) / kStage);
    s.count = (w + s.step - 1) / s.step;
  }
  return s;
}

// Start the copies that stage `s` into buf (every thread of the block calls
// this; the caller commits and waits).  Whole windows: the ids before the
// first and after the last 16-byte boundary by plain loads, the middle by
// 16-byte cp.async.  Samples: one 4-byte cp.async each.
__device__ __forceinline__ void stage_window(const int* __restrict__ row,
                                             const Staged& s, int* buf) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (s.step > 1) {
    for (int t = tid; t < s.count; t += nt) {
      cp_async4(buf + t, row + s.lo + static_cast<long long>(t) * s.step);
    }
    return;
  }
  int* dst = buf + s.shift;  // dst[g - lo] holds row[g]
  const int a = min(s.lo + ((4 - s.shift) & 3), s.hi);  // first aligned id
  const int b = max(a, s.hi - static_cast<int>(
                          (reinterpret_cast<uintptr_t>(row + s.hi) >> 2) & 3));
  for (int g = s.lo + tid; g < a; g += nt) dst[g - s.lo] = __ldg(row + g);
  for (int g = b + tid; g < s.hi; g += nt) dst[g - s.lo] = __ldg(row + g);
  for (int g = a + 4 * tid; g < b; g += 4 * nt) cp_async16(dst + (g - s.lo), row + g);
}

// The lower bound of key in the whole row, read from the staged window: the
// window [lo, hi) must hold every id of the row between the tile's first and
// last key, and key must lie between them.  Sets `found`.
__device__ __forceinline__ int staged_lower_bound(const int* __restrict__ row,
                                                  const Staged& s,
                                                  const int* buf, int key,
                                                  bool& found) {
  if (s.step == 1) {
    const int* w = buf + s.shift;
    const int p = smem_lower_bound(w, s.hi - s.lo, key);
    found = p < s.hi - s.lo && w[p] == key;
    return s.lo + p;
  }
  // samples: the first one >= key bounds a segment of at most step - 1 ids
  const int t = smem_lower_bound(buf, s.count, key);
  int p = s.lo;
  if (t > 0) {
    const int seg_lo = s.lo + (t - 1) * s.step + 1;
    const int seg_hi = min(s.lo + t * s.step, s.hi);
    p = seg_lo + lower_bound(row + seg_lo, seg_hi - seg_lo, key);
  }
  found = p < s.hi && __ldg(row + p) == key;
  return p;
}

// Membership of the block's slots [slot0, slot1) in k1 sorted lists.  The
// slots' keys (key_of(slot)) must ascend; list_of(j) gives list j.  The slots
// are cut into tiles of blockDim.x; for each (tile, list) job a warp finds the
// list's window (lower bound of the tile's first key, upper bound of its
// last), all jobs' windows at once, into win[2 * jobs]; then the jobs run in
// order, each window staged through one of the two kStage buffers in `stage`
// (16-byte aligned) while the previous job searches the other.  The thread
// that owns a slot calls sink(j, slot, found, pos), pos being the lower bound
// of its key in list j.  Every thread of the block must call this with the
// same arguments, and blockDim.x must be a multiple of 32.  When there is a
// job it ends with a barrier, so the buffers may be reused.
template <class ListOf, class KeyOf, class Sink>
__device__ void tile_membership(int slot0, int slot1, int k1, ListOf list_of,
                                KeyOf key_of, int* win, int* stage,
                                Sink sink) {
  const int nt = blockDim.x;
  const int tiles = slot1 > slot0 ? (slot1 - slot0 + nt - 1) / nt : 0;
  const int jobs = tiles * k1;
  if (jobs == 0) return;
  const int warp = threadIdx.x >> 5;
  for (int b = warp; b < 2 * jobs; b += nt >> 5) {
    const int job = b >> 1;
    const int first = slot0 + (job / k1) * nt;
    const int last = min(first + nt, slot1) - 1;
    const RowList l = list_of(job % k1);
    const int bound = warp_bound(l.row, l.n, key_of((b & 1) ? last : first), b & 1);
    if ((threadIdx.x & 31) == 0) win[b] = bound;
  }
  __syncthreads();

  auto staged = [&](int job) {
    return staged_of(list_of(job % k1).row, win[2 * job], win[2 * job + 1]);
  };
  stage_window(list_of(0).row, staged(0), stage);
  cp_async_commit();
  for (int job = 0; job < jobs; ++job) {
    if (job + 1 < jobs) {
      stage_window(list_of((job + 1) % k1).row, staged(job + 1),
                   stage + ((job + 1) & 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = slot0 + (job / k1) * nt + threadIdx.x;
    if (slot < slot1) {
      const int j = job % k1;
      bool found;
      const int p = staged_lower_bound(list_of(j).row, staged(job),
                                       stage + (job & 1) * kStage,
                                       key_of(slot), found);
      sink(j, slot, found, p);
    }
    __syncthreads();
  }
}

// Adds v of every lane in `group` (lanes of one warp that add into the same
// address, __match_any_sync) into *addr (global or shared memory) with one
// atomic.  Every lane of the group must call it.  Many CAs share a parent
// (at 20,000 releases every release's is the root), and atomics on one
// address serialise.
__device__ __forceinline__ void group_add(int* addr, int v, unsigned group) {
  const int total = __reduce_add_sync(group, v);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(group) - 1) atomicAdd(addr, total);
}

// Blocks along x cover `n` threads' worth of work.
inline unsigned int blocks_for(int n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace
