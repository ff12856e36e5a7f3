// The CUDA subset the scan kernels (src/repro_torch/csrc/{mamba_scan,
// rwkv6_wkv}.cu) use, emulated on the CPU so that their sources compile with
// g++ and run in the CPU tests (tests/test_torch_scan_emulated.py):
//
//   * one std::thread per CUDA thread; the blocks of a launch one at a time;
//   * __syncthreads as a barrier of the block's threads, __shfl_xor_sync as
//     an exchange through a barrier of the warp's 32 threads;
//   * shared memory: `__shared__` arrays are static (one block runs at a
//     time), the dynamic buffer is filled with 0xff bytes (NaN floats)
//     before each block, so a read of something never written shows;
//   * cp.async: each thread's copies land only when it waits for their group
//     (the latest a card may land them), so a read before the wait, or a
//     slot refilled while another thread still reads it, shows as well;
//   * bfloat16 as 16 bits with round-to-nearest-even from float.
//
// The kernels' device-only instructions (cp.async, ex2.approx) have host
// branches in scan.cuh (#ifndef __CUDA_ARCH__) that call the hooks below.
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__ __restrict
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct uint2 {
  uint32_t x, y;
};
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline float __int_as_float(int u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline int __float_as_int(float f) {
  int u;
  memcpy(&u, &f, 4);
  return u;
}

struct __nv_bfloat16 {
  uint16_t bits;
  __nv_bfloat16() = default;
};
inline float __bfloat162float(__nv_bfloat16 v) { return __uint_as_float(uint32_t(v.bits) << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  __nv_bfloat16 r;
  r.bits = uint16_t(u >> 16);
  return r;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}

namespace emu {

struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return g != gen; });
    }
  }
};
struct Warp {
  Barrier bar;
  float slot[32];
};
extern Barrier* block_barrier;
extern std::vector<Warp>* warps;
extern unsigned char* dynamic_smem;
// `kernel<<<grid, block, smem, stream>>>(args)` becomes launch(grid, block,
// smem, stream, [&] { kernel(args); })
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, std::function<void()> f);

// cp.async: this thread's copies, grouped as committed, oldest first (the
// last group is the open one)
struct Copy {
  void* dst;
  unsigned char data[16];
};
extern thread_local std::vector<std::vector<Copy>> groups;
inline void cp_async(void* dst, const void* src) {
  if (groups.empty()) groups.emplace_back();
  Copy c;
  c.dst = dst;
  memcpy(c.data, src, 16);
  groups.back().push_back(c);
}
inline void cp_commit() {
  if (groups.empty()) groups.emplace_back();
  groups.emplace_back();
}
inline void cp_wait(int pending) {  // all committed groups but the newest `pending` land
  const int committed = groups.empty() ? 0 : int(groups.size()) - 1;
  for (int i = 0; i < committed - pending; ++i) {
    for (auto& c : groups.front()) memcpy(c.dst, c.data, 16);
    groups.erase(groups.begin());
  }
}

}  // namespace emu

inline void __syncthreads() { emu::block_barrier->wait(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const unsigned t = threadIdx.x;
  auto& w = (*emu::warps)[t / 32];
  w.slot[t % 32] = v;
  w.bar.wait();
  const float r = w.slot[(t % 32) ^ mask];
  w.bar.wait();
  return r;
}
