// What the two time-recurrence kernels (mamba_scan.cu, rwkv6_wkv.cu) share:
// loads and stores in the stream's type, staging through shared memory with
// 16-byte asynchronous copies, the sums across a warp's lanes, the base-2
// exponential on the special-function unit, and the second pass that sums their per-block partial
// gradients in a fixed order.
//
// The backward kernels never add floats across blocks with atomics (their
// order would change from run to run): each block writes its partial sums,
// and sum_middle adds them up in index order, so two backward calls on the
// same inputs give the same bits.  Every sum inside a block is a fixed tree
// of shuffles and shared-memory reads, so a forward call gives the same
// bits on the same inputs too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace scan {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// N consecutive values (N = 2, 4 or 8) from p, aligned to their size, as
// floats: one vector load.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x, out[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x, out[i + 1] = q.y, out[i + 2] = q.z, out[i + 3] = q.w;
    }
  }
}

// N consecutive floats (N = 2 or 4) to p, aligned to their size: one store.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// bfloat16 is the high half of a float: a shift or a mask per value
__device__ __forceinline__ void bf16x2(uint32_t u, float* out) {
  out[0] = __uint_as_float(u << 16);
  out[1] = __uint_as_float(u & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 2) {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), out);
  } else if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    bf16x2(q.x, out), bf16x2(q.y, out + 2);
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    bf16x2(q.x, out), bf16x2(q.y, out + 2), bf16x2(q.z, out + 4), bf16x2(q.w, out + 6);
  }
}

// ---- 16-byte asynchronous copies (global -> shared, bypassing L1) ------- //

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
#else
  memcpy(smem, gmem, 16);
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// this thread's copies, all but the N most recently committed groups, have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Stages nrows rows of count values each, row r at src + r * stride, into
// dst + r * pitch (pitch * sizeof(T) a multiple of 16), spread over the
// block's nthreads: 16-byte asynchronous copies when every row starts
// 16-byte aligned and holds whole 16-byte pieces, else plain loads and
// stores (a ragged edge).
template <class T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src, long long stride,
                                           int count, int nrows, int tid, int nthreads) {
  const int bytes = count * static_cast<int>(sizeof(T));
  const bool vec = bytes % 16 == 0 && (stride * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int per = bytes / 16;
    for (int q = tid; q < nrows * per; q += nthreads) {
      const int row = q / per, piece = q - row * per;
      cp_async16(reinterpret_cast<char*>(dst + row * pitch) + piece * 16,
                 reinterpret_cast<const char*>(src + row * stride) + piece * 16);
    }
  } else {
    for (int q = tid; q < nrows * count; q += nthreads) {
      const int row = q / count, col = q - row * count;
      dst[row * pitch + col] = src[row * stride + col];
    }
  }
}

// ---- sums across lanes -------------------------------------------------- //

// The sum over a warp's 32 lanes, the same bits in every lane (each level
// adds the same two values on both sides: a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One level of a reduce-scatter: v[0..N) of this lane and of the lane that
// differs in lane bit m become v[0..N/2), the sums of the upper half where
// this lane has bit m set (hi), else of the lower half.  Each sum is taken
// once, by one lane of the pair.
template <int N>
__device__ __forceinline__ void halve(float* v, int m, bool hi) {
#pragma unroll
  for (int p = 0; p < N / 2; ++p) {
    const float send = hi ? v[p] : v[p + N / 2];
    const float keep = hi ? v[p + N / 2] : v[p];
    v[p] = keep + __shfl_xor_sync(kFull, send, m);
  }
}

// v[0..N) summed with the lane that differs in lane bit m (both keep it).
template <int N>
__device__ __forceinline__ void fold(float* v, int m) {
#pragma unroll
  for (int p = 0; p < N; ++p) v[p] += __shfl_xor_sync(kFull, v[p], m);
}

// ---- 2^x ----------------------------------------------------------------- //

// On the special-function unit (16 results a clock and SM); below 2^-126
// it gives 0.
__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  const float y = exp2f(x);
  return y < 1.1754944e-38f ? 0.f : y;
#endif
}

// ---- the fixed-order sum across blocks ------------------------------------ //

// out[p, q] = sum over i = 0, 1, ..., m - 1 of in[p, i, q], in that order.
template <class T>
__global__ void sum_middle(const float* __restrict__ in, long long p, int m, long long q,
                           T* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= p * q) return;
  const long long row = i / q, col = i % q;
  const float* src = in + row * m * q + col;
  float acc = 0.f;
  for (int j = 0; j < m; ++j) acc += src[j * q];
  store(out + i, acc);
}

template <class T>
cudaError_t launch_sum_middle(const float* in, long long p, int m, long long q, T* out,
                              cudaStream_t stream) {
  if (p * q == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (p * q + threads - 1) / threads;
  sum_middle<T><<<(unsigned)blocks, threads, 0, stream>>>(in, p, m, q, out);
  return cudaGetLastError();
}

// Allows a kernel more than 48 KB of dynamic shared memory, once per device
// and kernel (the caller keeps the flags: one static array per kernel).
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* opted, int n_devices) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < n_devices && opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < n_devices) opted[dev] = true;
  return err;
}

}  // namespace scan
