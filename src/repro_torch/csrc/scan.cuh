// What the two time-recurrence kernels (mamba_scan.cu, rwkv6_wkv.cu) share:
// loads and stores in the stream's type, the warp sum, and the second pass
// that sums their per-block partial gradients in a fixed order.
//
// The backward kernels never add floats across blocks with atomics (their
// order would change from run to run): each block writes its partial sums,
// and sum_middle adds them up in index order, so two backward calls on the
// same inputs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The sum over a warp's 32 lanes, the same bits in every lane (each level
// adds the same two values on both sides: a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

}  // namespace scan
