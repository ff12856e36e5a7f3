// Mamba (S6) selective scan, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as
// jax.lax.scan over time (src/repro/models/ssm.py:_mamba_scan, the step at
// :76-87, the scan at :103-111), which XLA compiles to one loop on the
// device.  The port ran it as a Python loop over time, several launches a
// step; this kernel loops over time inside one launch.  For h0 [B, E, N]
// float32, dt, x [B, S, E] and B, C [B, S, N] in the stream's type (float32
// or bfloat16, upcast each step) and a [E, N] float32 (a = -exp(a_log)):
//
//   h_t[b, e, n] = exp(dt[b,t,e] a[e,n]) h_{t-1}[b, e, n] + dt[b,t,e] x[b,t,e] B[b,t,n]
//   y[b, t, e]   = sum_n C[b,t,n] h_t[b, e, n]
//
// giving y [B, S, E] and h_S [B, E, N], both float32.  Time goes in the
// reference's order; only the sum over n is taken in another order.
//
// What bounds it: the bytes (each input read once, y written once) at every
// width a model uses: a step of one channel is ~7 N flops on ~3 stream
// values, far below the card's ~20 flops a byte in float32 outside the
// tensor cores.  But the steps of one channel are serial, so the card is
// filled only by B x E channels in parallel.
//
// Forward design: one thread per (row b, channel e) keeps its N state
// values in registers for the whole sequence; a block is 128 channels of
// one row.  B_t and C_t are the same for every channel of a row, so the
// block stages them in shared memory for a tile of kTile steps, and each
// thread reads its own dt and x (neighbouring threads, neighbouring
// addresses).
//
// Backward design (gy = dL/dy, gh = dL/dh_S): the same thread walks time
// backwards carrying g = dL/dh_t in registers.  It needs h_{t-1} at every
// step, in reverse: a first pass runs the recurrence forward and keeps the
// state every kChunk steps (ckpt, [B, S / kChunk, E, N]: the backward never
// holds [B, S, E, N]); then, chunk by chunk from the last, it recomputes
// the chunk's states into local memory and steps back through them.  dt,
// x, h0 and a get their gradients in the thread; dB and dC are sums over
// the channels e: each block sums its 128 channels (warp sums, then the 4
// warps in order) into part_bc [B, S, E / 128, 2N], and a second launch
// (scan.cuh's sum_middle) adds the blocks in order, as it adds da's rows
// (part_a [B, E, N]) -- no atomics, so the result is the same bits on
// every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pyentry.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 128;  // channels of one row a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // forward: steps whose B_t, C_t are staged at once
constexpr int kChunk = 32;     // backward: steps between checkpoints

template <class T, int N>
__global__ void __launch_bounds__(kThreads) mamba_fwd(
    const float* __restrict__ h0, const T* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ x, const float* __restrict__ a, int s,
    int e, float* __restrict__ y, float* __restrict__ h_last) {
  __shared__ float sb[kTile][N], sc[kTile][N];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool on = ch < e;
  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = on ? h0[((size_t)b * e + ch) * N + n] : 0.f;
    av[n] = on ? a[(size_t)ch * N + n] : 0.f;
  }
  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int nt = min(kTile, s - t0);
    __syncthreads();  // the last tile's readers are done
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const size_t at = ((size_t)b * s + t0) * N + i;
      sb[i / N][i % N] = scan::load(bm + at);
      sc[i / N][i % N] = scan::load(cm + at);
    }
    __syncthreads();
    if (!on) continue;
    for (int j = 0; j < nt; ++j) {
      const size_t at = ((size_t)b * s + t0 + j) * e + ch;
      const float d = scan::load(dt + at);
      const float dx = d * scan::load(x + at);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(d * av[n]) * h[n] + dx * sb[j][n];
        acc += h[n] * sc[j][n];
      }
      y[at] = acc;
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[((size_t)b * e + ch) * N + n] = h[n];
  }
}

template <class T, int N>
__global__ void __launch_bounds__(kThreads) mamba_bwd(
    const float* __restrict__ gy, const float* __restrict__ gh, const float* __restrict__ h0,
    const T* __restrict__ dt, const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ x, const float* __restrict__ a, int s, int e,
    float* __restrict__ dh0, T* __restrict__ ddt, T* __restrict__ dx_out,
    float* __restrict__ part_bc, float* __restrict__ part_a, float* __restrict__ ckpt) {
  __shared__ float sb[kChunk][N], sc[kChunk][N];
  __shared__ float red[kWarps][2 * N];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool on = ch < e;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nblk = gridDim.x;
  const int nchunk = (s + kChunk - 1) / kChunk;
  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = on ? a[(size_t)ch * N + n] : 0.f;
    h[n] = on ? h0[((size_t)b * e + ch) * N + n] : 0.f;
  }
  // pass 1: the state at the start of every chunk
  for (int c = 0; c < nchunk; ++c) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * N; i += kThreads)
      sb[i / N][i % N] = scan::load(bm + ((size_t)b * s + t0) * N + i);
    __syncthreads();
    if (!on) continue;
    float* dst = ckpt + (((size_t)b * nchunk + c) * e + ch) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) dst[n] = h[n];
    for (int j = 0; j < nt; ++j) {
      const size_t at = ((size_t)b * s + t0 + j) * e + ch;
      const float d = scan::load(dt + at);
      const float dxv = d * scan::load(x + at);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = expf(d * av[n]) * h[n] + dxv * sb[j][n];
    }
  }
  // pass 2: backwards, chunk by chunk
  float g[N], ga[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    g[n] = on ? gh[((size_t)b * e + ch) * N + n] : 0.f;
    ga[n] = 0.f;
  }
  float hs[kChunk][N];  // the chunk's states before each step (local memory)
  for (int c = nchunk - 1; c >= 0; --c) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const size_t at = ((size_t)b * s + t0) * N + i;
      sb[i / N][i % N] = scan::load(bm + at);
      sc[i / N][i % N] = scan::load(cm + at);
    }
    __syncthreads();
    if (on) {
      const float* src = ckpt + (((size_t)b * nchunk + c) * e + ch) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = src[n];
      for (int j = 0; j < nt; ++j) {
#pragma unroll
        for (int n = 0; n < N; ++n) hs[j][n] = h[n];
        if (j + 1 == nt) break;
        const size_t at = ((size_t)b * s + t0 + j) * e + ch;
        const float d = scan::load(dt + at);
        const float dxv = d * scan::load(x + at);
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = expf(d * av[n]) * h[n] + dxv * sb[j][n];
      }
    }
    for (int j = nt - 1; j >= 0; --j) {
      const size_t at = ((size_t)b * s + t0 + j) * e + ch;
      float d = 0.f, xv = 0.f, gyv = 0.f;
      if (on) {
        d = scan::load(dt + at);
        xv = scan::load(x + at);
        gyv = gy[at];
      }
      const float dxv = d * xv;
      float gdt = 0.f, gx = 0.f, pb[N], pc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hb = on ? hs[j][n] : 0.f;
        const float da = expf(d * av[n]);
        const float ha = da * hb + dxv * sb[j][n];
        g[n] += gyv * sc[j][n];  // dL/dh_t, whole
        pc[n] = gyv * ha;
        pb[n] = g[n] * dxv;
        gdt += g[n] * (av[n] * da * hb + xv * sb[j][n]);
        gx += g[n] * d * sb[j][n];
        ga[n] += g[n] * d * da * hb;
        g[n] *= da;  // dL/dh_{t-1}, this step's part
      }
      if (on) {
        scan::store(ddt + at, gdt);
        scan::store(dx_out + at, gx);
      }
      // dB_t and dC_t: this block's channels, warps in order
#pragma unroll
      for (int n = 0; n < N; ++n) {
        pb[n] = scan::warp_sum(pb[n]);
        pc[n] = scan::warp_sum(pc[n]);
      }
      if (lane == 0) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          red[warp][n] = pb[n];
          red[warp][N + n] = pc[n];
        }
      }
      __syncthreads();
      if (threadIdx.x < 2 * N) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[w][threadIdx.x];
        part_bc[(((size_t)b * s + t0 + j) * nblk + blockIdx.x) * 2 * N + threadIdx.x] = acc;
      }
      __syncthreads();
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh0[((size_t)b * e + ch) * N + n] = g[n];
      part_a[((size_t)b * e + ch) * N + n] = ga[n];
    }
  }
}

template <class T, int N>
cudaError_t forward(const void* h0, const void* dt, const void* bm, const void* cm,
                    const void* x, const void* a, int b, int s, int e, void* y, void* h_last,
                    cudaStream_t stream) {
  const dim3 grid((e + kThreads - 1) / kThreads, b);
  mamba_fwd<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h0), static_cast<const T*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x), static_cast<const float*>(a), s, e,
      static_cast<float*>(y), static_cast<float*>(h_last));
  return cudaGetLastError();
}

template <class T, int N>
cudaError_t backward(const void* gy, const void* gh, const void* h0, const void* dt,
                     const void* bm, const void* cm, const void* x, const void* a, int b, int s,
                     int e, void* dh0, void* ddt, void* dx, void* dbc, void* da, void* part_bc,
                     void* part_a, void* ckpt, cudaStream_t stream) {
  const dim3 grid((e + kThreads - 1) / kThreads, b);
  mamba_bwd<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(gy), static_cast<const float*>(gh),
      static_cast<const float*>(h0), static_cast<const T*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x), static_cast<const float*>(a), s, e,
      static_cast<float*>(dh0), static_cast<T*>(ddt), static_cast<T*>(dx),
      static_cast<float*>(part_bc), static_cast<float*>(part_a), static_cast<float*>(ckpt));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = scan::launch_sum_middle(static_cast<const float*>(part_bc), (long long)b * s,
                                (int)grid.x, 2LL * N, static_cast<float*>(dbc), stream);
  if (err != cudaSuccess) return err;
  return scan::launch_sum_middle(static_cast<const float*>(part_a), 1LL, b, (long long)e * N,
                                 static_cast<float*>(da), stream);
}

// N, the state size, is a template argument (the state lives in registers)
#define MAMBA_DISPATCH_N(n, ...)                     \
  switch (n) {                                       \
    case 8: { constexpr int N = 8; __VA_ARGS__; }    \
    case 16: { constexpr int N = 16; __VA_ARGS__; }  \
    default: return cudaErrorInvalidValue;           \
  }

}  // namespace

extern "C" int mamba_scan_f32(const void* h0, const void* dt, const void* bm, const void* cm,
                              const void* x, const void* a, int b, int s, int e, int n, void* y,
                              void* h_last, void* stream) {
  MAMBA_DISPATCH_N(n, return forward<float, N>(h0, dt, bm, cm, x, a, b, s, e, y, h_last,
                                               static_cast<cudaStream_t>(stream)))
}

extern "C" int mamba_scan_bf16(const void* h0, const void* dt, const void* bm, const void* cm,
                               const void* x, const void* a, int b, int s, int e, int n,
                               void* y, void* h_last, void* stream) {
  MAMBA_DISPATCH_N(n, return forward<__nv_bfloat16, N>(h0, dt, bm, cm, x, a, b, s, e, y,
                                                       h_last,
                                                       static_cast<cudaStream_t>(stream)))
}

extern "C" int mamba_scan_bwd_f32(const void* gy, const void* gh, const void* h0,
                                  const void* dt, const void* bm, const void* cm, const void* x,
                                  const void* a, int b, int s, int e, int n, void* dh0,
                                  void* ddt, void* dx, void* dbc, void* da, void* part_bc,
                                  void* part_a, void* ckpt, void* stream) {
  MAMBA_DISPATCH_N(n, return backward<float, N>(gy, gh, h0, dt, bm, cm, x, a, b, s, e, dh0, ddt,
                                                dx, dbc, da, part_bc, part_a, ckpt,
                                                static_cast<cudaStream_t>(stream)))
}

extern "C" int mamba_scan_bwd_bf16(const void* gy, const void* gh, const void* h0,
                                   const void* dt, const void* bm, const void* cm,
                                   const void* x, const void* a, int b, int s, int e, int n,
                                   void* dh0, void* ddt, void* dx, void* dbc, void* da,
                                   void* part_bc, void* part_a, void* ckpt, void* stream) {
  MAMBA_DISPATCH_N(n, return backward<__nv_bfloat16, N>(gy, gh, h0, dt, bm, cm, x, a, b, s, e,
                                                        dh0, ddt, dx, dbc, da, part_bc, part_a,
                                                        ckpt,
                                                        static_cast<cudaStream_t>(stream)))
}

PYENTRY_MODULE(mamba_scan, PYENTRY_FN(mamba_scan_f32), PYENTRY_FN(mamba_scan_bf16),
               PYENTRY_FN(mamba_scan_bwd_f32), PYENTRY_FN(mamba_scan_bwd_bf16))
