// RWKV-6 ("Finch") WKV recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as
// jax.lax.scan over time (src/repro/models/ssm.py:rwkv6_tm_apply, the step
// at :230-237, the scan at :248), which XLA compiles to one loop on the
// device.  The port ran it as a Python loop over time, several launches a
// step; this kernel loops over time inside one launch.  For s0 [B, H, hd,
// hd] float32, r, k, v [B, S, H, hd] in the stream's type (float32 or
// bfloat16, upcast), w [B, S, H, hd] float32 (the decay, in (0, 1)) and u
// [H, hd] float32 (the bonus), per (row b, head h):
//
//   y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//   S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
//
// giving y [B, S, H, hd] and S_S [B, H, hd, hd], both float32.  Time goes
// in the reference's order; only the sum over i is taken in another order.
//
// What bounds it: a step of one head is ~7 hd^2 flops on ~5 hd values: at
// hd = 64, ~22 flops a byte, about the card's float32 rate outside the
// tensor cores over its memory rate, so operations and bytes bound it
// together.  The steps are serial, so B x H heads fill the card, a block
// each.
//
// Forward design: one block per (row, head), one thread per value column j,
// which keeps column j of the hd x hd state in registers for the whole
// sequence.  r_t, k_t and w_t are read by every thread, so the block stages
// them in shared memory for a tile of kTile steps; each thread reads its
// own v_t[j].
//
// Backward design (gy = dL/dy, gs = dL/dS_S): one block per (row, head),
// one thread per state ROW i, which carries row i of G = dL/dS_t in
// registers, walking time backwards.  With rows, dr, dk, dw and du are the
// thread's own sums over j; only dv_t[j] = sum_i k_t[i] (G[i, j] + gy_t[j]
// r_t[i] u[i]) is a sum over threads, taken in shared memory in the order
// i = 0, 1, ... .  S_{t-1} is needed at every step, in reverse: a first
// pass runs the recurrence forward and keeps the state every kChunk steps
// (ckpt, [B, H, S / kChunk, hd, hd]); then, chunk by chunk from the last,
// the chunk's states are recomputed into local memory.  du, a sum over rows
// b, is written per row (part_u [B, H, hd]) and added up in order by a
// second launch (scan.cuh's sum_middle): no atomics, the same bits on every
// call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pyentry.cuh"
#include "scan.cuh"

namespace {

constexpr int kTile = 32;   // forward: steps whose r, k, w are staged at once
constexpr int kChunk = 16;  // backward: steps between checkpoints

template <class T, int HD>
__global__ void __launch_bounds__(HD) wkv_fwd(
    const float* __restrict__ s0, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w, const float* __restrict__ u, int s,
    int nh, float* __restrict__ y, float* __restrict__ s_last) {
  __shared__ float sr[kTile][HD], sk[kTile][HD], sw[kTile][HD];
  __shared__ float su[HD];
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int j = threadIdx.x;
  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = s0[((size_t)bh * HD + i) * HD + j];
  su[j] = u[(size_t)h * HD + j];
  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int nt = min(kTile, s - t0);
    __syncthreads();
    for (int q = j; q < nt * HD; q += HD) {
      const size_t at = (((size_t)b * s + t0 + q / HD) * nh + h) * HD + q % HD;
      sr[q / HD][q % HD] = scan::load(r + at);
      sk[q / HD][q % HD] = scan::load(k + at);
      sw[q / HD][q % HD] = w[at];
    }
    __syncthreads();
    for (int jj = 0; jj < nt; ++jj) {
      const size_t at = (((size_t)b * s + t0 + jj) * nh + h) * HD + j;
      const float vj = scan::load(v + at);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = sk[jj][i] * vj;
        acc += sr[jj][i] * (st[i] + su[i] * kv);
        st[i] = sw[jj][i] * st[i] + kv;
      }
      y[at] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_last[((size_t)bh * HD + i) * HD + j] = st[i];
}

template <class T, int HD>
__global__ void __launch_bounds__(HD) wkv_bwd(
    const float* __restrict__ gy, const float* __restrict__ gs, const float* __restrict__ s0,
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, int s, int nh,
    float* __restrict__ ds0, T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ part_u, float* __restrict__ ckpt) {
  __shared__ float sv[kChunk][HD], sg[kChunk][HD];
  __shared__ float red[HD][HD + 1];
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int i = threadIdx.x;  // this thread's state row
  const int nchunk = (s + kChunk - 1) / kChunk;
  const float ui = u[(size_t)h * HD + i];
  float st[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) st[j] = s0[((size_t)bh * HD + i) * HD + j];
  // pass 1: the state at the start of every chunk
  for (int c = 0; c < nchunk; ++c) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0);
    __syncthreads();
    for (int q = i; q < nt * HD; q += HD)
      sv[q / HD][q % HD] = scan::load(v + (((size_t)b * s + t0 + q / HD) * nh + h) * HD + q % HD);
    __syncthreads();
    float* dst = ckpt + (((size_t)bh * nchunk + c) * HD + i) * HD;
#pragma unroll
    for (int j = 0; j < HD; ++j) dst[j] = st[j];
    for (int jj = 0; jj < nt; ++jj) {
      const size_t at = (((size_t)b * s + t0 + jj) * nh + h) * HD + i;
      const float ki = scan::load(k + at), wi = w[at];
#pragma unroll
      for (int j = 0; j < HD; ++j) st[j] = wi * st[j] + ki * sv[jj][j];
    }
  }
  // pass 2: backwards, chunk by chunk
  float g[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) g[j] = gs[((size_t)bh * HD + i) * HD + j];
  float du = 0.f;
  float hs[kChunk][HD];  // the chunk's state rows before each step (local memory)
  for (int c = nchunk - 1; c >= 0; --c) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0);
    __syncthreads();
    for (int q = i; q < nt * HD; q += HD) {
      const size_t at = (((size_t)b * s + t0 + q / HD) * nh + h) * HD + q % HD;
      sv[q / HD][q % HD] = scan::load(v + at);
      sg[q / HD][q % HD] = gy[at];
    }
    __syncthreads();
    const float* src = ckpt + (((size_t)bh * nchunk + c) * HD + i) * HD;
#pragma unroll
    for (int j = 0; j < HD; ++j) st[j] = src[j];
    for (int jj = 0; jj < nt; ++jj) {
#pragma unroll
      for (int j = 0; j < HD; ++j) hs[jj][j] = st[j];
      if (jj + 1 == nt) break;
      const size_t at = (((size_t)b * s + t0 + jj) * nh + h) * HD + i;
      const float ki = scan::load(k + at), wi = w[at];
#pragma unroll
      for (int j = 0; j < HD; ++j) st[j] = wi * st[j] + ki * sv[jj][j];
    }
    for (int jj = nt - 1; jj >= 0; --jj) {
      const size_t at = (((size_t)b * s + t0 + jj) * nh + h) * HD + i;
      const float ri = scan::load(r + at), ki = scan::load(k + at), wi = w[at];
      float gv = 0.f;  // sum_j gy_t[j] v_t[j], the same in every thread
#pragma unroll
      for (int j = 0; j < HD; ++j) gv += sg[jj][j] * sv[jj][j];
      float gr = 0.f, gk = 0.f, gw = 0.f;
      const float rui = ri * ui;
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        const float sp = hs[jj][j];
        gr += sg[jj][j] * sp;
        gk += g[j] * sv[jj][j];
        gw += g[j] * sp;
        red[i][j] = ki * (g[j] + sg[jj][j] * rui);
        g[j] = g[j] * wi + sg[jj][j] * ri;  // dL/dS_{t-1}
      }
      scan::store(dr + at, gr + ui * ki * gv);
      scan::store(dk + at, rui * gv + gk);
      dw[at] = gw;
      du += ri * ki * gv;
      __syncthreads();
      float acc = 0.f;  // dv_t[j] for j = this thread's index, rows in order
#pragma unroll 8
      for (int q = 0; q < HD; ++q) acc += red[q][i];
      scan::store(dv + (((size_t)b * s + t0 + jj) * nh + h) * HD + i, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < HD; ++j) ds0[((size_t)bh * HD + i) * HD + j] = g[j];
  part_u[(size_t)bh * HD + i] = du;
}

template <class T, int HD>
cudaError_t forward(const void* s0, const void* r, const void* k, const void* v,
                    const void* w, const void* u, int b, int s, int nh, void* y, void* s_last,
                    cudaStream_t stream) {
  if (b * nh == 0) return cudaSuccess;
  wkv_fwd<T, HD><<<b * nh, HD, 0, stream>>>(
      static_cast<const float*>(s0), static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w), static_cast<const float*>(u), s,
      nh, static_cast<float*>(y), static_cast<float*>(s_last));
  return cudaGetLastError();
}

template <class T, int HD>
cudaError_t backward(const void* gy, const void* gs, const void* s0, const void* r,
                     const void* k, const void* v, const void* w, const void* u, int b, int s,
                     int nh, void* ds0, void* dr, void* dk, void* dv, void* dw, void* du,
                     void* part_u, void* ckpt, cudaStream_t stream) {
  if (b * nh == 0) return cudaSuccess;
  wkv_bwd<T, HD><<<b * nh, HD, 0, stream>>>(
      static_cast<const float*>(gy), static_cast<const float*>(gs),
      static_cast<const float*>(s0), static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w), static_cast<const float*>(u), s,
      nh, static_cast<float*>(ds0), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dw), static_cast<float*>(part_u),
      static_cast<float*>(ckpt));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return scan::launch_sum_middle(static_cast<const float*>(part_u), 1LL, b,
                                 (long long)nh * HD, static_cast<float*>(du), stream);
}

// hd, the head size, is a template argument (a state column lives in registers)
#define WKV_DISPATCH_HD(hd, ...)                       \
  switch (hd) {                                        \
    case 32: { constexpr int HD = 32; __VA_ARGS__; }   \
    case 64: { constexpr int HD = 64; __VA_ARGS__; }   \
    default: return cudaErrorInvalidValue;             \
  }

}  // namespace

extern "C" int rwkv6_wkv_f32(const void* s0, const void* r, const void* k, const void* v,
                             const void* w, const void* u, int b, int s, int nh, int hd,
                             void* y, void* s_last, void* stream) {
  WKV_DISPATCH_HD(hd, return forward<float, HD>(s0, r, k, v, w, u, b, s, nh, y, s_last,
                                                static_cast<cudaStream_t>(stream)))
}

extern "C" int rwkv6_wkv_bf16(const void* s0, const void* r, const void* k, const void* v,
                              const void* w, const void* u, int b, int s, int nh, int hd,
                              void* y, void* s_last, void* stream) {
  WKV_DISPATCH_HD(hd, return forward<__nv_bfloat16, HD>(s0, r, k, v, w, u, b, s, nh, y, s_last,
                                                        static_cast<cudaStream_t>(stream)))
}

extern "C" int rwkv6_wkv_bwd_f32(const void* gy, const void* gs, const void* s0, const void* r,
                                 const void* k, const void* v, const void* w, const void* u,
                                 int b, int s, int nh, int hd, void* ds0, void* dr, void* dk,
                                 void* dv, void* dw, void* du, void* part_u, void* ckpt,
                                 void* stream) {
  WKV_DISPATCH_HD(hd, return backward<float, HD>(gy, gs, s0, r, k, v, w, u, b, s, nh, ds0, dr,
                                                 dk, dv, dw, du, part_u, ckpt,
                                                 static_cast<cudaStream_t>(stream)))
}

extern "C" int rwkv6_wkv_bwd_bf16(const void* gy, const void* gs, const void* s0,
                                  const void* r, const void* k, const void* v, const void* w,
                                  const void* u, int b, int s, int nh, int hd, void* ds0,
                                  void* dr, void* dk, void* dv, void* dw, void* du,
                                  void* part_u, void* ckpt, void* stream) {
  WKV_DISPATCH_HD(hd, return backward<__nv_bfloat16, HD>(gy, gs, s0, r, k, v, w, u, b, s, nh,
                                                         ds0, dr, dk, dv, dw, du, part_u, ckpt,
                                                         static_cast<cudaStream_t>(stream)))
}

PYENTRY_MODULE(rwkv6_wkv, PYENTRY_FN(rwkv6_wkv_f32), PYENTRY_FN(rwkv6_wkv_bf16),
               PYENTRY_FN(rwkv6_wkv_bwd_f32), PYENTRY_FN(rwkv6_wkv_bwd_bf16))
