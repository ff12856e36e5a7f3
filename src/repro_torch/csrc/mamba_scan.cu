// Mamba (S6) selective scan, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as
// jax.lax.scan over time (src/repro/models/ssm.py:_mamba_scan, the step at
// :76-87, the scan at :103-111), which XLA compiles to one loop on the
// device.  For h0 [B, E, N] float32, dt, x [B, S, E] and B, C [B, S, N] in
// the stream's type (float32 or bfloat16, upcast each step) and a [E, N]
// float32 (a = -exp(a_log)):
//
//   h_t[b, e, n] = exp(dt[b,t,e] a[e,n]) h_{t-1}[b, e, n] + dt[b,t,e] x[b,t,e] B[b,t,n]
//   y[b, t, e]   = sum_n C[b,t,n] h_t[b, e, n]
//
// giving y [B, S, E] and h_S [B, E, N], both float32.  Time goes in the
// reference's order; only the sum over n is taken in another order.
//
// What bounds it: a step of one channel is N exponentials and ~4 N flops on
// ~3 stream values: 2.1 G exponentials in an 8 x 1,024 prefill at E 16,384,
// N 16, which the special-function unit (16 a clock and SM) takes in
// 0.45-0.51 ms, above the bytes' 0.33 ms.  The steps of one channel are
// serial, so the card is filled only by B x E channels in parallel, and
// each step's loads must be in flight long before the step.
//
// Forward design: one thread per (row b, channel e) keeps its N state
// values in registers for the whole sequence; a block is 128 channels of
// one row.  Each exponential is one ex2.approx of dt * (a log2 e), a scaled
// once per call.  dt, x, B and C come through a ring of kFwdStages tiles of
// kFwdTile steps in shared memory, filled by cp.async two tiles ahead
// (neighbouring threads, neighbouring addresses: 16-byte copies); B_t and
// C_t, the same for every channel of a row, are converted to floats once a
// tile.  The state is read and written as float4s (a decode step, S = 1,
// is little else).
//
// Backward design (gy = dL/dy, gh = dL/dh_S; g = dL/dh_t walking time
// backwards).  Four threads share a channel, a quarter of its N states
// each, so the chunk's states and exponentials fit in registers: a block is
// 64 channels of one row.  A first pass runs the recurrence forward and
// keeps the state every kChunk steps (ckpt, [B, S / kChunk, E, N]); then,
// chunk by chunk from the last, the chunk's states h_{t-1} and its
// exponentials are recomputed once into registers (unrolled over the
// chunk), and the steps run back through them: each exponential is taken
// twice in all (the first pass, the chunk), never in the step back.  Each
// staged chunk is converted once for the block (dt, dt x, B, C as floats,
// 0 past E), so the four threads of a channel share that work.  h0 and a
// get their gradients in the lane; dt and x from the four quarters' partial
// sums, kept per step in shared memory and added in order as the chunk is
// written out.  dB_t and dC_t are sums over the channels e: a warp's 8
// channels are summed by a reduce-scatter over its lanes (2 N / 4 values ->
// 1 a lane, each sum taken once), the block's 8 warps are added in order
// once a chunk from shared memory into part_bc [B, S, E / 64, 2N], and a
// second launch (scan.cuh's sum_middle) adds the blocks in order, as it
// adds da's rows (part_a [B, E, N]) -- no atomics, so the result is the
// same bits on every call.  Inputs come through a ring of kStages
// shared-memory slots filled by cp.async, three chunks ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pyentry.cuh"
#include "scan.cuh"

namespace {

constexpr int kFwdThreads = 128;  // forward: channels of one row a block
constexpr int kFwdTile = 16;      // forward: steps staged at once
constexpr int kFwdStages = 3;     // forward: tiles in the ring (two in flight)
constexpr int kBwdThreads = 256;  // backward: 4 threads a channel
constexpr int kBwdChannels = kBwdThreads / 4;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunk = 8;         // backward: steps between kept states
constexpr int kStages = 4;        // backward: chunks staged in the ring (three in flight)
constexpr int kMaxDevices = 64;

template <class T, int N>
struct Fwd {
  static constexpr int kTileCh = kFwdTile * kFwdThreads;
  // a ring slot: dt, x [kFwdTile][128], then B, C [kFwdTile][N], stream type
  static constexpr size_t kSlot = (2 * kTileCh + 2 * kFwdTile * N) * sizeof(T);
  // the ring, then a tile's B, C as floats
  static constexpr size_t kSmem = kFwdStages * kSlot + kFwdTile * 2 * N * sizeof(float);
};

template <class T, int N>
__global__ void __launch_bounds__(kFwdThreads) mamba_fwd(
    const float* __restrict__ h0, const T* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ x, const float* __restrict__ a, int s,
    int e, float* __restrict__ y, float* __restrict__ h_last) {
  using L = Fwd<T, N>;
  constexpr int TC = L::kTileCh;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sbc = reinterpret_cast<float*>(smem + kFwdStages * L::kSlot);  // [kFwdTile][2N]
  const int b = blockIdx.y, tid = threadIdx.x;
  const int e0 = blockIdx.x * kFwdThreads, ch = e0 + tid;
  const int ne = min(kFwdThreads, e - e0);
  const bool on = ch < e;
  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    if (on) {
      scan::load_vec<4>(h0 + ((size_t)b * e + ch) * N + n, h + n);
      scan::load_vec<4>(a + (size_t)ch * N + n, a2 + n);
    } else {
      h[n] = h[n + 1] = h[n + 2] = h[n + 3] = 0.f;
      a2[n] = a2[n + 1] = a2[n + 2] = a2[n + 3] = 0.f;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] *= scan::kLog2e;

  auto stage = [&](int tile) {
    const int t0 = tile * kFwdTile, nt = min(kFwdTile, s - t0);
    T* d = reinterpret_cast<T*>(smem + (tile % kFwdStages) * L::kSlot);
    const size_t at = ((size_t)b * s + t0) * e + e0, bt = ((size_t)b * s + t0) * N;
    scan::stage_rows(d, kFwdThreads, dt + at, e, ne, nt, tid, kFwdThreads);
    scan::stage_rows(d + TC, kFwdThreads, x + at, e, ne, nt, tid, kFwdThreads);
    scan::stage_rows(d + 2 * TC, N, bm + bt, N, N, nt, tid, kFwdThreads);
    scan::stage_rows(d + 2 * TC + kFwdTile * N, N, cm + bt, N, N, nt, tid, kFwdThreads);
  };

  const int ntile = (s + kFwdTile - 1) / kFwdTile;
  for (int tile = 0; tile < kFwdStages - 1; ++tile) {
    if (tile < ntile) stage(tile);
    scan::cp_async_commit();
  }
  for (int tile = 0; tile < ntile; ++tile) {
    const int t0 = tile * kFwdTile, nt = min(kFwdTile, s - t0);
    scan::cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // tile staged; the last tile's steps are done
    if (tile + kFwdStages - 1 < ntile) stage(tile + kFwdStages - 1);
    scan::cp_async_commit();
    const T* d = reinterpret_cast<const T*>(smem + (tile % kFwdStages) * L::kSlot);
    for (int q = tid; q < nt * 2 * N; q += kFwdThreads) {  // B_t, C_t as floats
      const int j = q / (2 * N), n = q % (2 * N);
      sbc[q] = scan::load(d + 2 * TC + (n < N ? j * N + n : kFwdTile * N + j * N + n - N));
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < nt; ++j) {
      const float dv = on ? scan::load(d + j * kFwdThreads + tid) : 0.f;
      const float dxv = on ? dv * scan::load(d + TC + j * kFwdThreads + tid) : 0.f;
      float bv[N], cv[N];
      scan::load_vec<N>(sbc + j * 2 * N, bv);
      scan::load_vec<N>(sbc + j * 2 * N + N, cv);
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(scan::ex2(dv * a2[n]), h[n], dxv * bv[n]);
        acc[n & 1] = fmaf(cv[n], h[n], acc[n & 1]);
      }
      if (on) y[((size_t)b * s + t0 + j) * e + ch] = acc[0] + acc[1];
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; n += 4)
      *reinterpret_cast<float4*>(h_last + ((size_t)b * e + ch) * N + n) =
          make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <class T, int N>
struct Bwd {
  static constexpr int kQ = N / 4;  // states a thread
  static constexpr int kChunkCh = kChunk * kBwdChannels;
  // a ring slot: dt, x (stream type), B, C (stream type), gy (float32)
  static constexpr size_t kSlotBytes =
      (2 * kChunkCh + 2 * kChunk * N) * sizeof(T) + kChunkCh * sizeof(float);
  static constexpr size_t kSlot = (kSlotBytes + 15) / 16 * 16;
  // the ring; then floats: the chunk's dt, dt x, B and C; dB / dC per warp
  // and step; the per-quarter sums of ddt and dx per channel and step
  static constexpr size_t kSmem =
      kStages * kSlot +
      (2 * kChunkCh + kChunk * 2 * N + kChunk * kBwdWarps * 2 * N + 8 * kChunkCh) *
          sizeof(float);
};

template <class T, int N>
__global__ void __launch_bounds__(kBwdThreads, 2) mamba_bwd(
    const float* __restrict__ gy, const float* __restrict__ gh, const float* __restrict__ h0,
    const T* __restrict__ dt, const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ x, const float* __restrict__ a, int s, int e,
    float* __restrict__ dh0, T* __restrict__ ddt, T* __restrict__ dx_out,
    float* __restrict__ part_bc, float* __restrict__ part_a, float* __restrict__ ckpt) {
  using L = Bwd<T, N>;
  constexpr int Q = L::kQ, CC = L::kChunkCh, NV = 2 * Q;  // NV: dB, dC values a thread
  constexpr int P = kBwdChannels;
  extern __shared__ __align__(16) unsigned char smem[];
  float* fd = reinterpret_cast<float*>(smem + kStages * L::kSlot);  // [kChunk][P]: dt
  float* fdx = fd + CC;                                             // dt x
  float* fbc = fdx + CC;                                            // [kChunk][2N]: B, C
  float* sred = fbc + kChunk * 2 * N;                               // [kChunk][warps][2N]
  float2* sums = reinterpret_cast<float2*>(sred + kChunk * kBwdWarps * 2 * N);  // [kChunk][P][4]

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int qt = lane & 3;                 // this thread's quarter of the states
  const int cl = wp * 8 + (lane >> 2);     // its channel in the block
  const int e0 = blk * kBwdChannels, ch = e0 + cl;
  const int ne = min(kBwdChannels, e - e0);  // the block's channels
  const bool on = ch < e;
  const int nchunk = (s + kChunk - 1) / kChunk;
  const int n0 = qt * Q;                   // states n0 .. n0 + Q - 1

  // a slot's arrays: dt, x, B, C in the stream type, then gy
  auto sdt = [&](int slot) { return reinterpret_cast<T*>(smem + slot * L::kSlot); };
  auto sgy = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * L::kSlot +
                                    (2 * CC + 2 * kChunk * N) * sizeof(T));
  };
  auto stage = [&](int c, bool all) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0);
    T* d = sdt(c % kStages);
    const size_t at = ((size_t)b * s + t0) * e + e0;
    scan::stage_rows(d, P, dt + at, e, ne, nt, tid, kBwdThreads);
    scan::stage_rows(d + CC, P, x + at, e, ne, nt, tid, kBwdThreads);
    const size_t bt = ((size_t)b * s + t0) * N;
    scan::stage_rows(d + 2 * CC, N, bm + bt, N, N, nt, tid, kBwdThreads);
    if (all) {
      scan::stage_rows(d + 2 * CC + kChunk * N, N, cm + bt, N, N, nt, tid, kBwdThreads);
      scan::stage_rows(sgy(c % kStages), P, gy + at, e, ne, nt, tid, kBwdThreads);
    }
  };
  // a staged chunk as floats, once for the block: dt and dt x (0 past E), B, C
  auto convert = [&](int slot, int nt, bool all) {
    const T* d = sdt(slot);
    for (int q = tid; q < nt * P; q += kBwdThreads) {
      const bool in = q % P < ne;
      const float dv = in ? scan::load(d + q) : 0.f;
      fd[q] = dv;
      fdx[q] = in ? dv * scan::load(d + CC + q) : 0.f;
    }
    for (int q = tid; q < nt * 2 * N; q += kBwdThreads) {
      const int j = q / (2 * N), n = q % (2 * N);
      if (all || n < N)
        fbc[q] = scan::load(d + 2 * CC + (n < N ? j * N + n : (kChunk + j) * N + n - N));
    }
  };

  float a2[Q], av[Q], h[Q];
#pragma unroll
  for (int n = 0; n < Q; ++n) {
    av[n] = on ? a[(size_t)ch * N + n0 + n] : 0.f;
    a2[n] = av[n] * scan::kLog2e;
    h[n] = on ? h0[((size_t)b * e + ch) * N + n0 + n] : 0.f;
  }
  float* ck = ckpt + (size_t)b * nchunk * e * N;

  // pass 1: the state at the start of every chunk
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunk) stage(c, false);
    scan::cp_async_commit();
  }
  for (int c = 0; c < nchunk; ++c) {
    const int nt = min(kChunk, s - c * kChunk);
    scan::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c staged; chunk c - 1's steps are done
    if (c + kStages - 1 < nchunk) stage(c + kStages - 1, false);
    scan::cp_async_commit();
    convert(c % kStages, nt, false);
    __syncthreads();
    if (on) scan::store_vec<Q>(ck + ((size_t)c * e + ch) * N + n0, h);
    for (int j = 0; j < nt; ++j) {
      const float d = fd[j * P + cl], dxv = fdx[j * P + cl];
      float bv[Q];
      scan::load_vec<Q>(fbc + j * 2 * N + n0, bv);
#pragma unroll
      for (int n = 0; n < Q; ++n) h[n] = fmaf(scan::ex2(d * a2[n]), h[n], dxv * bv[n]);
    }
  }
  scan::cp_async_wait<0>();
  __syncthreads();  // pass 1 is done with the ring

  // pass 2: backwards, chunk by chunk
  float g[Q], ga[Q];
#pragma unroll
  for (int n = 0; n < Q; ++n) {
    g[n] = on ? gh[((size_t)b * e + ch) * N + n0 + n] : 0.f;
    ga[n] = 0.f;
  }
  for (int m = 0; m < kStages - 1; ++m) {
    if (nchunk - 1 - m >= 0) stage(nchunk - 1 - m, true);
    scan::cp_async_commit();
  }
  float kept[Q] = {};  // the next chunk's kept state, loaded a chunk ahead
  if (on) scan::load_vec<Q>(ck + ((size_t)(nchunk - 1) * e + ch) * N + n0, kept);
  for (int c = nchunk - 1; c >= 0; --c) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0), slot = c % kStages;
    scan::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c staged; chunk c + 1 written out
    if (c - (kStages - 1) >= 0) stage(c - (kStages - 1), true);
    scan::cp_async_commit();
    convert(slot, nt, true);
    __syncthreads();
    const float* gp = sgy(slot);
    // the chunk's states before each step and its exponentials, in registers
    float hb[kChunk][Q], da[kChunk][Q];
#pragma unroll
    for (int n = 0; n < Q; ++n) hb[0][n] = kept[n];
    if (on && c > 0) scan::load_vec<Q>(ck + ((size_t)(c - 1) * e + ch) * N + n0, kept);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < nt) {
        const float d = fd[j * P + cl], dxv = fdx[j * P + cl];
        float bv[Q];
        scan::load_vec<Q>(fbc + j * 2 * N + n0, bv);
#pragma unroll
        for (int n = 0; n < Q; ++n) {
          da[j][n] = scan::ex2(d * a2[n]);
          if (j + 1 < kChunk) hb[j + 1][n] = fmaf(da[j][n], hb[j][n], dxv * bv[n]);
        }
      }
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < nt) {
        const float d = fd[j * P + cl], dxv = fdx[j * P + cl];
        const float gyv = on ? gp[j * P + cl] : 0.f;
        float bv[Q], cv[Q];
        scan::load_vec<Q>(fbc + j * 2 * N + n0, bv);
        scan::load_vec<Q>(fbc + j * 2 * N + N + n0, cv);
        float v[NV];                 // dB terms of this thread's states, then dC terms
        float2 part = {0.f, 0.f};    // sum_n a q, sum_n g B over this thread's states
#pragma unroll
        for (int n = 0; n < Q; ++n) {
          g[n] = fmaf(gyv, cv[n], g[n]);  // dL/dh_t, whole
          const float ht = fmaf(da[j][n], hb[j][n], dxv * bv[n]);
          v[n] = g[n] * dxv;
          v[Q + n] = gyv * ht;
          part.y = fmaf(g[n], bv[n], part.y);
          const float gda = g[n] * da[j][n];
          const float qv = gda * hb[j][n];
          ga[n] = fmaf(d, qv, ga[n]);
          part.x = fmaf(av[n], qv, part.x);
          g[n] = gda;  // dL/dh_{t-1}, this step's part
        }
        sums[(j * P + cl) * 4 + qt] = part;
        // dB_t, dC_t over the warp's 8 channels: NV values -> 1 a lane
        const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;
        int vi;  // which of this thread's NV values the lane holds
        if constexpr (NV == 8) {
          scan::halve<8>(v, 16, hi4);
          scan::halve<4>(v, 8, hi3);
          scan::halve<2>(v, 4, hi2);
          vi = (hi4 ? 4 : 0) + (hi3 ? 2 : 0) + (hi2 ? 1 : 0);
        } else {
          scan::halve<4>(v, 16, hi4);
          scan::halve<2>(v, 8, hi3);
          scan::fold<1>(v, 4);
          vi = (hi4 ? 2 : 0) + (hi3 ? 1 : 0);
        }
        if (NV == 8 || !hi2) {
          const int kind = vi / Q, n = n0 + vi % Q;  // kind 0: dB, 1: dC
          sred[(j * kBwdWarps + wp) * 2 * N + kind * N + n] = v[0];
        }
      }
    }
    __syncthreads();  // the chunk's partial sums are in shared memory
    for (int q = tid; q < nt * 2 * N; q += kBwdThreads) {
      const int j = q / (2 * N), i = q % (2 * N);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) acc += sred[(j * kBwdWarps + w) * 2 * N + i];
      part_bc[(((size_t)b * s + t0 + j) * nblk + blk) * 2 * N + i] = acc;
    }
    const T* xs = sdt(slot) + CC;
    for (int q = tid; q < nt * P; q += kBwdThreads) {
      if (q % P < ne) {
        // the four quarters in order: ddt = sum a q + x sum g B, dx = dt sum g B
        float2 t = sums[q * 4];
#pragma unroll
        for (int k = 1; k < 4; ++k) t.x += sums[q * 4 + k].x, t.y += sums[q * 4 + k].y;
        const size_t at = ((size_t)b * s + t0 + q / P) * e + e0 + q % P;
        scan::store(ddt + at, fmaf(scan::load(xs + q), t.y, t.x));
        scan::store(dx_out + at, fd[q] * t.y);
      }
    }
  }
  if (on) {
    scan::store_vec<Q>(dh0 + ((size_t)b * e + ch) * N + n0, g);
    scan::store_vec<Q>(part_a + ((size_t)b * e + ch) * N + n0, ga);
  }
}

template <class T, int N>
cudaError_t forward(const void* h0, const void* dt, const void* bm, const void* cm,
                    const void* x, const void* a, int b, int s, int e, void* y, void* h_last,
                    cudaStream_t stream) {
  using L = Fwd<T, N>;
  static bool opted[kMaxDevices];
  const cudaError_t err = scan::allow_smem(mamba_fwd<T, N>, L::kSmem, opted, kMaxDevices);
  if (err != cudaSuccess) return err;
  const dim3 grid((e + kFwdThreads - 1) / kFwdThreads, b);
  mamba_fwd<T, N><<<grid, kFwdThreads, L::kSmem, stream>>>(
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
  using L = Bwd<T, N>;
  static bool opted[kMaxDevices];
  cudaError_t err = scan::allow_smem(mamba_bwd<T, N>, L::kSmem, opted, kMaxDevices);
  if (err != cudaSuccess) return err;
  const dim3 grid((e + kBwdChannels - 1) / kBwdChannels, b);
  mamba_bwd<T, N><<<grid, kBwdThreads, L::kSmem, stream>>>(
      static_cast<const float*>(gy), static_cast<const float*>(gh),
      static_cast<const float*>(h0), static_cast<const T*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x), static_cast<const float*>(a), s, e,
      static_cast<float*>(dh0), static_cast<T*>(ddt), static_cast<T*>(dx),
      static_cast<float*>(part_bc), static_cast<float*>(part_a), static_cast<float*>(ckpt));
  err = cudaGetLastError();
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

template <class T>
int smem_of(int n, int backward) {
  if (n == 8) return static_cast<int>(backward ? Bwd<T, 8>::kSmem : Fwd<T, 8>::kSmem);
  if (n == 16) return static_cast<int>(backward ? Bwd<T, 16>::kSmem : Fwd<T, 16>::kSmem);
  return -1;
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

// The dynamic shared memory one block takes (for the launch plan's check):
// the forward (backward 0) or backward kernel at state size n, for a stream
// of `bytes`-byte values (4 float32, 2 bfloat16); -1 for a size not built.
extern "C" int mamba_scan_smem(int n, int bytes, int backward) {
  if (bytes == 4) return smem_of<float>(n, backward);
  if (bytes == 2) return smem_of<__nv_bfloat16>(n, backward);
  return -1;
}

PYENTRY_MODULE(mamba_scan, PYENTRY_FN(mamba_scan_f32), PYENTRY_FN(mamba_scan_bf16),
               PYENTRY_FN(mamba_scan_bwd_f32), PYENTRY_FN(mamba_scan_bwd_bf16),
               PYENTRY_FN(mamba_scan_smem))
