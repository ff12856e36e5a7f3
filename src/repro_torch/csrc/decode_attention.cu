// GQA decode attention (split-T flash-decoding) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_attn_kernel (decode_attention_pallas_call).  Same function: for
// q [B, H, hd], k and v [B, T, Hk, hd] (contiguous, float32 or bfloat16;
// k and v start on a 16-byte boundary, for the copies below) and
// cache_len [B] int32,
//
//   o[b, h] = sum_{t < len[b]} softmax_t(q[b, h] . k[b, t, h / rep] / sqrt(hd))
//             * v[b, t, h / rep],                     rep = H / Hk,
//
// accumulated in float32, written in q's type.  A row with len 0 gives
// zeros, as the TPU kernel's acc / max(l, 1e-30) does.  len is clamped to
// [0, T].
//
// What bounds it on this card: the bytes of the valid K/V prefix, read once
// (2 * sum_b min(len[b], T) * Hk * hd elements), plus q and o.  The
// arithmetic is 4 * H * hd flops per valid position, far below the bytes at
// the <= 16 query rows a kv-head serves, so CUDA-core FMAs suffice.  The
// kernel has to keep enough K/V bytes in flight to cover the memory's
// latency on all 132 SMs, even when B * Hk is a few dozen.
//
// What the design does about it:
//   * Split T across blocks (flash-decoding).  The grid is
//     (B * Hk, row groups, S): block (b * Hk + g, y, s) takes up to ROWS of
//     kv-head g's query rows and positions [s * chunk, (s + 1) * chunk) of
//     row b, clipped to len[b].  The wrapper picks chunk and S from the
//     shapes alone (kernels/decode_attention.py::split_plan; never from the
//     lengths, which stay on the device), so small batches still fill the
//     card.  A block whose chunk starts at or past len[b] writes an empty
//     partial (m = -inf, l = 0) and exits without reading K/V.
//   * Stage K and V through shared memory with cp.async.  Each block walks
//     its chunk in tiles of TP positions, in a ring of kStages = 2 tiles:
//     the copy of the next tile is in flight while the block computes on
//     the tile that has arrived, and the small ring lets five blocks share
//     an SM (at the serving shape), so each SM keeps many loads in flight.  A position's row of one
//     kv-head is hd * sizeof(T) contiguous bytes (a multiple of 16, since hd
//     is a multiple of 8), cut into 16-byte segments that neighbouring
//     threads copy; only positions below the chunk's end are copied.  Staged
//     rows are padded by 16 bytes so that the 16-byte reads of 8 threads
//     that own 8 positions fall in distinct banks.
//   * Scores and the weighted sum from shared memory, no per-position warp
//     reductions, two barriers a tile: each thread owns one position of the
//     tile and computes its dot products with its rows of q (scaled by
//     log2(e) / sqrt(hd), kept in shared memory as float32), and the lanes
//     of one row take the tile's maximum with one butterfly per row; then
//     each thread owns 4 elements of the head for every row and a group of
//     the tile's positions, folds the maximum into its running max, and
//     accumulates exp2(score - max) * V and the weights in float32
//     registers.  The groups' sums are added in group order at the end.
//   * Combine in a second launch on the same stream when S > 1: one block
//     per (b * Hk + g, row group) merges the S partials (m, l, acc) in split
//     order, so the result is deterministic and no float atomics are used.
//     When S == 1 the split kernel writes o itself.
//
// Entry points: decode_attention_f32 and decode_attention_bf16 (plain C;
// exported to Python by pyentry.cuh as the module decode_attention).  Up to two launches on the caller's stream, no
// allocation (the wrapper allocates the partials), no synchronisation; each
// returns the first cudaError_t it saw (0 on success).

#include "pyentry.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Two stages: the next tile's copy is in flight while the block computes on
// this one.  On the H100 a third stage cost more in blocks per SM than it
// gained in bytes in flight: the block's phases, not the copies, set its
// pace.
constexpr int kStages = 2;
constexpr int kMaxRows = 16;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSplits = 65535;
constexpr int kMaxDevices = 64;
constexpr int kSmemOptIn = 232448;  // 227 KB, the most a block may use
constexpr float kNegInf = -1e30f;   // finite: exp2f(kNegInf - m) is 0, never NaN
constexpr float kLog2e = 1.4426950408889634f;

// ---- 16-byte asynchronous copies (global -> shared, bypassing L1) ------- //

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
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

// ---- element types -------------------------------------------------------- //

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// bfloat16 <-> float32 on the raw bits: a bf16 is the top half of a float
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// 16 bytes of a staged row as floats: 4 of float32, 8 of bfloat16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  out[0] = bf16_lo(x.x); out[1] = bf16_hi(x.x);
  out[2] = bf16_lo(x.y); out[3] = bf16_hi(x.y);
  out[4] = bf16_lo(x.z); out[5] = bf16_hi(x.z);
  out[6] = bf16_lo(x.w); out[7] = bf16_hi(x.w);
}

// 4 neighbouring elements as floats, and back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(x.x), bf16_hi(x.x), bf16_lo(x.y), bf16_hi(x.y));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(x.x, x.y), bf16_pair(x.z, x.w));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Positions per tile: about 8-16 KB of K and of V a stage whatever the row.
template <typename T, int NP>
struct Tile {
  static constexpr int kRowBytesMax = 64 * NP * static_cast<int>(sizeof(T));
  static constexpr int kPos = kRowBytesMax <= 256 ? 64 : (kRowBytesMax <= 512 ? 32 : 16);
  static constexpr int kSeg = kPos < 32 ? kPos : 32;  // lanes that share a score row
  static constexpr int kGroups = 8 / NP;  // position groups of the weighted sum
};

// Dynamic shared memory of a block: the K/V ring, q, the scores and the
// segments' maxima; after the walk the ring holds the position groups'
// sums (never more than the ring).
template <typename T, int ROWS, int NP>
size_t split_smem_bytes(int hd) {
  using TL = Tile<T, NP>;
  const size_t ring = kStages * 2 * TL::kPos * (static_cast<size_t>(hd) * sizeof(T) + 16);
  const size_t sums = (static_cast<size_t>(TL::kGroups) * ROWS * (hd + 1) * 4 + 15) & ~size_t{15};
  const size_t rest =
      (static_cast<size_t>(ROWS) * hd + ROWS * TL::kPos + (kThreads / TL::kSeg) * ROWS + ROWS) * 4;
  return (ring > sums ? ring : sums) + rest;
}

// The partials, one buffer: acc [S, B*H, hd] then (m, l) [S, B*H, 2], float32.

// ROWS query rows per block, head dims up to 64 * NP.
//
// Per tile, two phases and two barriers:
//   A. scores: thread (slot, p) computes the dot products of position p with
//      query rows slot, slot + SLOTS, ...; each segment of kSeg lanes (one
//      slot) takes its maximum per row with shuffles and writes it.
//   B. weights and the weighted sum: thread (group, d) owns elements
//      d..d+3 of every row and positions group, group + GROUPS, ...; it
//      folds the tile's maximum into its running max m (the same in every
//      thread), rescales its sums, and adds exp2(score - m) * V and
//      exp2(score - m) for its positions.
// After the walk the groups' sums are added in group order.
template <typename T, int ROWS, int NP>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ cache_len,
                              int t_max, int h, int hk, int hd, int chunk, int splits,
                              float scale_log2, T* __restrict__ o,
                              float* __restrict__ part) {
  using TL = Tile<T, NP>;
  constexpr int TP = TL::kPos;
  constexpr int SEG = TL::kSeg;
  constexpr int SLOTS = kThreads / TP;  // row slots of phase A
  constexpr int SPS = TP / SEG;  // segments per slot
  constexpr int RPT = (ROWS + SLOTS - 1) / SLOTS;
  constexpr int DG = 16 * NP;  // 4-element groups of the largest head
  constexpr int GROUPS = TL::kGroups;  // position groups of phase B
  constexpr int PPT = TP / GROUPS;  // positions per thread and tile in phase B
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static_assert(DG * GROUPS == kThreads, "phase B covers the block");

  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int rse = hd + 16 / static_cast<int>(sizeof(T));  // staged row stride, elements
  const size_t ring = static_cast<size_t>(kStages) * 2 * TP * rse * sizeof(T);
  const size_t sums = (static_cast<size_t>(GROUPS) * ROWS * (hd + 1) * 4 + 15) & ~size_t{15};
  T* kv = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + (ring > sums ? ring : sums));
  float* sc = qs + ROWS * hd;
  float* seg_max = sc + ROWS * TP;  // [kThreads / SEG][ROWS]
  float* row_m = seg_max + (kThreads / SEG) * ROWS;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / hk;
  const int g = blockIdx.x - b * hk;
  const int rep = h / hk;
  const int r0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, rep - r0);
  const int split = blockIdx.z;
  const int n = max(0, min(cache_len[b], t_max));
  const int start = split * chunk;
  const int end = min(start + chunk, n);
  const size_t head0 = static_cast<size_t>(b) * h + g * rep + r0;  // first (b, h) row
  const size_t bh = static_cast<size_t>(gridDim.x) * rep;  // B * H
  const size_t pr0 = static_cast<size_t>(split) * bh + head0;  // its partial row
  float* part_acc = part;
  float* part_ml = part + static_cast<size_t>(splits) * bh * hd;

  if (start >= end) {  // nothing of this row in the chunk
    if (splits == 1) {
      for (int i = tid; i < nrows * hd; i += kThreads) o[head0 * hd + i] = T(0.f);
    } else if (tid < nrows) {
      part_ml[2 * (pr0 + tid)] = -INFINITY;
      part_ml[2 * (pr0 + tid) + 1] = 0.f;
    }
    return;
  }

  const size_t pos_stride = static_cast<size_t>(hk) * hd;
  const size_t base = (static_cast<size_t>(b) * t_max * hk + g) * hd;
  const T* kb = k + base;
  const T* vb = v + base;
  const int segs = hd / VEC;
  const int ntiles = (end - start + TP - 1) / TP;

  auto issue = [&](int tile) {
    const int t0 = start + tile * TP;
    const int cnt = min(TP, end - t0);
    T* sk = kv + static_cast<size_t>(tile % kStages) * 2 * TP * rse;
    T* sv = sk + TP * rse;
    for (int i = tid; i < cnt * segs; i += kThreads) {
      const int p = i / segs;
      const int s = i - p * segs;
      const size_t off = static_cast<size_t>(t0 + p) * pos_stride + s * VEC;
      cp_async16(sk + p * rse + s * VEC, kb + off);
      cp_async16(sv + p * rse + s * VEC, vb + off);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }
  for (int i = tid; i < nrows * hd; i += kThreads)
    qs[i] = to_float(q[head0 * hd + i]) * scale_log2;

  const int sp = tid % TP;  // phase A: this thread's position and slot
  const int sslot = tid / TP;
  const int seg = tid / SEG;
  const int d0 = 4 * (tid % DG);  // phase B: this thread's elements and group
  const int grp = tid / DG;
  const bool owns = d0 < hd;
  float m[ROWS], lsum[ROWS], acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    lsum[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + kStages - 1 < ntiles) issue(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile it have landed
    __syncthreads();               // and everyone's
    const int cnt = min(TP, end - (start + it * TP));
    const T* sk = kv + static_cast<size_t>(it % kStages) * 2 * TP * rse;
    const T* sv = sk + TP * rse;

    // A. scores in log2 units, and each segment's maximum per row
    {
      float dot[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) dot[j] = kNegInf;
      if (sp < cnt) {
        float d_even[RPT], d_odd[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) d_even[j] = d_odd[j] = 0.f;
        const T* kr = sk + sp * rse;
#pragma unroll 2
        for (int c = 0; c < hd; c += VEC) {
          float kf[VEC];
          load16(kr + c, kf);
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const int r = sslot + j * SLOTS;
            if (r < nrows) {
              const float* qr = qs + r * hd + c;
#pragma unroll
              for (int e = 0; e < VEC; e += 4) {
                const float4 x = *reinterpret_cast<const float4*>(qr + e);
                d_even[j] = fmaf(x.x, kf[e], d_even[j]);
                d_odd[j] = fmaf(x.y, kf[e + 1], d_odd[j]);
                d_even[j] = fmaf(x.z, kf[e + 2], d_even[j]);
                d_odd[j] = fmaf(x.w, kf[e + 3], d_odd[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) dot[j] = d_even[j] + d_odd[j];
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = sslot + j * SLOTS;
        float mx = dot[j];
#pragma unroll
        for (int off = SEG / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (r < nrows) {
          if (sp < cnt) sc[r * TP + sp] = dot[j];
          if (tid % SEG == 0) seg_max[seg * ROWS + r] = mx;
        }
      }
    }
    __syncthreads();

    // B. rescale by the new maximum, then add this thread's positions
    if (owns) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          float tmax = kNegInf;
#pragma unroll
          for (int i = 0; i < SPS; ++i)
            tmax = fmaxf(tmax, seg_max[((r % SLOTS) * SPS + i) * ROWS + r]);
          const float m_new = fmaxf(m[r], tmax);
          const float alpha = exp2f(m[r] - m_new);
          m[r] = m_new;
          lsum[r] *= alpha;
          acc[r][0] *= alpha; acc[r][1] *= alpha; acc[r][2] *= alpha; acc[r][3] *= alpha;
        }
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = grp + i * GROUPS;
        if (p < cnt) {
          const float4 x = load4(sv + p * rse + d0);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < nrows) {
              const float w = exp2f(sc[r * TP + p] - m[r]);
              lsum[r] += w;
              acc[r][0] = fmaf(w, x.x, acc[r][0]);
              acc[r][1] = fmaf(w, x.y, acc[r][1]);
              acc[r][2] = fmaf(w, x.z, acc[r][2]);
              acc[r][3] = fmaf(w, x.w, acc[r][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage, the scores and the maxima are free again
  }

  // add the groups' sums in group order; the ring is free
  float* gsum = reinterpret_cast<float*>(smem);  // [GROUPS][ROWS][hd]
  float* gl = gsum + GROUPS * ROWS * hd;  // [GROUPS][ROWS]
  if (owns) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        *reinterpret_cast<float4*>(gsum + (grp * ROWS + r) * hd + d0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        if (d0 == 0) gl[grp * ROWS + r] = lsum[r];
      }
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) row_m[r] = m[r];
  }
  __syncthreads();
  const int quads = hd / 4;
  for (int i = tid; i < nrows * quads; i += kThreads) {
    const int r = i / quads;
    const int d = 4 * (i - r * quads);
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(gsum + (gi * ROWS + r) * hd + d);
      s4.x += x.x; s4.y += x.y; s4.z += x.z; s4.w += x.w;
      l += gl[gi * ROWS + r];
    }
    if (splits == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      store4(o + (head0 + r) * hd + d, make_float4(s4.x * inv, s4.y * inv, s4.z * inv, s4.w * inv));
    } else {
      store4(part_acc + (pr0 + r) * hd + d, s4);
      if (d == 0) {
        part_ml[2 * (pr0 + r)] = row_m[r];
        part_ml[2 * (pr0 + r) + 1] = l;
      }
    }
  }
}

// Merge the S partials of each (b, h) row in split order:
// o = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s over the splits with
// l_s > 0, M their largest m; zeros where no split saw a position.  One warp
// per row takes M and the denominator; then each thread owns 4 elements of
// a row and walks the splits, its loads independent of each other.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine_kernel(const float* __restrict__ part, int h, int hk, int hd,
                                int rows, int splits, T* __restrict__ o) {
  __shared__ float row_m[kMaxRows];
  __shared__ float row_inv[kMaxRows];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / hk;
  const int g = blockIdx.x - b * hk;
  const int rep = h / hk;
  const int r0 = blockIdx.y * rows;
  const int nrows = min(rows, rep - r0);
  const size_t head0 = static_cast<size_t>(b) * h + g * rep + r0;
  const size_t bh = static_cast<size_t>(gridDim.x) * rep;
  const float2* part_ml = reinterpret_cast<const float2*>(part + static_cast<size_t>(splits) * bh * hd);

  for (int r = warp; r < nrows; r += kWarps) {
    float mm = -INFINITY;
    for (int s = lane; s < splits; s += 32) {
      const float2 ml = part_ml[s * bh + head0 + r];
      if (ml.y > 0.f) mm = fmaxf(mm, ml.x);
    }
    mm = warp_max(mm);
    float ll = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float2 ml = part_ml[s * bh + head0 + r];
      if (ml.y > 0.f) ll += ml.y * exp2f(ml.x - mm);
    }
    ll = warp_sum(ll);
    if (lane == 0) {
      row_m[r] = mm;
      row_inv[r] = 1.f / fmaxf(ll, 1e-30f);
    }
  }
  __syncthreads();
  const int quads = hd / 4;
  for (int i = tid; i < nrows * quads; i += kThreads) {
    const int r = i / quads;
    const int d = 4 * (i - r * quads);
    const float mm = row_m[r];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const size_t pr = s * bh + head0 + r;
      const float2 ml = part_ml[pr];
      const float4 a = load4(part + pr * hd + d);  // unwritten when l == 0: not used
      const bool used = ml.y > 0.f;
      const float w = used ? exp2f(ml.x - mm) : 0.f;
      sum.x += used ? w * a.x : 0.f;
      sum.y += used ? w * a.y : 0.f;
      sum.z += used ? w * a.z : 0.f;
      sum.w += used ? w * a.w : 0.f;
    }
    const float inv = row_inv[r];
    store4(o + (head0 + r) * hd + d,
           make_float4(sum.x * inv, sum.y * inv, sum.z * inv, sum.w * inv));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* len;
  int b, t, h, hk, hd, chunk, splits;
  float scale_log2;
  void* o;
  float* part;
  cudaStream_t stream;
};

template <typename T, int ROWS, int NP>
int launch_split(const Args& a) {
  auto kernel = decode_attention_split_kernel<T, ROWS, NP>;
  const size_t smem = split_smem_bytes<T, ROWS, NP>(a.hd);
  if (smem > 48 * 1024) {
    // opt in once per device: above 48 KB a block's dynamic shared memory
    // must be allowed explicitly
    static bool opted[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !opted[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemOptIn);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted[dev] = true;
    }
  }
  const int rep = a.h / a.hk;
  const dim3 grid(a.b * a.hk, (rep + ROWS - 1) / ROWS, a.splits);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.len, a.t, a.h, a.hk, a.hd, a.chunk, a.splits, a.scale_log2, static_cast<T*>(a.o),
      a.part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const dim3 cgrid(a.b * a.hk, (rep + ROWS - 1) / ROWS);
  decode_attention_combine_kernel<T><<<cgrid, kThreads, 0, a.stream>>>(
      a.part, a.h, a.hk, a.hd, ROWS, a.splits, static_cast<T*>(a.o));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ROWS>
int launch_rows(const Args& a) {
  if (a.hd <= 64) return launch_split<T, ROWS, 1>(a);
  if (a.hd <= 128) return launch_split<T, ROWS, 2>(a);
  return launch_split<T, ROWS, 4>(a);
}

// Rows a block serves: the kv-head's rep rounded up to a power of two, at
// most kMaxRows (kernels/decode_attention.py::rows_per_block says the same).
template <typename T>
int launch(const Args& a) {
  if (a.b < 0 || a.t < 0 || a.hk <= 0 || a.h % a.hk != 0 || a.hd % 8 != 0 || a.hd <= 0 ||
      a.hd > kMaxHeadDim || a.chunk <= 0 || a.splits <= 0 || a.splits > kMaxSplits ||
      static_cast<long long>(a.chunk) * a.splits < a.t || (a.splits > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.b == 0 || a.h == 0) return 0;
  const int rep = a.h / a.hk;
  if (rep == 1) return launch_rows<T, 1>(a);
  if (rep == 2) return launch_rows<T, 2>(a);
  if (rep <= 4) return launch_rows<T, 4>(a);
  if (rep <= 8) return launch_rows<T, 8>(a);
  return launch_rows<T, kMaxRows>(a);
}

Args make_args(const void* q, const void* k, const void* v, const int* cache_len, int b,
               int t, int h, int hk, int hd, float scale, int chunk, int splits, void* o,
               void* part, void* stream) {
  return Args{q, k, v, cache_len, b, t, h, hk, hd, chunk, splits, scale * kLog2e, o,
              static_cast<float*>(part), static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const int* cache_len, int b, int t, int h, int hk,
                                    int hd, float scale, int chunk, int splits, void* o,
                                    void* part, void* stream) {
  return launch<float>(
      make_args(q, k, v, cache_len, b, t, h, hk, hd, scale, chunk, splits, o, part, stream));
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const int* cache_len, int b, int t, int h, int hk,
                                     int hd, float scale, int chunk, int splits, void* o,
                                     void* part, void* stream) {
  return launch<__nv_bfloat16>(
      make_args(q, k, v, cache_len, b, t, h, hk, hd, scale, chunk, splits, o, part, stream));
}

PYENTRY_MODULE(decode_attention, PYENTRY_FN(decode_attention_f32),
               PYENTRY_FN(decode_attention_bf16))
