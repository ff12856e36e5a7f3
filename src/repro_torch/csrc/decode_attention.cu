// GQA decode attention (flash-decode) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// _decode_attn_kernel (decode_attention_pallas_call).  Same function: for
// q [B, H, hd], k and v [B, T, Hk, hd] (contiguous, float32 or bfloat16) and
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
// rep <= 8 rows per group.
//
// What the design does about it: the simple, right version.  The TPU kernel
// walked a sequential grid over T with m / l / acc in VMEM scratch and also
// stepped through the fully masked blocks.  Here one block of kWarps warps
// owns one (b, kv-head) pair and up to ROWS of its rep query rows (a second
// block along y takes rows 8.. when rep > 8), so each K/V row is read once
// per group.  Warp w takes positions w*U .. w*U+U-1, then kWarps*U further,
// and stops at len[b]: no masked row is read.  Inside a warp each lane holds
// two neighbouring elements of every 64-wide slice of the head (one 4-byte
// load of a bf16 pair, 8 bytes of a float pair), the dot products end in a
// butterfly of shuffles, and each warp runs its own online softmax (m, l
// and acc in registers, scores in log2 units so exp2f does the exponent).
// The warps' partial results are merged at the end through shared memory,
// in warp order, so the result does not depend on scheduling.
//
// Known weaknesses, for later work: B * Hk blocks underfill the 132 SMs at
// small batch (24 blocks for SmolLM-135M at 8 requests); splitting T across
// blocks with a combine pass (flash-decoding) fixes that.  No tensor cores:
// rep <= 8 rows per group is far below wgmma's 64.
//
// Entry points: decode_attention_f32 and decode_attention_bf16 (plain C,
// loaded with ctypes).  One launch on the caller's stream, no allocation,
// no synchronisation; each returns the cudaError_t of the launch (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 8;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Two neighbouring elements of a row as floats, and back.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ROWS query rows per block, NP 64-wide slices of the head, U positions per
// warp step.
template <typename T, int ROWS, int NP, int U>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cache_len,
                        int t_max, int h, int hk, int hd, float scale_log2,
                        T* __restrict__ o) {
  __shared__ float part_m[kWarps][ROWS];
  __shared__ float part_l[kWarps][ROWS];
  __shared__ float row_m[ROWS];
  __shared__ float row_l[ROWS];
  __shared__ float acc_s[ROWS][kMaxHeadDim];

  const int b = blockIdx.x / hk;
  const int g = blockIdx.x % hk;
  const int rep = h / hk;
  const int r0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, rep - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = max(0, min(cache_len[b], t_max));

  // this lane's elements: d = 64 * p + 2 * lane, +1
  float qr[ROWS][NP][2];
  const T* qb = q + (static_cast<size_t>(b) * h + g * rep + r0) * hd;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int d = 64 * p + 2 * lane;
      float2 x = make_float2(0.f, 0.f);
      if (r < nrows && d < hd) x = load_pair(qb + r * hd + d);
      qr[r][p][0] = x.x * scale_log2;
      qr[r][p][1] = x.y * scale_log2;
    }
  }

  float m[ROWS], l[ROWS], acc[ROWS][NP][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[r][p][0] = acc[r][p][1] = 0.f;
  }

  const size_t pos_stride = static_cast<size_t>(hk) * hd;
  const size_t base = (static_cast<size_t>(b) * t_max * hk + g) * hd;
  for (int t0 = warp * U; t0 < n; t0 += kWarps * U) {
    float kx[U][NP][2], vx[U][NP][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int d = 64 * p + 2 * lane;
        float2 kk = make_float2(0.f, 0.f), vv = make_float2(0.f, 0.f);
        if (t0 + u < n && d < hd) {
          const size_t off = base + (t0 + u) * pos_stride + d;
          kk = load_pair(k + off);
          vv = load_pair(v + off);
        }
        kx[u][p][0] = kk.x;
        kx[u][p][1] = kk.y;
        vx[u][p][0] = vv.x;
        vx[u][p][1] = vv.y;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s[U];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          dot += qr[r][p][0] * kx[u][p][0] + qr[r][p][1] * kx[u][p][1];
        s[u] = warp_sum(dot);
        if (t0 + u < n) mx = fmaxf(mx, s[u]);
      }
      const float alpha = exp2f(m[r] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = (t0 + u < n) ? exp2f(s[u] - mx) : 0.f;
        psum += s[u];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float a0 = acc[r][p][0] * alpha, a1 = acc[r][p][1] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          a0 += s[u] * vx[u][p][0];
          a1 += s[u] * vx[u][p][1];
        }
        acc[r][p][0] = a0;
        acc[r][p][1] = a1;
      }
      m[r] = mx;
    }
  }

  // merge the warps: row max and normaliser, then the scaled sums in warp order
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      part_m[warp][r] = m[r];
      part_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, part_m[w][r]);
    float ll = 0.f;
    for (int w = 0; w < kWarps; ++w) ll += part_l[w][r] * exp2f(part_m[w][r] - mm);
    row_m[r] = mm;
    row_l[r] = ll;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float f = exp2f(m[r] - row_m[r]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int d = 64 * p + 2 * lane;
          if (d < hd) {
            const float a0 = acc[r][p][0] * f, a1 = acc[r][p][1] * f;
            acc_s[r][d] = w == 0 ? a0 : acc_s[r][d] + a0;
            acc_s[r][d + 1] = w == 0 ? a1 : acc_s[r][d + 1] + a1;
          }
        }
      }
    }
    __syncthreads();
  }
  T* ob = o + (static_cast<size_t>(b) * h + g * rep + r0) * hd;
  const int half = hd / 2;
  for (int i = threadIdx.x; i < nrows * half; i += kThreads) {
    const int r = i / half;
    const int d = 2 * (i - r * half);
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    store_pair(ob + r * hd + d, acc_s[r][d] * inv, acc_s[r][d + 1] * inv);
  }
}

template <typename T, int ROWS, int NP>
void launch_np(const T* q, const T* k, const T* v, const int* len, int b, int t,
               int h, int hk, int hd, float scale_log2, T* o, cudaStream_t stream) {
  constexpr int U = 4 / NP;
  const int rep = h / hk;
  const dim3 grid(b * hk, (rep + ROWS - 1) / ROWS);
  decode_attention_kernel<T, ROWS, NP, U><<<grid, kThreads, 0, stream>>>(
      q, k, v, len, t, h, hk, hd, scale_log2, o);
}

template <typename T, int ROWS>
void launch_rows(const T* q, const T* k, const T* v, const int* len, int b, int t,
                 int h, int hk, int hd, float scale_log2, T* o, cudaStream_t stream) {
  if (hd <= 64)
    launch_np<T, ROWS, 1>(q, k, v, len, b, t, h, hk, hd, scale_log2, o, stream);
  else if (hd <= 128)
    launch_np<T, ROWS, 2>(q, k, v, len, b, t, h, hk, hd, scale_log2, o, stream);
  else
    launch_np<T, ROWS, 4>(q, k, v, len, b, t, h, hk, hd, scale_log2, o, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* len, int b,
           int t, int h, int hk, int hd, float scale, void* o, void* stream) {
  if (b < 0 || t < 0 || hk <= 0 || h % hk != 0 || hd % 8 != 0 || hd <= 0 ||
      hd > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return 0;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  const int rep = h / hk;
  if (rep == 1)
    launch_rows<T, 1>(qq, kk, vv, len, b, t, h, hk, hd, scale_log2, oo, s);
  else if (rep == 2)
    launch_rows<T, 2>(qq, kk, vv, len, b, t, h, hk, hd, scale_log2, oo, s);
  else if (rep <= 4)
    launch_rows<T, 4>(qq, kk, vv, len, b, t, h, hk, hd, scale_log2, oo, s);
  else
    launch_rows<T, kMaxRows>(qq, kk, vv, len, b, t, h, hk, hd, scale_log2, oo, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const int* cache_len, int b, int t, int h,
                                    int hk, int hd, float scale, void* o,
                                    void* stream) {
  return launch<float>(q, k, v, cache_len, b, t, h, hk, hd, scale, o, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const int* cache_len, int b, int t, int h,
                                     int hk, int hd, float scale, void* o,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_len, b, t, h, hk, hd, scale, o,
                               stream);
}
