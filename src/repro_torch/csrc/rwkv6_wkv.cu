// RWKV-6 ("Finch") WKV recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as
// jax.lax.scan over time (src/repro/models/ssm.py:rwkv6_tm_apply, the step
// at :230-237, the scan at :248), which XLA compiles to one loop on the
// device.  For s0 [B, H, hd, hd] float32, r, k, v [B, S, H, hd] in the
// stream's type (float32 or bfloat16, upcast), w [B, S, H, hd] float32 (the
// decay, in (0, 1)) and u [H, hd] float32 (the bonus), per (row b, head h):
//
//   y_t[j] = sum_i r_t[i] S_{t-1}[i, j] + v_t[j] sum_i r_t[i] u[i] k_t[i]
//   S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
//
// giving y [B, S, H, hd] and S_S [B, H, hd, hd], both float32.  Time goes
// in the reference's order; only the sums over i are taken in another order.
//
// What bounds it: a step of one head is 3 hd^2 instructions (r S, k v, the
// decay's fma) on ~5 hd values: at hd = 64, 7 flops a state value against
// ~14 bytes a step, so the card's float32 rate bounds a prefill and the
// state's bytes a decode step (S = 1: the state read and written once).
// The steps of a head are serial, so B x H heads fill the card.
//
// Forward design: one block of hd^2 / 32 threads per (row, head) (4 warps
// at hd 64, 1 at hd 32), and the hd x hd state in registers as a 2-D tile:
// each thread holds 8 rows x 4 columns.  A warp's lanes are 8 row groups
// (hd / 8 at hd 32) x 4 column groups, so a warp covers every row of 16
// columns, and a step's y is the thread's 8-row partial sums reduced over
// the row groups with shuffles: a reduce-scatter (4 columns -> 2 -> 1, each
// sum taken once) and a last fold, in a fixed order.  The bonus term
// sum_i r u k is taken once a step and head, not per (i, j).  r, k, v and w
// of a tile of kFwdTile steps come into shared memory by cp.async, double
// buffered (the next tile's copies in flight while this tile's steps run),
// and are converted once into float rows padded by 4 every 32 (the 8 row
// groups' float4 reads hit distinct banks).  A decode step (S = 1) reads
// and writes the state as whole float4 rows.
//
// Backward design (gy = dL/dy, gs = dL/dS_S; G = dL/dS_t walking time
// backwards): per step and head, with S = S_{t-1},
//
//   dr[i] = sum_j gy[j] S[i, j] + u[i] k[i] (gy . v)
//   dk[i] = sum_j G[i, j] v[j] + r[i] u[i] (gy . v)
//   dw[i] = sum_j G[i, j] S[i, j]
//   dv[j] = sum_i k[i] G[i, j] + gy[j] sum_i r[i] u[i] k[i]
//   du[i] += r[i] k[i] (gy . v);   G <- w[i] G[i, j] + r[i] gy[j]
//
// One block of 4 hd threads (8 warps at hd 64) per (row, head); warp w
// holds rows 8w .. 8w + 7 and each thread 2 rows x hd / 8 columns of S and
// G.  The sums over j (dr, dk, dw) stay inside a warp: a reduce-scatter
// over the 8 column lanes (6 values -> 3) and two folds.  dv, a sum over i,
// is reduced over the warp's 4 row lanes and written per warp into shared
// memory; at the end of each chunk the warps are added in order.  gy . v
// and the bonus are taken once a step.  A first pass runs the recurrence
// forward and keeps the state every kChunk steps (ckpt, [B, H, S / kChunk,
// hd, hd]); then, chunk by chunk from the last, the chunk's states are
// recomputed into registers (unrolled over the chunk, so no local memory)
// and the steps run back through them.  Inputs and kept states come through
// a ring of kStages shared-memory slots filled by cp.async, three chunks
// ahead.  du, a sum over rows b, is written per row (part_u [B, H, hd]) and
// added up in order by a second launch (scan.cuh's sum_middle): no atomics,
// the same bits on every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pyentry.cuh"
#include "scan.cuh"

namespace {

constexpr int kFwdTile = 32;  // forward: steps staged at once (two tiles in flight)
constexpr int kChunk = 8;     // backward: steps between kept states
constexpr int kStages = 4;    // backward: chunks staged in the ring (three in flight)
constexpr int kMaxDevices = 64;

// a float row of hd values padded by 4 after every 32
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5) * 4; }

template <class T, int HD>
struct Fwd {
  static constexpr int kThreads = HD * HD / 32;  // 8 x 4 state values a thread
  static constexpr int kRG = HD / 8;             // row groups a warp (its lane bits 0..)
  static constexpr int kCG = 32 / kRG;           // column groups a warp
  static constexpr int kRow = padded(HD);        // floats a converted row
  static constexpr int kTileElems = kFwdTile * HD;
  static constexpr size_t kSlot = kTileElems * (3 * sizeof(T) + sizeof(float));
  static constexpr size_t kSmem =
      2 * kSlot + (4 * kFwdTile * kRow + kFwdTile) * sizeof(float);
};

template <class T, int HD>
__global__ void __launch_bounds__(Fwd<T, HD>::kThreads) wkv_fwd(
    const float* __restrict__ s0, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w, const float* __restrict__ u, int s,
    int nh, float* __restrict__ y, float* __restrict__ s_last) {
  using L = Fwd<T, HD>;
  constexpr int NT = L::kThreads, RG = L::kRG, ROW = L::kRow, TE = L::kTileElems;
  extern __shared__ __align__(16) unsigned char smem[];
  float* fr = reinterpret_cast<float*>(smem + 2 * L::kSlot);  // [kFwdTile][ROW] each
  float* fk = fr + kFwdTile * ROW;
  float* fw = fk + kFwdTile * ROW;
  float* fv = fw + kFwdTile * ROW;
  float* bonus = fv + kFwdTile * ROW;  // [kFwdTile]: sum_i r u k of each step

  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int rg = lane % RG, cg = lane / RG;
  const int i0 = rg * 8, c0 = wp * L::kCG * 4 + cg * 4;  // this thread's rows and columns
  const long long rs = (long long)nh * HD;                 // values between two steps
  const long long base = ((long long)b * s * nh + h) * HD;

  float st[8][4];
  const float* s0p = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int m = 0; m < 8; ++m) scan::load_vec<4>(s0p + (i0 + m) * HD + c0, st[m]);
  float ul[HD / 32];  // u at this lane's rows of the bonus sum
#pragma unroll
  for (int q = 0; q < HD / 32; ++q) ul[q] = u[(size_t)h * HD + lane + 32 * q];

  auto stage = [&](int tile, int slot) {
    const int t0 = tile * kFwdTile, nt = min(kFwdTile, s - t0);
    T* d = reinterpret_cast<T*>(smem + slot * L::kSlot);
    const long long at = base + t0 * rs;
    scan::stage_rows(d, HD, r + at, rs, HD, nt, tid, NT);
    scan::stage_rows(d + TE, HD, k + at, rs, HD, nt, tid, NT);
    scan::stage_rows(d + 2 * TE, HD, v + at, rs, HD, nt, tid, NT);
    scan::stage_rows(reinterpret_cast<float*>(d + 3 * TE), HD, w + at, rs, HD, nt, tid, NT);
  };

  const int ntile = (s + kFwdTile - 1) / kFwdTile;
  stage(0, 0);
  scan::cp_async_commit();
  for (int n = 0; n < ntile; ++n) {
    const int t0 = n * kFwdTile, nt = min(kFwdTile, s - t0);
    scan::cp_async_wait<0>();
    __syncthreads();  // tile n staged; the last tile's steps are done
    if (n + 1 < ntile) {
      stage(n + 1, (n + 1) & 1);
      scan::cp_async_commit();
    }
    const T* rr = reinterpret_cast<const T*>(smem + (n & 1) * L::kSlot);
    const T* kk = rr + TE;
    const T* vv = rr + 2 * TE;
    const float* ww = reinterpret_cast<const float*>(rr + 3 * TE);
    for (int q = tid; q < nt * HD; q += NT) {
      const int at = (q / HD) * ROW + padded(q % HD);
      fr[at] = scan::load(rr + q);
      fk[at] = scan::load(kk + q);
      fv[at] = scan::load(vv + q);
      fw[at] = ww[q];
    }
    for (int t = wp; t < nt; t += NT / 32) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < HD / 32; ++q) {
        const int i = t * HD + lane + 32 * q;
        acc = fmaf(scan::load(rr + i) * ul[q], scan::load(kk + i), acc);
      }
      acc = scan::warp_sum(acc);
      if (lane == 0) bonus[t] = acc;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      float rv[8], kv[8], wv[8], vq[4];
      scan::load_vec<8>(fr + t * ROW + padded(i0), rv);
      scan::load_vec<8>(fk + t * ROW + padded(i0), kv);
      scan::load_vec<8>(fw + t * ROW + padded(i0), wv);
      scan::load_vec<4>(fv + t * ROW + padded(c0), vq);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = fmaf(rv[m], st[m][c], p[c]);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[m][c] = fmaf(wv[m], st[m][c], kv[m] * vq[c]);
      }
      // the sums over the warp's row groups: 4 columns -> 2 -> 1, then a fold
      const bool hi1 = rg & (RG / 2), hi2 = rg & (RG / 4);
      scan::halve<4>(p, RG / 2, hi1);
      scan::halve<2>(p, RG / 4, hi2);
      if constexpr (RG == 8) scan::fold<1>(p, 1);
      const int col = c0 + (hi1 ? 2 : 0) + (hi2 ? 1 : 0);
      if (RG == 4 || (rg & 1) == 0)
        y[base + (t0 + t) * rs + col] = fmaf(fv[t * ROW + padded(col)], bonus[t], p[0]);
    }
  }
  float* sl = s_last + (size_t)bh * HD * HD;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    *reinterpret_cast<float4*>(sl + (i0 + m) * HD + c0) =
        make_float4(st[m][0], st[m][1], st[m][2], st[m][3]);
}

template <class T, int HD>
struct Bwd {
  static constexpr int kWarps = HD / 8;  // 8 rows a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kC = HD / 8;      // columns a thread (2 rows each)
  static constexpr int kChunkElems = kChunk * HD;
  // a ring slot: r, k, v (stream type), w, gy (float32), the chunk's kept state
  static constexpr size_t kSlot =
      kChunkElems * (3 * sizeof(T) + 2 * sizeof(float)) + HD * HD * sizeof(float);
  // the ring, dv per warp, the bonus per warp, dr / dk / dw rows
  static constexpr size_t kSmem =
      kStages * kSlot +
      (kChunk * kWarps * HD + kChunk * kWarps + 3 * kChunkElems) * sizeof(float);
};

template <class T, int HD>
__global__ void __launch_bounds__(Bwd<T, HD>::kThreads, 1) wkv_bwd(
    const float* __restrict__ gy, const float* __restrict__ gs, const float* __restrict__ s0,
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, int s, int nh,
    float* __restrict__ ds0, T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ part_u, float* __restrict__ ckpt) {
  using L = Bwd<T, HD>;
  constexpr int NT = L::kThreads, NW = L::kWarps, C = L::kC, CE = L::kChunkElems;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sdv = reinterpret_cast<float*>(smem + kStages * L::kSlot);  // [kChunk][NW][HD]
  float* sbonus = sdv + kChunk * NW * HD;                            // [kChunk][NW]
  float* sdr = sbonus + kChunk * NW;                                 // [kChunk][HD] each
  float* sdk = sdr + CE;
  float* sdw = sdk + CE;

  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int i0 = wp * 8 + rg * 2, c0 = cg * C;  // rows i0, i0 + 1; columns c0 .. c0 + C - 1
  const long long rs = (long long)nh * HD;
  const long long base = ((long long)b * s * nh + h) * HD;
  const int nchunk = (s + kChunk - 1) / kChunk;
  float* ck = ckpt + (size_t)bh * nchunk * HD * HD;

  // a slot's arrays
  auto slot_t = [&](int slot) { return reinterpret_cast<T*>(smem + slot * L::kSlot); };
  auto slot_f = [&](int slot) {  // w, gy, then the kept state
    return reinterpret_cast<float*>(smem + slot * L::kSlot + 3 * CE * sizeof(T));
  };
  // chunk c's inputs into its slot: k, v, w (pass 1), or everything with
  // the kept state, of which each thread copies the pieces it reads
  auto stage = [&](int c, bool all) {
    const int t0 = c * kChunk, nt = min(kChunk, s - t0), slot = c % kStages;
    const long long at = base + t0 * rs;
    T* d = slot_t(slot);
    float* f = slot_f(slot);
    scan::stage_rows(d + CE, HD, k + at, rs, HD, nt, tid, NT);
    scan::stage_rows(d + 2 * CE, HD, v + at, rs, HD, nt, tid, NT);
    scan::stage_rows(f, HD, w + at, rs, HD, nt, tid, NT);
    if (all) {
      scan::stage_rows(d, HD, r + at, rs, HD, nt, tid, NT);
      scan::stage_rows(f + CE, HD, gy + at, rs, HD, nt, tid, NT);
      float* kept = f + 2 * CE;
      const float* src = ck + (size_t)c * HD * HD;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int q = 0; q < C; q += 4) {
          const int at2 = (i0 + a) * HD + c0 + q;
          scan::cp_async16(kept + at2, src + at2);
        }
      }
    }
  };

  // pass 1: the state at the start of every chunk
  float st[2][C];
#pragma unroll
  for (int a = 0; a < 2; ++a)
    scan::load_vec<C>(s0 + ((size_t)bh * HD + i0 + a) * HD + c0, st[a]);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunk) stage(c, false);
    scan::cp_async_commit();
  }
  for (int c = 0; c < nchunk; ++c) {
    scan::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c staged; chunk c - 1's steps are done
    if (c + kStages - 1 < nchunk) stage(c + kStages - 1, false);
    scan::cp_async_commit();
    float* dst = ck + (size_t)c * HD * HD;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int q = 0; q < C; q += 4)
        *reinterpret_cast<float4*>(dst + (i0 + a) * HD + c0 + q) =
            make_float4(st[a][q], st[a][q + 1], st[a][q + 2], st[a][q + 3]);
    }
    const int nt = min(kChunk, s - c * kChunk);
    const T* d = slot_t(c % kStages);
    const float* f = slot_f(c % kStages);
    for (int j = 0; j < nt; ++j) {
      float kv[2], wv[2], vv[C];
      scan::load_vec<2>(d + CE + j * HD + i0, kv);
      scan::load_vec<C>(d + 2 * CE + j * HD + c0, vv);
      scan::load_vec<2>(f + j * HD + i0, wv);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int q = 0; q < C; ++q) st[a][q] = fmaf(wv[a], st[a][q], kv[a] * vv[q]);
      }
    }
  }
  scan::cp_async_wait<0>();
  __syncthreads();  // pass 1 is done with the ring

  // pass 2: backwards, chunk by chunk
  float g[2][C];
#pragma unroll
  for (int a = 0; a < 2; ++a)
    scan::load_vec<C>(gs + ((size_t)bh * HD + i0 + a) * HD + c0, g[a]);
  const bool writer = (cg & 3) == 0;  // holds the row sums of row i0 + (cg >> 2)
  const int wrow = i0 + (cg >> 2);
  const float uw = u[(size_t)h * HD + wrow];
  float ur[2] = {u[(size_t)h * HD + i0], u[(size_t)h * HD + i0 + 1]};
  float du = 0.f;
  for (int m = 0; m < kStages - 1; ++m) {
    if (nchunk - 1 - m >= 0) stage(nchunk - 1 - m, true);
    scan::cp_async_commit();
  }
  for (int c = nchunk - 1; c >= 0; --c) {
    scan::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c staged; chunk c + 1 written out
    if (c - (kStages - 1) >= 0) stage(c - (kStages - 1), true);
    scan::cp_async_commit();
    const int t0 = c * kChunk, nt = min(kChunk, s - t0);
    const T* d = slot_t(c % kStages);
    const float* f = slot_f(c % kStages);
    // the chunk's states S_{t0 - 1 + j} before each step j, in registers
    float hs[kChunk][2][C];
#pragma unroll
    for (int a = 0; a < 2; ++a) scan::load_vec<C>(f + 2 * CE + (i0 + a) * HD + c0, hs[0][a]);
#pragma unroll
    for (int j = 1; j < kChunk; ++j) {
      if (j < nt) {
        float kv[2], wv[2], vv[C];
        scan::load_vec<2>(d + CE + (j - 1) * HD + i0, kv);
        scan::load_vec<C>(d + 2 * CE + (j - 1) * HD + c0, vv);
        scan::load_vec<2>(f + (j - 1) * HD + i0, wv);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int q = 0; q < C; ++q) hs[j][a][q] = fmaf(wv[a], hs[j - 1][a][q], kv[a] * vv[q]);
        }
      }
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < nt) {
        float rv[2], kv[2], wv[2], vv[C], gv[C];
        scan::load_vec<2>(d + j * HD + i0, rv);
        scan::load_vec<2>(d + CE + j * HD + i0, kv);
        scan::load_vec<C>(d + 2 * CE + j * HD + c0, vv);
        scan::load_vec<2>(f + j * HD + i0, wv);
        scan::load_vec<C>(f + CE + j * HD + c0, gv);
        float rows[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dr, dk, dw of row i0, then i0 + 1
        float col[C];                                    // dv over this thread's 2 rows
        float gyv = 0.f;                                 // gy . v, this thread's columns
#pragma unroll
        for (int q = 0; q < C; ++q) {
          col[q] = 0.f;
          gyv = fmaf(gv[q], vv[q], gyv);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const float sp = hs[j][a][q], gg = g[a][q];
            rows[3 * a] = fmaf(gv[q], sp, rows[3 * a]);
            rows[3 * a + 1] = fmaf(gg, vv[q], rows[3 * a + 1]);
            rows[3 * a + 2] = fmaf(gg, sp, rows[3 * a + 2]);
            col[q] = fmaf(kv[a], gg, col[q]);
            g[a][q] = fmaf(wv[a], gg, rv[a] * gv[q]);
          }
        }
        // gy . v over the column lanes; the bonus over the warp's rows
        float one[2] = {gyv, fmaf(rv[0] * ur[0], kv[0], rv[1] * ur[1] * kv[1])};
        scan::fold<1>(one, 4), scan::fold<1>(one, 2), scan::fold<1>(one, 1);
        scan::fold<1>(one + 1, 8), scan::fold<1>(one + 1, 16);
        gyv = one[0];
        // the row sums over the 8 column lanes: 6 -> 3, then two folds
        scan::halve<6>(rows, 4, cg & 4);
        scan::fold<3>(rows, 2);
        scan::fold<3>(rows, 1);
        if (writer) {
          const int a = cg >> 2;
          const float ra = rv[a], ka = kv[a];
          sdr[j * HD + wrow] = fmaf(uw * ka, gyv, rows[0]);
          sdk[j * HD + wrow] = fmaf(ra * uw, gyv, rows[1]);
          sdw[j * HD + wrow] = rows[2];
          du = fmaf(ra * ka, gyv, du);
        }
        // dv over the 4 row lanes: C -> C / 4 columns a lane
        scan::halve<C>(col, 16, rg & 2);
        scan::halve<C / 2>(col, 8, rg & 1);
        const int cc = c0 + ((rg & 2) ? C / 2 : 0) + ((rg & 1) ? C / 4 : 0);
        float* dvp = sdv + (j * NW + wp) * HD + cc;
        if constexpr (C / 4 == 2) {
          *reinterpret_cast<float2*>(dvp) = make_float2(col[0], col[1]);
        } else {
          dvp[0] = col[0];
        }
        if (lane == 0) sbonus[j * NW + wp] = one[1];
      }
    }
    __syncthreads();  // the chunk's partial sums are in shared memory
    for (int q = tid; q < nt * HD; q += NT) {
      const int j = q / HD, col = q % HD;
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) {
        acc += sdv[(j * NW + ww) * HD + col];
        bonus += sbonus[j * NW + ww];
      }
      const long long at = base + (t0 + j) * rs + col;
      scan::store(dv + at, fmaf(f[CE + q], bonus, acc));
      scan::store(dr + at, sdr[q]);
      scan::store(dk + at, sdk[q]);
      dw[at] = sdw[q];
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int q = 0; q < C; q += 4)
      *reinterpret_cast<float4*>(ds0 + ((size_t)bh * HD + i0 + a) * HD + c0 + q) =
          make_float4(g[a][q], g[a][q + 1], g[a][q + 2], g[a][q + 3]);
  }
  if (writer) part_u[(size_t)bh * HD + wrow] = du;
}

template <class T, int HD>
cudaError_t forward(const void* s0, const void* r, const void* k, const void* v,
                    const void* w, const void* u, int b, int s, int nh, void* y, void* s_last,
                    cudaStream_t stream) {
  if (b * nh == 0) return cudaSuccess;
  using L = Fwd<T, HD>;
  static bool opted[kMaxDevices];
  const cudaError_t err = scan::allow_smem(wkv_fwd<T, HD>, L::kSmem, opted, kMaxDevices);
  if (err != cudaSuccess) return err;
  wkv_fwd<T, HD><<<b * nh, L::kThreads, L::kSmem, stream>>>(
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
  using L = Bwd<T, HD>;
  static bool opted[kMaxDevices];
  cudaError_t err = scan::allow_smem(wkv_bwd<T, HD>, L::kSmem, opted, kMaxDevices);
  if (err != cudaSuccess) return err;
  wkv_bwd<T, HD><<<b * nh, L::kThreads, L::kSmem, stream>>>(
      static_cast<const float*>(gy), static_cast<const float*>(gs),
      static_cast<const float*>(s0), static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w), static_cast<const float*>(u), s,
      nh, static_cast<float*>(ds0), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dw), static_cast<float*>(part_u),
      static_cast<float*>(ckpt));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return scan::launch_sum_middle(static_cast<const float*>(part_u), 1LL, b,
                                 (long long)nh * HD, static_cast<float*>(du), stream);
}

// hd, the head size, is a template argument (the state lives in registers)
#define WKV_DISPATCH_HD(hd, ...)                       \
  switch (hd) {                                        \
    case 32: { constexpr int HD = 32; __VA_ARGS__; }   \
    case 64: { constexpr int HD = 64; __VA_ARGS__; }   \
    default: return cudaErrorInvalidValue;             \
  }

template <class T>
int smem_of(int hd, int backward) {
  if (hd == 32) return static_cast<int>(backward ? Bwd<T, 32>::kSmem : Fwd<T, 32>::kSmem);
  if (hd == 64) return static_cast<int>(backward ? Bwd<T, 64>::kSmem : Fwd<T, 64>::kSmem);
  return -1;
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

// The dynamic shared memory one block takes (for the launch plan's check):
// the forward (backward 0) or backward kernel at head size hd, for a stream
// of `bytes`-byte values (4 float32, 2 bfloat16); -1 for a size not built.
extern "C" int rwkv6_wkv_smem(int hd, int bytes, int backward) {
  if (bytes == 4) return smem_of<float>(hd, backward);
  if (bytes == 2) return smem_of<__nv_bfloat16>(hd, backward);
  return -1;
}

PYENTRY_MODULE(rwkv6_wkv, PYENTRY_FN(rwkv6_wkv_f32), PYENTRY_FN(rwkv6_wkv_bf16),
               PYENTRY_FN(rwkv6_wkv_bwd_f32), PYENTRY_FN(rwkv6_wkv_bwd_bf16),
               PYENTRY_FN(rwkv6_wkv_smem))
