// K2: fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel uniter_tpu/ops/attention.py `_mha_bwd_kernel`
// (launched by `_mha_pallas_bwd_raw`, the backward of the custom VJP
// `_mha_pallas`). For one (b, h), with s = q.k^T * sm_scale + bias,
// P = softmax(s) and the dropout mask M of the forward (same seed, same
// Philox bits, philox.cuh), P_d = M * P / (1 - rate):
//
//     dV  = P_d^T g
//     dPm = M * (g V^T) / (1 - rate)
//     Di  = rowsum(dPm * P)                    (= rowsum(g * out))
//     dS  = P * (dPm - Di) * sm_scale
//     dQ  = dS K,   dK = dS^T Q
//
// q, k, v, g are read in their [B, S, H, D] layout through strides; dq, dk,
// dv are written contiguous [B, S, H, D] in the inputs' dtype (fp32 or
// bf16; all arithmetic is fp32). Only q, k, v, bias and the seed are saved
// by the forward, as in the JAX package, so P is recomputed here.
//
// Design: the FlashAttention-2 split into two passes, both SIMT (tensor
// cores, wgmma and TMA are later work), 256 threads per block as 16 x 16,
// each thread owning a 4 x 4 tile of a 64 x 64 score block fed by 16-byte
// shared-memory loads, as in K1 (mha_fwd.cu):
//   * pass A, one block per (64-query tile, h, b): walks the keys twice.
//     The first walk recomputes the row statistics (max m, sum l of every
//     exp, dropped or not) and Di with an online rescale, and stores them
//     to a [3, B, H, S] fp32 scratch; the second recomputes P and dPm and
//     accumulates dQ = dS K.
//   * pass B, one block per (64-key tile, h, b): walks the queries once,
//     recomputes the transposed scores with the stored statistics, and
//     accumulates dV = P_d^T g and dK = dS^T Q.
// S <= 512 keeps every recompute cheap. Scores are summed over d in the same
// order in both passes, so they are bit-identical between them.
//
// Numerics follow K1: padded keys (-10000) take part in the softmax, keys
// and queries past S are absent (weight 0, nothing stored), expf not
// __expf; the normaliser l sums undropped probabilities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int BT = 64;          // queries or keys per tile
constexpr int LD = BT + 4;      // pitch of transposed tiles [D][LD] and [BT][LD]
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int MAX_CG = 2;       // groups of 4 output columns per thread (D <= 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// rows r0.. of x[b, :, h, :] into dst, transposed ([D][LD], row r at column
// r) and, when rows_out is given, also as rows ([BT][D]); rows past S are 0.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, long long ss,
                                          int r0, int S, int D, float* tr,
                                          float* rows_out) {
  for (int idx = threadIdx.x; idx < BT * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const float val = r0 + r < S ? to_f32(x[(r0 + r) * ss + d]) : 0.f;
    tr[d * LD + r] = val;
    if (rows_out) rows_out[r * D + d] = val;
  }
}

// s[i][j] += a[d][4*ty+i] * c[d][4*tx+j] over d, for two pairs at once
__device__ __forceinline__ void dot2(const float* a1, const float* c1,
                                     const float* a2, const float* c2, int D,
                                     int ty, int tx, float s1[4][4],
                                     float s2[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s1[i][j] = s2[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(a1 + d * LD + 4 * ty);
    const float4 c = *reinterpret_cast<const float4*>(c1 + d * LD + 4 * tx);
    const float4 e = *reinterpret_cast<const float4*>(a2 + d * LD + 4 * ty);
    const float4 f = *reinterpret_cast<const float4*>(c2 + d * LD + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
    const float ev[4] = {e.x, e.y, e.z, e.w}, fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s1[i][j] = fmaf(av[i], cv[j], s1[i][j]);
        s2[i][j] = fmaf(ev[i], fv[j], s2[i][j]);
      }
  }
}

// acc[i][cols 4*tx + 64*g ..] += sum_r pt[r][4*ty+i] * rows[r][cols], r < n
__device__ __forceinline__ void accumulate(const float* pt, const float* rows,
                                           int n, int D, int ty, int tx,
                                           float acc[4][4 * MAX_CG]) {
  for (int r = 0; r < n; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(pt + r * LD + 4 * ty);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int g = 0; g < MAX_CG; ++g) {
      const int col = 4 * tx + 64 * g;
      if (col < D) {
        const float4 w = *reinterpret_cast<const float4*>(rows + r * D + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pv[i], w.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv[i], w.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], w.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], w.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float acc[4][4 * MAX_CG],
                                           int b, int h, int r0, int S, int H,
                                           int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= S) continue;
    T* o = out + ((static_cast<long long>(b) * S + r) * H + h) * D;
#pragma unroll
    for (int g = 0; g < MAX_CG; ++g) {
      const int col = 4 * tx + 64 * g;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(o + col + e, acc[i][4 * g + e]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float* bias;
  void *dq, *dk, *dv;
  float* stats;  // [3][B][H][S]: row max, row sum, Di
  int B, S, H, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  float sm_scale, inv_keep;
  unsigned thr;
  unsigned long long seed;
};

// Pass A: row statistics, Di and dQ for one 64-query tile.
template <typename T>
__global__ void __launch_bounds__(THREADS) mha_bwd_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, S = a.S;
  float* qt = reinterpret_cast<float*>(smem4);  // [D][LD] queries
  float* gt = qt + D * LD;                      // [D][LD] output grads
  float* kt = gt + D * LD;                      // [D][LD] keys
  float* vt = kt + D * LD;                      // [D][LD] values
  float* ks = vt + D * LD;                      // [BT][D] keys as rows
  float* pt = ks + BT * D;                      // [BT][LD] dS, transposed

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* gb = static_cast<const T*>(a.g) + b * a.g_sb + h * a.g_sh;
  const float* biasb = a.bias + static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const long long row0 = bh * S + q0 + 4 * ty;  // score row of query 4*ty

  load_tile(qb, a.q_ss, q0, S, D, qt, static_cast<float*>(nullptr));
  load_tile(gb, a.g_ss, q0, S, D, gt, static_cast<float*>(nullptr));

  float m[4], l[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    dd[i] = 0.f;
  }
  float s[4][4], dp[4][4];

  // first walk: m, l and sum_k exp(s - m) * dPm, rescaled online
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();
    load_tile(kb, a.k_ss, k0, S, D, kt, static_cast<float*>(nullptr));
    load_tile(vb, a.v_ss, k0, S, D, vt, static_cast<float*>(nullptr));
    __syncthreads();
    dot2(qt, kt, gt, vt, D, ty, tx, s, dp);
    bool live[4];
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      live[j] = k0 + 4 * tx + j < S;
      bj[j] = live[j] ? biasb[k0 + 4 * tx + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (a.thr) w = uniter::mask_words(a.seed, row0 + i, (k0 >> 2) + tx);
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? s[i][j] * a.sm_scale + bj[j] : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
        if (a.thr) dp[i][j] = uniter::word(w, j) >= a.thr ? dp[i][j] * a.inv_keep : 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float ls = 0.f, lsd = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mn);
        ls += e;
        lsd += e * dp[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
        lsd += __shfl_xor_sync(0xffffffffu, lsd, off);
      }
      l[i] = l[i] * alpha + ls;
      dd[i] = dd[i] * alpha + lsd;
      m[i] = mn;
    }
  }
  float di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    di[i] = dd[i] / l[i];
    const int qi = q0 + 4 * ty + i;
    if (tx == 0 && qi < S) {
      const long long plane = static_cast<long long>(a.B) * a.H * S;
      a.stats[bh * S + qi] = m[i];
      a.stats[plane + bh * S + qi] = l[i];
      a.stats[2 * plane + bh * S + qi] = di[i];
    }
  }

  // second walk: dS and dQ = dS K
  float acc[4][4 * MAX_CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * MAX_CG; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();
    load_tile(kb, a.k_ss, k0, S, D, kt, ks);
    load_tile(vb, a.v_ss, k0, S, D, vt, static_cast<float*>(nullptr));
    __syncthreads();
    dot2(qt, kt, gt, vt, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (a.thr) w = uniter::mask_words(a.seed, row0 + i, (k0 >> 2) + tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        const float p = kj < S ? expf(s[i][j] * a.sm_scale + biasb[kj] - m[i]) / l[i] : 0.f;
        float dpm = dp[i][j];
        if (a.thr) dpm = uniter::word(w, j) >= a.thr ? dpm * a.inv_keep : 0.f;
        s[i][j] = p * (dpm - di[i]) * a.sm_scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LD + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    accumulate(pt, ks, min(BT, S - k0), D, ty, tx, acc);
  }
  store_rows(static_cast<T*>(a.dq), acc, b, h, q0, S, a.H, D, ty, tx);
}

// Pass B: dK and dV for one 64-key tile, with the statistics of pass A.
// Score tiles are transposed here: rows are keys (4*ty+i), columns queries.
template <typename T>
__global__ void __launch_bounds__(THREADS) mha_bwd_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, S = a.S;
  float* kt = reinterpret_cast<float*>(smem4);  // [D][LD] keys
  float* vt = kt + D * LD;                      // [D][LD] values
  float* qt = vt + D * LD;                      // [D][LD] queries
  float* gt = qt + D * LD;                      // [D][LD] output grads
  float* qs = gt + D * LD;                      // [BT][D] queries as rows
  float* gs = qs + BT * D;                      // [BT][D] output grads as rows
  float* pt = gs + BT * D;                      // [BT][LD] P_d, then dS: [query][key]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kb0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* gb = static_cast<const T*>(a.g) + b * a.g_sb + h * a.g_sh;
  const float* biasb = a.bias + static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const long long plane = static_cast<long long>(a.B) * a.H * S;

  load_tile(kb, a.k_ss, kb0, S, D, kt, static_cast<float*>(nullptr));
  load_tile(vb, a.v_ss, kb0, S, D, vt, static_cast<float*>(nullptr));
  bool klive[4];
  float bk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    klive[i] = kb0 + 4 * ty + i < S;
    bk[i] = klive[i] ? biasb[kb0 + 4 * ty + i] : 0.f;
  }

  float dk[4][4 * MAX_CG], dv[4][4 * MAX_CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * MAX_CG; ++c) dk[i][c] = dv[i][c] = 0.f;
  float s[4][4], dp[4][4];

  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();
    load_tile(qb, a.q_ss, q0, S, D, qt, qs);
    load_tile(gb, a.g_ss, q0, S, D, gt, gs);
    __syncthreads();
    dot2(kt, qt, vt, gt, D, ty, tx, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qj = q0 + 4 * tx + j;
      const bool qlive = qj < S;
      const long long st = bh * S + (qlive ? qj : 0);
      const float mq = a.stats[st], lq = a.stats[plane + st];
      const float dq = a.stats[2 * plane + st];
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (a.thr) w = uniter::mask_words(a.seed, bh * S + qj, (kb0 >> 2) + ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (qlive && klive[i])
                            ? expf(s[i][j] * a.sm_scale + bk[i] - mq) / lq : 0.f;
        float pd = p, dpm = dp[i][j];
        if (a.thr) {
          const bool keep = uniter::word(w, i) >= a.thr;
          pd = keep ? p * a.inv_keep : 0.f;
          dpm = keep ? dpm * a.inv_keep : 0.f;
        }
        s[i][j] = pd;
        dp[i][j] = p * (dpm - dq) * a.sm_scale;
      }
    }
    const int nq = min(BT, S - q0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LD + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    accumulate(pt, gs, nq, D, ty, tx, dv);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LD + 4 * ty) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();
    accumulate(pt, qs, nq, D, ty, tx, dk);
  }
  store_rows(static_cast<T*>(a.dk), dk, b, h, kb0, S, a.H, D, ty, tx);
  store_rows(static_cast<T*>(a.dv), dv, b, h, kb0, S, a.H, D, ty, tx);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int smem_a = (4 * a.D * LD + BT * a.D + BT * LD) * static_cast<int>(sizeof(float));
  const int smem_b = (4 * a.D * LD + 2 * BT * a.D + BT * LD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      mha_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BT - 1) / BT, a.H, a.B);
  mha_bwd_dq_kernel<T><<<grid, THREADS, smem_a, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkv_kernel<T><<<grid, THREADS, smem_b, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements (torch's convention); dq/dk/dv are contiguous [B, S, H, D];
// stats is a [3, B, H, S] fp32 scratch. thr = floor(rate * 2^32) (0: no
// dropout), inv_keep = 1 / (1 - rate). Returns the first launch error
// (0 = ok). The caller validates shapes, dtypes, devices and strides.
extern "C" int uniter_mha_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* bias, void* dq, void* dk, void* dv, void* stats, int B, int S,
    int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long g_sb, long long g_ss,
    long long g_sh, float sm_scale, unsigned thr, float inv_keep,
    unsigned long long seed, int dtype, void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(bias), dq, dk, dv,
               static_cast<float*>(stats), B, S, H, D, q_sb, q_ss, q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
               sm_scale, inv_keep, thr, seed};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
