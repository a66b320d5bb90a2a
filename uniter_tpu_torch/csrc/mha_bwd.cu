// K2: fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel uniter_tpu/ops/attention.py:133 `_mha_bwd_kernel`
// (launched by `_mha_pallas_bwd_raw`, :327, the backward of the custom VJP
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
// dv are written contiguous [B, S, H, D] in the inputs' dtype. Two kernels,
// picked by dtype:
//
// * bf16 (training): `mha_bwd_tc_kernel<DP>`, one pass on the tensor cores.
//   The function reads q, k, v, g and writes dq, dk, dv: at the flagship
//   (96, 104, 12, 64) 7 * 15.3 MB = 107 MB, 32.1 us at 3.35 TB/s (the kernel
//   also reads out and out_lo once, for Di: 2 tensors more), against
//   10 * B*H*S^2*D = 8.0 GFLOP, 8.1 us at 989 TFLOP/s. Bytes bound it once
//   its products run on the tensor cores, so the design moves each byte
//   once: no recompute pass, no fp32 copies of inputs in shared memory.
//   The forward (mha_fwd.cu) hands over the row log-sum-exp, so
//   P = exp(s - LSE) needs no pass over the keys first, and
//   Di = rowsum(g * out) comes from the forward's output in a prologue, as
//   FlashAttention computes it, but from out + out_lo (the output's bf16
//   remainder, which K1 writes), i.e. from the fp32 output to ~2^-16: from
//   the bf16 output alone, dq and dk miss the tolerance against the JAX
//   kernel's formula by far (chip_smoke.py prints by how much). One block
//   of 4 warps per (b, h), S <= 512:
//     - outer loop over key tiles of 64: K_j and V_j in shared memory (bf16,
//       cp.async); each warp owns 16 keys and keeps their dK, dV in fp32
//       registers;
//     - inner loop over query tiles of 64: Q_i and g_i stream in,
//       double-buffered; S^T = K Q^T and dP^T = V g^T on mma.sync
//       m16n8k16 (ldmatrix-fed), then P = exp2((s - LSE) log2 e), P_d and
//       dS in fp32 registers;
//       dV += P_d^T g_i and dK += dS^T Q_i take P_d and dS straight from
//       the accumulators as A fragments; dS also goes to shared memory,
//       and each warp adds dS K_j into 16 query rows of dQ; each of these
//       products keeps all its 8-column output tiles in flight at once
//       (independent tensor-core chains, where one 16-column slab at a
//       time left the warp waiting on each chain's latency);
//     - dQ for all S queries lives in shared memory as fp32 (S*D*4 bytes:
//       26.6 KB at S = 104, 131 KB at S = 512, D = 64), written once at the
//       end; past 227 KB (D = 128 with long S) it lives in an fp32 scratch
//       in device memory that the block alone owns.
//   5 score-sized products, 8 tensor-core passes with the split below, one
//   pass over the data. No atomics and no sums across blocks: a replay is
//   bitwise equal.
//   Numerics: the JAX kernel keeps P and dS in fp32 (attention.py:137-170).
//   q, k, v, g are bf16 and exact on the tensor cores; P_d and dS are not,
//   so each is split into hi = bf16(x) and lo = bf16(x - hi) and takes two
//   mma passes (error ~2^-16 relative a term). Each tensor-core partial sums
//   at most 64 products (one 64-query or 64-key tile; the tensor cores'
//   fp32 accumulation truncates), and the partials add up in IEEE fp32
//   across tiles. The results, rounded once to bf16, hold to
//   1e-3 + 2^-8 |ref| against the fp32 plain version on the same inputs.
//   Dropout bits: each 64x64 tile's mask is drawn once into shared memory
//   (one Philox call per 4 keys of a query row, 8 a thread) and read back
//   in the transposed (key-major) fragment layout.
//
// * fp32 (the 2-layer fp32 gates): the two SIMT passes of
//   `mha_bwd_dq_kernel<float>` and `mha_bwd_dkv_kernel<float>`, the
//   FlashAttention-2 split, 256 threads per block as 16 x 16, each thread
//   owning a 4 x 4 tile of a 64 x 64 score block fed by 16-byte
//   shared-memory loads. Only q, k, v, bias and the seed are used, so P is
//   recomputed here:
//     - pass A, one block per (64-query tile, h, b): walks the keys twice.
//       The first walk recomputes the row statistics (max m, sum l of every
//       exp, dropped or not) and Di with an online rescale, and stores them
//       to a [3, B, H, S] fp32 scratch; the second recomputes P and dPm and
//       accumulates dQ = dS K.
//     - pass B, one block per (64-key tile, h, b): walks the queries once,
//       recomputes the transposed scores with the stored statistics, and
//       accumulates dV = P_d^T g and dK = dS^T Q.
//   Scores are summed over d in the same order in both passes, so they are
//   bit-identical between them.
//
// Numerics follow K1: padded keys (-10000) take part in the softmax, keys
// and queries past S are absent (weight 0, nothing stored), expf not
// __expf in fp32 (exp2f in bf16); the normaliser l sums undropped
// probabilities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr int BT = 64;          // queries or keys per tile
constexpr int LD = BT + 4;      // pitch of transposed tiles [D][LD] and [BT][LD]
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int MAX_CG = 2;       // groups of 4 output columns per thread (D <= 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

int launch_f32(const Args& a, cudaStream_t stream) {
  const int smem_a = (4 * a.D * LD + BT * a.D + BT * LD) * static_cast<int>(sizeof(float));
  const int smem_b = (4 * a.D * LD + 2 * BT * a.D + BT * LD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      mha_bwd_dkv_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BT - 1) / BT, a.H, a.B);
  mha_bwd_dq_kernel<float><<<grid, THREADS, smem_a, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkv_kernel<float><<<grid, THREADS, smem_b, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: one pass on the tensor cores ----------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // 4 warps x 16 keys (dK, dV) or 16 queries (dQ)
constexpr int LDS = 64 + 8;      // pitch of the dS^T tiles [64 keys][LDS] (bf16)

struct TcArgs {
  const bf16 *q, *k, *v, *g, *out, *out_lo;
  const float *bias, *lse;
  bf16 *dq, *dk, *dv;
  float* dq_acc;  // [B*H][S_pad][DP + 8] fp32 in device memory, or null: shared
  int B, S, H, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  float sm_scale, inv_keep;
  unsigned thr;
  unsigned long long seed;
};

// dynamic shared memory of mha_bwd_tc_kernel<DP> (mirrored by
// ops/attention.py `_bwd_tc_smem`)
template <int DP>
int tc_smem(int S, bool dq_shared) {
  const int s_pad = (S + 63) / 64 * 64;
  return 6 * 64 * (DP + 8) * 2     // K, V; Q, g double-buffered
         + 2 * 64 * LDS * 2        // dS^T hi and lo
         + 2 * s_pad * 4           // LSE, Di
         + 64 * 2 * 4              // the tile's dropout bits
         + (dq_shared ? s_pad * (DP + 8) * 4 : 0);
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS) mha_bwd_tc_kernel(TcArgs a) {
  constexpr int LD = DP + 8;  // bf16 tile pitch; also the fp32 dQ pitch
  constexpr int KS = DP / 16, NDT = DP / 8;
  const int S = a.S, D = a.D;
  const int s_pad = (S + 63) / 64 * 64, ntile = s_pad / 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * a.H + h;

  extern __shared__ uint4 smem_tc[];
  float* fs = reinterpret_cast<float*>(smem_tc);
  float* dqa = a.dq_acc ? a.dq_acc + bh * s_pad * LD : fs;  // [s_pad][LD]
  float* lse_s = a.dq_acc ? fs : fs + s_pad * LD;           // [s_pad]
  float* di_s = lse_s + s_pad;                              // [s_pad]
  unsigned* mask_s = reinterpret_cast<unsigned*>(di_s + s_pad);  // [64][2]
  bf16* ks = reinterpret_cast<bf16*>(mask_s + 128);         // [64][LD]
  bf16* vs = ks + 64 * LD;                                  // [64][LD]
  bf16* qs = vs + 64 * LD;                                  // [2][64][LD]
  bf16* gs = qs + 2 * 64 * LD;                              // [2][64][LD]
  bf16* dsh = gs + 2 * 64 * LD;                             // [64][LDS] dS^T hi
  bf16* dsl = dsh + 64 * LDS;                               // [64][LDS] dS^T lo

  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const bf16* gb = a.g + b * a.g_sb + h * a.g_sh;
  const float* biasb = a.bias + static_cast<long long>(b) * S;

  // the first Q/g tile streams in during the prologue
  uniter::stage_rows<DP>(qs, qb, a.q_ss, 0, S, D);
  uniter::stage_rows<DP>(gs, gb, a.g_ss, 0, S, D);
  uniter::cp_async_commit();

  // prologue: LSE and Di = rowsum(g * (out + out_lo)) in fp32 (0 on rows
  // past S, whose q and g tiles are zero, so they add nothing anywhere);
  // dQ = 0
  for (int r = tid; r < s_pad; r += TC_THREADS) {
    float lse = 0.f, di = 0.f;
    if (r < S) {
      lse = a.lse[bh * S + r];
      const bf16* gr = gb + r * a.g_ss;
      const long long ro = ((static_cast<long long>(b) * S + r) * a.H + h) * D;
      for (int d = 0; d < D; d += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gr + d);
        const uint4 ov = *reinterpret_cast<const uint4*>(a.out + ro + d);
        const uint4 lv = *reinterpret_cast<const uint4*>(a.out_lo + ro + d);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(g2[e]);
          const float2 of = __bfloat1622float2(o2[e]), lf = __bfloat1622float2(l2[e]);
          di = fmaf(gf.x, of.x + lf.x, di);
          di = fmaf(gf.y, of.y + lf.y, di);
        }
      }
    }
    lse_s[r] = lse;
    di_s[r] = di;
  }
  for (int idx = tid; idx < s_pad * LD; idx += TC_THREADS) dqa[idx] = 0.f;

  const float scale_l2 = a.sm_scale * uniter::kLog2e;  // exp(x) = exp2(x log2 e)
  const int total = ntile * ntile;
  int n = 0;  // (key tile, query tile) step
  for (int j = 0; j < ntile; ++j) {
    const int k0 = j * 64;
    __syncthreads();  // K_{j-1}, V_{j-1} and dS are read; the prologue is done
    uniter::stage_rows<DP>(ks, kb, a.k_ss, k0, S, D);
    uniter::stage_rows<DP>(vs, vb, a.v_ss, k0, S, D);
    uniter::cp_async_commit();

    // this warp's keys: rows kr0 and kr0 + 8 of the tile
    const int kr0 = 16 * warp + g;
    float bk[2];
    bool lk[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kj = k0 + kr0 + 8 * u;
      lk[u] = kj < S;
      bk[u] = lk[u] ? biasb[kj] : 0.f;
    }
    float dk[NDT][4], dv[NDT][4];
#pragma unroll
    for (int t = 0; t < NDT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

    for (int i = 0; i < ntile; ++i, ++n) {
      const int q0 = i * 64, buf = n & 1;
      if (i > 0) __syncthreads();  // buffer buf^1, dS and the bits are free
      if (n + 1 < total) {         // the next step's Q/g (the next j wraps to 0)
        const int qn = (i + 1 < ntile ? i + 1 : 0) * 64;
        uniter::stage_rows<DP>(qs + (buf ^ 1) * 64 * LD, qb, a.q_ss, qn, S, D);
        uniter::stage_rows<DP>(gs + (buf ^ 1) * 64 * LD, gb, a.g_ss, qn, S, D);
        uniter::cp_async_commit();
      }
      if (a.thr) {  // the tile's mask: thread t draws query t/2, keys 32 (t%2) ..
        const int ql = tid >> 1, half = tid & 1;
        const long long row = bh * S + q0 + ql;
        unsigned bits = 0u;
#pragma unroll
        for (int gi = 0; gi < 8; ++gi) {
          const uint4 w = uniter::mask_words(a.seed, row, ((k0 + 32 * half) >> 2) + gi);
          bits |= (static_cast<unsigned>(w.x >= a.thr) << (4 * gi))
                | (static_cast<unsigned>(w.y >= a.thr) << (4 * gi + 1))
                | (static_cast<unsigned>(w.z >= a.thr) << (4 * gi + 2))
                | (static_cast<unsigned>(w.w >= a.thr) << (4 * gi + 3));
        }
        mask_s[ql * 2 + half] = bits;
      }
      if (n + 1 < total)
        uniter::cp_async_wait<1>();
      else
        uniter::cp_async_wait<0>();
      __syncthreads();
      const bf16* qt = qs + buf * 64 * LD;
      const bf16* gt = gs + buf * 64 * LD;

      // S^T = K Q^T and dP^T = V g^T: keys kr0 (+8), queries 8 nt + 2c + {0,1}
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned ka[4], va[4];
        const int arow = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                         + 16 * kk + 8 * (lane >> 4);
        uniter::ldsm_x4(ka, ks + arow);
        uniter::ldsm_x4(va, vs + arow);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned qf[4], gf[4];
          const int brow = (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD
                           + 16 * kk + 8 * ((lane >> 3) & 1);
          uniter::ldsm_x4(qf, qt + brow);
          uniter::ldsm_x4(gf, gt + brow);
          uniter::mma_bf16(st[2 * np], ka, qf[0], qf[1]);
          uniter::mma_bf16(st[2 * np + 1], ka, qf[2], qf[3]);
          uniter::mma_bf16(dpt[2 * np], va, gf[0], gf[1]);
          uniter::mma_bf16(dpt[2 * np + 1], va, gf[2], gf[3]);
        }
      }

      // P = exp(s - LSE), P_d, dS = P (dPm - Di) sm_scale; split to hi/lo
      // A fragments (rows: keys, k: queries) and dS^T to shared memory
      unsigned pdh[4][4], pdl[4][4], dsh_r[4][4], dsl_r[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * t + 2 * c + e;
          const float lse = lse_s[q0 + ql], di = di_s[q0 + ql];
          const unsigned bits = a.thr ? mask_s[ql * 2 + (warp >> 1)] : 0u;
#pragma unroll
          for (int u = 0; u < 2; ++u) {  // key rows kr0 + 8u
            const float p =
                lk[u] ? exp2f(fmaf(st[t][2 * u + e], scale_l2, (bk[u] - lse) * uniter::kLog2e)) : 0.f;
            float pd = p, dpm = dpt[t][2 * u + e];
            if (a.thr) {
              const bool keep = (bits >> ((kr0 + 8 * u) & 31)) & 1u;
              pd = keep ? p * a.inv_keep : 0.f;
              dpm = keep ? dpm * a.inv_keep : 0.f;
            }
            st[t][2 * u + e] = pd;
            dpt[t][2 * u + e] = p * (dpm - di) * a.sm_scale;
          }
        }
        unsigned h0, l0, h1, l1;  // key rows kr0 and kr0 + 8
        uniter::split_bf16(st[t][0], st[t][1], h0, l0);
        uniter::split_bf16(st[t][2], st[t][3], h1, l1);
        pdh[t >> 1][2 * (t & 1)] = h0;
        pdl[t >> 1][2 * (t & 1)] = l0;
        pdh[t >> 1][2 * (t & 1) + 1] = h1;
        pdl[t >> 1][2 * (t & 1) + 1] = l1;
        uniter::split_bf16(dpt[t][0], dpt[t][1], h0, l0);
        uniter::split_bf16(dpt[t][2], dpt[t][3], h1, l1);
        dsh_r[t >> 1][2 * (t & 1)] = h0;
        dsl_r[t >> 1][2 * (t & 1)] = l0;
        dsh_r[t >> 1][2 * (t & 1) + 1] = h1;
        dsl_r[t >> 1][2 * (t & 1) + 1] = l1;
        const int col = 8 * t + 2 * c;
        *reinterpret_cast<unsigned*>(dsh + kr0 * LDS + col) = h0;
        *reinterpret_cast<unsigned*>(dsl + kr0 * LDS + col) = l0;
        *reinterpret_cast<unsigned*>(dsh + (kr0 + 8) * LDS + col) = h1;
        *reinterpret_cast<unsigned*>(dsl + (kr0 + 8) * LDS + col) = l1;
      }

      // dV += P_d^T g_i, then dK += dS^T Q_i
      uniter::add_split_product<DP>(dv, pdh, pdl, gt, lane);
      uniter::add_split_product<DP>(dk, dsh_r, dsl_r, qt, lane);
      __syncthreads();  // dS^T of every warp is in shared memory

      // dQ rows q0 + 16 warp + g (+8) += dS K_j: A = dS (rows: queries) by
      // ldmatrix.trans of dS^T, B = K_j by ldmatrix.trans
      unsigned ah[4][4], al[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int arow = (16 * kc + (lane & 7) + 8 * (lane >> 4)) * LDS
                         + 16 * warp + 8 * ((lane >> 3) & 1);
        uniter::ldsm_x4_t(ah[kc], dsh + arow);
        uniter::ldsm_x4_t(al[kc], dsl + arow);
      }
      float tq[NDT][4];
#pragma unroll
      for (int t = 0; t < NDT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) tq[t][e] = 0.f;
      uniter::add_split_product<DP>(tq, ah, al, ks, lane);
#pragma unroll
      for (int t = 0; t < NDT; ++t) {
        const int col = 8 * t + 2 * c;
        float2* r0 = reinterpret_cast<float2*>(dqa + (q0 + 16 * warp + g) * LD + col);
        float2* r1 = reinterpret_cast<float2*>(dqa + (q0 + 16 * warp + g + 8) * LD + col);
        float2 x0 = *r0, x1 = *r1;
        x0.x += tq[t][0];
        x0.y += tq[t][1];
        x1.x += tq[t][2];
        x1.y += tq[t][3];
        *r0 = x0;
        *r1 = x1;
      }
    }

#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kj = k0 + kr0 + 8 * u;
      if (kj >= S) continue;
      const long long o = ((static_cast<long long>(b) * S + kj) * a.H + h) * D;
#pragma unroll
      for (int t = 0; t < NDT; ++t) {
        const int col = 8 * t + 2 * c;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + o + col) =
              __floats2bfloat162_rn(dk[t][2 * u], dk[t][2 * u + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + o + col) =
              __floats2bfloat162_rn(dv[t][2 * u], dv[t][2 * u + 1]);
        }
      }
    }
  }
  __syncthreads();  // every warp's dQ rows are summed
  for (int idx = tid; idx < S * (D / 2); idx += TC_THREADS) {
    const int r = idx / (D / 2), col = 2 * (idx - r * (D / 2));
    *reinterpret_cast<__nv_bfloat162*>(
        a.dq + ((static_cast<long long>(b) * S + r) * a.H + h) * D + col) =
        __floats2bfloat162_rn(dqa[r * LD + col], dqa[r * LD + col + 1]);
  }
}

template <int DP>
int launch_tc(const TcArgs& a, cudaStream_t stream) {
  const int smem = tc_smem<DP>(a.S, a.dq_acc == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_tc_kernel<DP><<<dim3(a.H, a.B), TC_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Strides are in elements (torch's convention);
// dq/dk/dv are contiguous [B, S, H, D]; thr = floor(rate * 2^32) (0: no
// dropout), inv_keep = 1 / (1 - rate). dtype 0 = float32: the two SIMT
// passes, `out` and `lse` null, `scratch` a [3, B, H, S] fp32 buffer for the
// row statistics. dtype 1 = bfloat16: the tensor-core pass, `out` and
// `out_lo` the forward's contiguous [B, S, H, D] output and its bf16
// remainder, `lse` its [B, H, S] fp32 row log-sum-exp, `scratch` null (dQ in shared memory) or a
// [B * H, S_pad, DP + 8] fp32 buffer for dQ (ops/attention.py
// `_bwd_tc_smem` says when). Returns the first launch error (0 = ok). The
// caller validates shapes, dtypes, devices and strides (bf16: 16-byte
// aligned bases and strides).
extern "C" int uniter_mha_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* bias, const void* out, const void* out_lo, const void* lse,
    void* dq, void* dk,
    void* dv, void* scratch, int B, int S, int H, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long g_sb, long long g_ss, long long g_sh, float sm_scale,
    unsigned thr, float inv_keep, unsigned long long seed, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out == nullptr && out_lo == nullptr && lse == nullptr &&
      scratch != nullptr) {
    const Args a{q, k, v, g, static_cast<const float*>(bias), dq, dk, dv,
                 static_cast<float*>(scratch), B, S, H, D, q_sb, q_ss, q_sh,
                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
                 sm_scale, inv_keep, thr, seed};
    return launch_f32(a, st);
  }
  if (dtype != 1 || out == nullptr || out_lo == nullptr || lse == nullptr ||
      D % 8 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                 static_cast<const bf16*>(out), static_cast<const bf16*>(out_lo),
                 static_cast<const float*>(bias),
                 static_cast<const float*>(lse), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<float*>(scratch), B, S, H, D, q_sb, q_ss, q_sh,
                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
                 sm_scale, inv_keep, thr, seed};
  if (D <= 16) return launch_tc<16>(a, st);
  if (D <= 32) return launch_tc<32>(a, st);
  if (D <= 64) return launch_tc<64>(a, st);
  return launch_tc<128>(a, st);
}
