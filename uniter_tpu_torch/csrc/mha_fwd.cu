// K1: fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel uniter_tpu/ops/attention.py:118 `_mha_fwd_kernel`
// (launched by `_mha_pallas_raw`, :300, with `_attn_probs` and
// `_dropout_bits`):
//
//     P[b, h, i, :] = softmax_j(q[b,i,h,:] . k[b,j,h,:] * sm_scale + bias[b,j])
//     out[b, i, h, :] = dropout(P[b, h, i, :]) @ v[b, :, h, :]
//
// with dropout keeping P[b,h,i,j] iff its Philox word >= `thr` and scaling
// kept values by `inv_keep` = 1 / (1 - rate) (philox.cuh states the bits).
// When asked, the bf16 kernel also writes the row log-sum-exp
// LSE = m + log(l) of the scaled, biased scores as fp32 [B, H, S], and the
// bf16 remainder of its output, out_lo = bf16(o - bf16(o)) with o the fp32
// result: the bf16 backward (mha_bwd.cu) rebuilds P = exp(s - LSE) from the
// first in one pass, and takes Di = rowsum(g * o) from out + out_lo, which
// is o to ~2^-16 (the rounded output alone is too coarse for the backward's
// tolerance; chip_smoke.py prints by how much).
//
// q, k, v are read in their [B, S, H, D] layout through strides (the
// innermost dimension contiguous), so the caller transposes nothing; the
// output is a fresh contiguous [B, S, H, D] tensor. bias is the additive
// fp32 padding bias [B, S] (0 for a valid key, -10000 for padding).
//
// Two kernels, picked by dtype:
//
// * bf16 (training): `mha_fwd_tc_kernel<DP>` on the tensor cores. It moves
//   q, k, v in and out back, 4 * B*S*H*D * 2 bytes (18.3 us at the flagship
//   (96, 104, 12, 64) and 3.35 TB/s), and does 4 * B*H*S^2*D FLOP (4.0 us at
//   989 TFLOP/s): bytes bound it. So each byte is staged once, by 16-byte
//   cp.async, and the scores never leave registers. One block of 4 warps per
//   (64-query tile, head, batch element); each warp owns 16 query rows. K
//   and V tiles of 64 keys stream through shared memory, double-buffered;
//   S = Q K^T runs on mma.sync m16n8k16 (ldmatrix-fed, fp32 accumulators),
//   then the fp32 online softmax in registers, in log2 units (the scores
//   times log2 e, so each exp is one exp2f; the LSE goes back to natural
//   units). The unnormalised P is split
//   in registers into hi = bf16(P) and lo = bf16(P - hi), which are
//   directly the A operands of two P V mma passes (the accumulator layout
//   of two n-tiles is the A layout of one k-step), so P never touches
//   shared memory; each key tile's P V is one 64-product tensor-core
//   partial per 8-column tile of O, all of them in flight at once (their
//   fp32 accumulation truncates), added to O in IEEE fp32 after O is
//   rescaled by exp(m_old - m_new). The division by the row sum
//   comes at the end, and O is rounded to bf16 once. D is any multiple of 8
//   up to 128; tiles are zero-padded to DP in {16, 32, 64, 128} columns, and
//   the zeros add exactly nothing.
//   Numerics: the reference rounds P to bf16 before P V
//   (attention.py:124-129); the split keeps P to ~2^-16 instead, so the
//   output is the fp32 result rounded once, within 1e-2 + 2^-8 |ref| of the
//   fp32 plain version on the same inputs (it is in fact within one bf16
//   rounding of it), and out + out_lo within ~2^-16 of it.
//
// * fp32 (serving): `mha_fwd_kernel<float>`, SIMT. Inference runs fp32 and
//   its contract (1e-5 against the plain version) rules out TF32 tensor
//   cores, so the products run on the FP32 units (67 TFLOP/s at 700 W). At
//   S=104, D=64 one (b, h) pair reads 80 KB and does 2.8 MFLOP, above the
//   card's SIMT ridge: the FMA rate and the shared-memory bandwidth that
//   feeds it are the limit. One block of 256 threads per (64-query tile,
//   head, batch element) walks the keys in tiles of 64 with an fp32 online
//   softmax; Q and K tiles are stored transposed in shared memory and each
//   thread owns a 4x4 register tile of scores, so two 16-byte shared loads
//   feed 16 FMAs; P.V reuses the same scheme with P transposed through
//   shared memory. It keeps the unnormalised P in fp32 and divides at the
//   end, which differs from the reference by rounding only.
//
// Numerics common to both, as the reference computes them (`_attn_probs`):
//   * scores in fp32, sm_scale applied to q.k before the bias is added;
//   * max-subtraction; padded keys (-10000) take part in the softmax with
//     weight exp(-10000 - max), so a row whose keys are all padding comes out
//     as the uniform average over all S keys, never NaN or zero, and its LSE
//     stays finite;
//   * keys past S inside the last tile are absent, not padding: their score
//     is -inf and their weight exactly 0;
//   * expf (not __expf) in the fp32 kernel, so its result stays within
//     1e-5; exp2f of log2-scaled scores in the bf16 kernel.
//
// Dropout. The reference drops the NORMALISED probabilities
// (attention.py:48-51), so the row sum `l` accumulates every exp(), dropped
// or not; only the P.V accumulation takes the masked, rescaled values, and
// the division by `l` comes at the end. thr == 0 (rate 0) draws no bits and
// runs exactly the arithmetic of the rate-0 kernel. In the bf16 kernel a
// lane holds keys 2c, 2c+1 of rows g and g+8 of each 8-key n-tile; the two
// lanes of a pair (c, c^1) share one 4-word Philox call per row, so each
// computes one row's call and they swap halves with __shfl_xor_sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int LDQ = BQ + 4;     // pitch of the transposed Q tile [D][LDQ]
constexpr int LDK = BK + 4;     // pitch of the transposed K tile [D][LDK]
constexpr int LDP = BQ + 4;     // pitch of the transposed P tile [BK][LDP]
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int MAX_CG = 2;       // groups of 4 output columns per thread (D <= 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               T* __restrict__ out, int S, int H, int D,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               float sm_scale, unsigned thr, float inv_keep,
               unsigned long long seed) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* qt = reinterpret_cast<float*>(smem4);  // [D][LDQ]
  float* kt = qt + D * LDQ;                     // [D][LDK]
  float* vs = kt + D * LDK;                     // [BK][D]
  float* pt = vs + BK * D;                      // [BK][LDP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column group
  const int ty = tid >> 4;  // query-row group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias + static_cast<long long>(b) * S;

  // Q tile, transposed; rows past S are zero (computed, never stored).
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    qt[d * LDQ + r] = qi < S ? to_f32(qb[qi * q_ss + d]) : 0.f;
  }

  float acc[4][4 * MAX_CG];  // out rows 4*ty+i, columns 4*tx + 64*g + e
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * MAX_CG; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the Q tile is in; the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx - c * D;
      const int kj = k0 + c;
      float kv = 0.f, vv = 0.f;  // zero rows past S: 0 * garbage could be NaN
      if (kj < S) {
        kv = to_f32(kb[kj * k_ss + d]);
        vv = to_f32(vb[kj * v_ss + d]);
      }
      kt[d * LDK + c] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    // scores of rows 4*ty+i against keys k0 + 4*tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * LDK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float bj[4];
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + 4 * tx + j;
      live[j] = kj < S;
      bj[j] = live[j] ? biasb[kj] : 0.f;
    }

    // online softmax: the 16 threads of a row group are 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? s[i][j] * sm_scale + bj[j] : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // key k0 < S is always live, so mn is finite; on the first tile
      // m[i] is -inf and alpha is exactly 0
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);  // absent keys: expf(-inf) = 0
        ls += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l[i] = l[i] * alpha + ls;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * MAX_CG; ++c) acc[i][c] *= alpha;
    }

    if (thr) {  // dropout on P, after the row sums took every exp()
      const long long row0 = (static_cast<long long>(b) * H + h) * S + q0 + 4 * ty;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 w = uniter::mask_words(seed, row0 + i, (k0 >> 2) + tx);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = uniter::word(w, j) >= thr ? s[i][j] * inv_keep : 0.f;
      }
    }

    // P tile, transposed: pt[key][row]
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LDP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int nk = min(BK, S - k0);
    for (int kk = 0; kk < nk; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(pt + kk * LDP + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < MAX_CG; ++g) {
        const int col = 4 * tx + 64 * g;
        if (col < D) {
          const float4 w = *reinterpret_cast<const float4*>(vs + kk * D + col);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
    T* ob = out + ((static_cast<long long>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int g = 0; g < MAX_CG; ++g) {
      const int col = 4 * tx + 64 * g;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(ob + col + e, acc[i][4 * g + e] / l[i]);
      }
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int S, int H, int D,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               float sm_scale, unsigned thr, float inv_keep,
               unsigned long long seed, cudaStream_t stream) {
  const int smem = (D * LDQ + D * LDK + BK * D + BK * LDP) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  mha_fwd_kernel<float><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), S, H, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, sm_scale, thr, inv_keep, seed);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores -------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

struct TcArgs {
  const bf16 *q, *k, *v;
  const float* bias;
  bf16* out;
  bf16* out_lo;  // [B, S, H, D] bf16(o - bf16(o)) or null
  float* lse;    // [B, H, S] or null
  int S, H, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale, inv_keep;
  unsigned thr;
  unsigned long long seed;
};

template <int DP>
__global__ void __launch_bounds__(TC_THREADS) mha_fwd_tc_kernel(TcArgs a) {
  constexpr int LD = DP + 8;  // row pitch (bf16): 16-byte pad, no ldmatrix bank conflicts
  constexpr int KS = DP / 16;  // k-steps over the head dim
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [64][LD]
  bf16* ks = qs + 64 * LD;                      // [2][64][LD]
  bf16* vs = ks + 2 * 64 * LD;                  // [2][64][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.D;
  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* biasb = a.bias + static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const long long row0 = bh * S + q0 + 16 * warp + g;  // score row of row g
  const int nkt = (S + 63) / 64;
  const bool odd = lane & 1;

  uniter::stage_rows<DP>(qs, qb, a.q_ss, q0, S, D);
  uniter::stage_rows<DP>(ks, kb, a.k_ss, 0, S, D);
  uniter::stage_rows<DP>(vs, vb, a.v_ss, 0, S, D);
  uniter::cp_async_commit();

  unsigned qf[KS][4];
  float o[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  // scores in log2 units, s log2(e): exp(x - m) = exp2(x log2 e - m log2 e)
  const float scale_l2 = a.sm_scale * uniter::kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < nkt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nkt) {  // the next K/V tile streams in behind this one
      uniter::stage_rows<DP>(ks + (buf ^ 1) * 64 * LD, kb, a.k_ss, (t + 1) * 64, S, D);
      uniter::stage_rows<DP>(vs + (buf ^ 1) * 64 * LD, vb, a.v_ss, (t + 1) * 64, S, D);
      uniter::cp_async_commit();
      uniter::cp_async_wait<1>();
    } else {
      uniter::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        uniter::ldsm_x4(qf[kk], qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                                    + 16 * kk + 8 * (lane >> 4));
    }
    const bf16* kt = ks + buf * 64 * LD;
    const bf16* vt = vs + buf * 64 * LD;

    // S = Q K^T: rows g, g+8 of this warp, keys 8 nt + 2c + {0, 1}
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4];
        uniter::ldsm_x4(kf, kt + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD
                                + 16 * kk + 8 * ((lane >> 3) & 1));
        uniter::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        uniter::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    const int k0 = t * 64;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * nt + 2 * c + e;
        const bool live = kj < S;
        const float bj = live ? biasb[kj] * uniter::kLog2e : 0.f;
        s[nt][e] = live ? fmaf(s[nt][e], scale_l2, bj) : -INFINITY;
        s[nt][2 + e] = live ? fmaf(s[nt][2 + e], scale_l2, bj) : -INFINITY;
        mt[0] = fmaxf(mt[0], s[nt][e]);
        mt[1] = fmaxf(mt[1], s[nt][2 + e]);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      // key k0 < S is live, so the new max is finite; on the first tile
      // m is -inf and alpha exactly 0
      const float mn = fmaxf(m[i], mt[i]);
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);  // absent keys: exp2(-inf) = 0
        ls[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
      ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
      l[i] = l[i] * alpha[i] + ls[i];
    }
#pragma unroll
    for (int t2 = 0; t2 < DP / 8; ++t2) {
      o[t2][0] *= alpha[0];
      o[t2][1] *= alpha[0];
      o[t2][2] *= alpha[1];
      o[t2][3] *= alpha[1];
    }

    if (a.thr) {  // dropout on P, after the row sums took every exp()
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // keys 2c, 2c+1 are words 2(c&1), 2(c&1)+1 of group (k0 + 8nt)/4 + c/2;
        // the even lane draws row g's group, the odd lane row g+8's
        const uint4 w = uniter::mask_words(a.seed, row0 + (odd ? 8 : 0),
                                           ((k0 + 8 * nt) >> 2) + (c >> 1));
        const unsigned x0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const unsigned x1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        const unsigned w0 = odd ? x0 : w.x, w1 = odd ? x1 : w.y;  // row g
        const unsigned w2 = odd ? w.z : x0, w3 = odd ? w.w : x1;  // row g+8
        s[nt][0] = w0 >= a.thr ? s[nt][0] * a.inv_keep : 0.f;
        s[nt][1] = w1 >= a.thr ? s[nt][1] * a.inv_keep : 0.f;
        s[nt][2] = w2 >= a.thr ? s[nt][2] * a.inv_keep : 0.f;
        s[nt][3] = w3 >= a.thr ? s[nt][3] * a.inv_keep : 0.f;
      }
    }

    // O += P V: P from registers as hi + lo bf16 A fragments, V^T by
    // ldmatrix.trans; the tile's 64 keys sum in one tensor-core partial per
    // output tile, added to O in IEEE fp32
    unsigned ph[4][4], pl[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uniter::split_bf16(s[2 * kc][0], s[2 * kc][1], ph[kc][0], pl[kc][0]);
      uniter::split_bf16(s[2 * kc][2], s[2 * kc][3], ph[kc][1], pl[kc][1]);
      uniter::split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[kc][2], pl[kc][2]);
      uniter::split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[kc][3], pl[kc][3]);
    }
    uniter::add_split_product<DP>(o, ph, pl, vt, lane);
    __syncthreads();  // this tile's buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * warp + g + 8 * i;
    if (qi >= S) continue;
    const long long ro = ((static_cast<long long>(b) * S + qi) * a.H + h) * D;
#pragma unroll
    for (int t2 = 0; t2 < DP / 8; ++t2) {
      const int col = 8 * t2 + 2 * c;
      if (col < D) {
        unsigned hi, lo;
        uniter::split_bf16(o[t2][2 * i] / l[i], o[t2][2 * i + 1] / l[i], hi, lo);
        *reinterpret_cast<unsigned*>(a.out + ro + col) = hi;
        if (a.out_lo) *reinterpret_cast<unsigned*>(a.out_lo + ro + col) = lo;
      }
    }
    if (a.lse && c == 0) a.lse[bh * S + qi] = m[i] * uniter::kLn2 + logf(l[i]);
  }
}

template <int DP>
int launch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  const int smem = 5 * 64 * (DP + 8) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + 63) / 64, a.H, B);
  mha_fwd_tc_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32 (SIMT kernel; out_lo and lse
// must be null), 1 = bfloat16 (tensor-core kernel; out_lo a contiguous
// [B, S, H, D] bf16 buffer for the output's remainder and lse [B, H, S]
// fp32, each or both null).
// Strides are in elements (torch's convention). thr = floor(rate * 2^32)
// (0: no dropout), inv_keep = 1 / (1 - rate). Returns the launch's
// cudaError_t (0 = ok). The caller validates shapes, dtypes, devices and
// strides (bf16: 16-byte aligned bases and strides).
extern "C" int uniter_mha_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* out_lo,
                              void* lse, int B,
                              int S, int H, int D, long long q_sb,
                              long long q_ss, long long q_sh, long long k_sb,
                              long long k_ss, long long k_sh, long long v_sb,
                              long long v_ss, long long v_sh, float sm_scale,
                              unsigned thr, float inv_keep,
                              unsigned long long seed, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && lse == nullptr && out_lo == nullptr)
    return launch_f32(q, k, v, bias, out, B, S, H, D, q_sb, q_ss, q_sh, k_sb,
                      k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale, thr, inv_keep,
                      seed, st);
  if (dtype != 1 || D % 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const float*>(bias),
                 static_cast<bf16*>(out), static_cast<bf16*>(out_lo),
                 static_cast<float*>(lse), S, H, D,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 sm_scale, inv_keep, thr, seed};
  if (D <= 16) return launch_tc<16>(a, B, st);
  if (D <= 32) return launch_tc<32>(a, B, st);
  if (D <= 64) return launch_tc<64>(a, B, st);
  return launch_tc<128>(a, B, st);
}
