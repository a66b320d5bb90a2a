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
// When asked, either kernel also writes the row log-sum-exp
// LSE = m + log(l) of the scaled, biased scores as fp32 [B, H, S], and the
// bf16 kernel the bf16 remainder of its output, out_lo = bf16(o - bf16(o))
// with o the fp32 result: the backward (mha_bwd.cu) rebuilds
// P = exp(s - LSE) from the first in one pass, and takes Di = rowsum(g * o)
// from the fp32 output, or in bf16 from out + out_lo, which is o to ~2^-16
// (the rounded output alone is too coarse for the backward's tolerance;
// chip_smoke.py prints by how much).
//
// q, k, v are read in their [B, S, H, D] layout through strides (the
// innermost dimension contiguous), so the caller transposes nothing; the
// output is a fresh contiguous [B, S, H, D] tensor. bias is the additive
// fp32 padding bias [B, S] (0 for a valid key, -10000 for padding).
//
// Two kernels, picked by dtype, both on the tensor cores:
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
// * fp32 (serving): `mha_fwd_tf32_kernel<DP>`, the same structure on the
//   TF32 tensor cores (mma.sync m16n8k8), with every product split three
//   ways (mma.cuh `split_tf32`): x = hi + lo, hi = tf32(x) by
//   cvt.rna.tf32.f32, lo = tf32(x - hi), and a b by the passes a_lo b_hi,
//   a_hi b_lo, then a_hi b_hi into one partial. One TF32 pass keeps 10
//   mantissa bits, 56x outside the contract of 1e-5 against the plain
//   version; the split keeps fp32 accuracy (the lo lo term is below fp32's
//   own rounding) at a third of the TF32 rate, 165 TFLOP/s, 2.5x the 67 of
//   the FP32 units that the SIMT kernel it replaces ran on. The function
//   moves 4 * B*S*H*D * 4 bytes (36.6 us at the flagship and 3.35 TB/s)
//   and does 4 * B*H*S^2*D FLOP (19.3 us at 165 TFLOP/s): bytes bound it.
//   Per block: 4 warps, 16 query rows each; Q and double-buffered K/V tiles
//   of 64 rows staged as fp32 by cp.async on a pitch of DP + 4 floats (every
//   fragment load conflict-free); operands are split as they are loaded,
//   not whole tiles, to keep registers. The TF32 accumulator is not the A
//   layout, so P V lets k-slot c stand for key 2c of a k-step and slot c + 4
//   for key 2c + 1 (mma.cuh, "paired"): P goes from the score accumulators
//   straight into the A fragments, and V is read down rows 2c, 2c + 1. Each
//   tensor-core partial sums at most 64 products (64 keys, or 64 head dims
//   of q.k; D = 128 takes two) and is added in IEEE fp32; the two small
//   passes sum in partials of their own, so the tensor cores' truncating
//   sums of hi hi run 8 steps a partial, not 24 (the worst error at the
//   flagship fell from 6.0e-6 to 4.1e-6; 198 registers at D = 64, not 159). Scores stay in
//   natural units with expf, as the plain version computes them; with
//   `lse` it writes the row log-sum-exp m + log(l), and with `lse_lo` its
//   fp32 remainder (TwoSum): a row whose keys are all padding has an LSE
//   near -10000, where the fp32 grid is 2^-10, and P = exp(s - LSE) from
//   the rounded LSE alone is off by up to 2^-11 relative on that row, which
//   takes the backward's dq and dv past 1e-4 against the JAX kernel's
//   formula; (s - lse) - lse_lo is exact to fp32 there. The division by
//   the row sum comes at the end.
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

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

// ---- fp32: TF32 tensor cores, three passes -------------------------------

struct F32Args {
  const float *q, *k, *v, *bias;
  float* out;
  float* lse;     // [B, H, S] or null
  float* lse_lo;  // [B, H, S]: LSE - lse in fp32, or null
  int S, H, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale, inv_keep;
  unsigned thr;
  unsigned long long seed;
  unsigned long long row_base;  // the mask row of score row 0 (philox.cuh)
  int heads_total, head0;  // head h of the launch is head0 + h of these
};

template <int DP>
__global__ void __launch_bounds__(TC_THREADS) mha_fwd_tf32_kernel(F32Args a) {
  constexpr int LD = DP + 4;  // fp32 tile pitch (mma.cuh: conflict-free)
  extern __shared__ uint4 smem_f[];
  float* qs = reinterpret_cast<float*>(smem_f);  // [64][LD]
  float* ks = qs + 64 * LD;                      // [2][64][LD]
  float* vs = ks + 2 * 64 * LD;                  // [2][64][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 3;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.D;
  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* biasb = a.bias + static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // the mask row: head h of the launch is head head0 + h of heads_total
  const long long mbh = static_cast<long long>(b) * a.heads_total + a.head0 + h;
  const long long row0 =
      static_cast<long long>(a.row_base) + mbh * S + q0 + 16 * warp + (lane >> 2);
  const int nkt = (S + 63) / 64;
  const bool odd = lane & 1;

  uniter::stage_rows_f32<DP>(qs, qb, a.q_ss, q0, S, D);
  uniter::stage_rows_f32<DP>(ks, kb, a.k_ss, 0, S, D);
  uniter::stage_rows_f32<DP>(vs, vb, a.v_ss, 0, S, D);
  uniter::cp_async_commit();

  float o[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < nkt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nkt) {  // the next K/V tile streams in behind this one
      uniter::stage_rows_f32<DP>(ks + (buf ^ 1) * 64 * LD, kb, a.k_ss, (t + 1) * 64, S, D);
      uniter::stage_rows_f32<DP>(vs + (buf ^ 1) * 64 * LD, vb, a.v_ss, (t + 1) * 64, S, D);
      uniter::cp_async_commit();
      uniter::cp_async_wait<1>();
    } else {
      uniter::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * 64 * LD;
    const float* vt = vs + buf * 64 * LD;

    // S = Q K^T: rows g, g+8 of this warp, keys 8 nt + 2c + {0, 1}
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    uniter::add_rows_product<8, DP, true>(s, qs, 16 * warp, kt, LD, lane);

    // the scaled, biased scores in natural units, expf as the reference
    const int k0 = t * 64;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * nt + 2 * c + e;
        const bool live = kj < S;
        const float bj = live ? biasb[kj] : 0.f;
        s[nt][e] = live ? fmaf(s[nt][e], a.sm_scale, bj) : -INFINITY;
        s[nt][2 + e] = live ? fmaf(s[nt][2 + e], a.sm_scale, bj) : -INFINITY;
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
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);  // absent keys: expf(-inf) = 0
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
        // as the bf16 kernel: the even lane draws row g's group, the odd
        // lane row g+8's, and they swap halves
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

    // O += P V: P from registers (paired k-slots, mma.cuh), V read down
    // paired rows; one 64-key partial per output tile, added in fp32
    uniter::add_acc_product<DP / 8, true>(o, s, vt, LD, lane);
    __syncthreads();  // this tile's buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * warp + (lane >> 2) + 8 * i;
    if (qi >= S) continue;
    const long long ro = ((static_cast<long long>(b) * S + qi) * a.H + h) * D;
#pragma unroll
    for (int t2 = 0; t2 < DP / 8; ++t2) {
      const int col = 8 * t2 + 2 * c;
      if (col < D)
        *reinterpret_cast<float2*>(a.out + ro + col) =
            make_float2(o[t2][2 * i] / l[i], o[t2][2 * i + 1] / l[i]);
    }
    if (a.lse && c == 0) {  // hi + lo = m + log(l) to ~2^-48 (TwoSum)
      const float ll = logf(l[i]), hi = m[i] + ll, bb = hi - m[i];
      a.lse[bh * S + qi] = hi;
      if (a.lse_lo) a.lse_lo[bh * S + qi] = (m[i] - (hi - bb)) + (ll - bb);
    }
  }
}

template <int DP>
int fwd_tf32_smem() { return 5 * 64 * (DP + 4) * static_cast<int>(sizeof(float)); }

template <int DP>
int launch_tf32(const F32Args& a, int B, cudaStream_t stream) {
  const int smem = fwd_tf32_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_tf32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + 63) / 64, a.H, B);
  mha_fwd_tf32_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores -------------------------------------------------

using bf16 = __nv_bfloat16;

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
  unsigned long long row_base;  // the mask row of score row 0 (philox.cuh)
  int heads_total, head0;  // head h of the launch is head0 + h of these
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
  // the mask row of row g: the score row past the row base, head h of the
  // launch being head head0 + h of heads_total
  const long long mbh = static_cast<long long>(b) * a.heads_total + a.head0 + h;
  const long long row0 =
      static_cast<long long>(a.row_base) + mbh * S + q0 + 16 * warp + g;
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

// Plain C entry for ctypes. dtype: 0 = float32 (the TF32 kernel; out_lo
// must be null, lse and lse_lo [B, H, S] fp32 buffers for the row
// log-sum-exp and its remainder, or null), 1 = bfloat16 (out_lo a
// contiguous [B, S, H, D] bf16 buffer for the output's remainder and lse
// [B, H, S] fp32, each or both null; lse_lo null). Both kernels stage rows by 16-byte
// cp.async: bases and strides 16-byte aligned.
// Strides are in elements (torch's convention). thr = floor(rate * 2^32)
// (0: no dropout), inv_keep = 1 / (1 - rate). Returns the launch's
// cudaError_t (0 = ok). The caller validates shapes, dtypes, devices and
// strides.
extern "C" int uniter_mha_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* out_lo,
                              void* lse, void* lse_lo, int B,
                              int S, int H, int D, long long q_sb,
                              long long q_ss, long long q_sh, long long k_sb,
                              long long k_ss, long long k_sh, long long v_sb,
                              long long v_ss, long long v_sh, float sm_scale,
                              unsigned thr, float inv_keep,
                              unsigned long long seed,
                              unsigned long long row_base, int heads_total,
                              int head0, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 || D > 128 || (dtype == 0 && out_lo != nullptr) ||
      (dtype == 1 && lse_lo != nullptr) || (lse_lo && !lse) || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const float*>(bias),
                    static_cast<float*>(out), static_cast<float*>(lse),
                    static_cast<float*>(lse_lo), S, H, D,
                    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                    sm_scale, inv_keep, thr, seed, row_base, heads_total,
                    head0};
    if (D <= 16) return launch_tf32<16>(a, B, st);
    if (D <= 32) return launch_tf32<32>(a, B, st);
    if (D <= 64) return launch_tf32<64>(a, B, st);
    return launch_tf32<128>(a, B, st);
  }
  const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const float*>(bias),
                 static_cast<bf16*>(out), static_cast<bf16*>(out_lo),
                 static_cast<float*>(lse), S, H, D,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 sm_scale, inv_keep, thr, seed, row_base, heads_total, head0};
  if (D <= 16) return launch_tc<16>(a, B, st);
  if (D <= 32) return launch_tc<32>(a, B, st);
  if (D <= 64) return launch_tc<64>(a, B, st);
  return launch_tc<128>(a, B, st);
}
