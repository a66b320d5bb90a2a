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
// picked by dtype, both one pass on the tensor cores:
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
// * fp32 (the fp32 train step, the 2-layer fp32 gates):
//   `mha_bwd_tf32_kernel<DP>`, the same one-pass design on the TF32 tensor
//   cores (mma.sync m16n8k8), every product split three ways as K1's
//   (mma.cuh `split_tf32`: a_lo b_hi, a_hi b_lo, then a_hi b_hi into one
//   partial of at most 64 products, added in IEEE fp32). The function moves
//   7 * B*S*H*D * 4 bytes (64.1 us at the flagship) against 10 * B*H*S^2*D
//   FLOP (48.3 us at 495 / 3 TFLOP/s): bytes bound it. P =
//   exp((s - LSE) - LSE_lo) from K1's fp32 LSE and its remainder (exact to
//   fp32 also on a row whose keys are all padding, with its LSE near
//   -10000), Di = rowsum(g * out) from K1's fp32 output itself. Four warps
//   a block, each owning 16 keys of the key tile and their dK, dV in fp32
//   registers; operands split as they are loaded (fp32 fragments are twice
//   bf16's registers), 246 registers at D = 64 with no spill. Latency, not
//   the tensor cores, limits it at one warp an SMSP, so a block keeps 90 KB
//   of shared memory and two blocks share an SM: K_j, V_j and one Q_i, g_i
//   tile as fp32 by cp.async on a pitch of DP + 4 floats (every fragment
//   load conflict-free), the next Q/g tile streaming in behind the dQ
//   product; dS stored query-major in an fp32 [64][72] tile (the 64-bit
//   paired loads of the dQ product's A are conflict-free on a pitch of
//   8 mod 32); dQ in an fp32 device scratch the block alone owns. P_d and
//   dS go from the score accumulators straight into the
//   dV and dK products as A fragments (paired k-slots, mma.cuh). Where
//   B*H pairs cannot fill two blocks an SM (B = 8, S = 512: 96 of 264
//   slots) the key tiles split into groups, a block each, each adding its
//   own dQ, and `dq_sum_kernel` adds the groups in their order. No atomics:
//   a replay is bitwise equal. It replaces a SIMT pair (a pass recomputing
//   the row statistics and dQ, a pass for dK and dV) that shared a
//   [3, B, H, S] scratch.
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

constexpr int TC_THREADS = 128;  // 4 warps x 16 keys (dK, dV) or 16 queries (dQ)

// ---- fp32: one pass on the TF32 tensor cores, three passes a product ----

constexpr int LDSF = 64 + 8;  // pitch of the fp32 dS tile [64 queries][LDSF]

struct F32Args {
  const float *q, *k, *v, *g, *out;
  const float *bias, *lse, *lse_lo;
  float *dq, *dk, *dv;
  float* dq_acc;  // [G][B*H][S_pad][DP + 4] fp32 in device memory
  int B, S, H, D;
  int G;  // key-tile groups, one block each per (b, h)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  float sm_scale, inv_keep;
  unsigned thr;
  unsigned long long seed;
  unsigned long long row_base;  // the mask row of score row 0 (philox.cuh)
  int heads_total, head0;  // head h of the launch is head0 + h of these
};

// dynamic shared memory of mha_bwd_tf32_kernel<DP> (mirrored by
// ops/attention.py `_bwd_smem`): 90,112 bytes at D = 64, S = 104, so two
// blocks share an SM
template <int DP>
int tf32_smem(int S) {
  const int s_pad = (S + 63) / 64 * 64;
  return 4 * 64 * (DP + 4) * 4     // K, V, Q, g
         + 64 * LDSF * 4           // dS
         + 3 * s_pad * 4           // LSE, its remainder, Di
         + 64 * 2 * 4;             // the tile's dropout bits
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS, 2) mha_bwd_tf32_kernel(F32Args a) {
  constexpr int LD = DP + 4;  // fp32 tile pitch; also the dQ pitch
  constexpr int NDT = DP / 8;
  const int S = a.S, D = a.D;
  const int s_pad = (S + 63) / 64 * 64, ntile = s_pad / 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // the mask row's head: head h of the launch is head0 + h of heads_total
  const long long mbh = static_cast<long long>(b) * a.heads_total + a.head0 + h;
  const int j0 = z * ntile / a.G, j1 = (z + 1) * ntile / a.G;  // key tiles

  extern __shared__ uint4 smem_f[];
  // this group's dQ accumulator, [s_pad][LD]
  float* dqa = a.dq_acc + (z * static_cast<long long>(a.B) * a.H + bh) * s_pad * LD;
  float* lse_s = reinterpret_cast<float*>(smem_f);          // [s_pad]
  float* lo_s = lse_s + s_pad;                              // [s_pad]
  float* di_s = lo_s + s_pad;                               // [s_pad]
  unsigned* mask_s = reinterpret_cast<unsigned*>(di_s + s_pad);  // [64][2]
  float* ks = reinterpret_cast<float*>(mask_s + 128);       // [64][LD]
  float* vs = ks + 64 * LD;                                 // [64][LD]
  float* qt = vs + 64 * LD;                                 // [64][LD]
  float* gt = qt + 64 * LD;                                 // [64][LD]
  float* dss = gt + 64 * LD;                                // [64][LDSF] dS

  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* gb = a.g + b * a.g_sb + h * a.g_sh;
  const float* biasb = a.bias + static_cast<long long>(b) * S;

  // the first Q/g tile streams in during the prologue
  uniter::stage_rows_f32<DP>(qt, qb, a.q_ss, 0, S, D);
  uniter::stage_rows_f32<DP>(gt, gb, a.g_ss, 0, S, D);
  uniter::cp_async_commit();

  // prologue: LSE, its remainder and Di = rowsum(g * out) in fp32 from K1's
  // fp32 output (0 on rows past S, whose q and g tiles are zero, so they
  // add nothing anywhere); dQ = 0
  for (int r = tid; r < s_pad; r += TC_THREADS) {
    float lse = 0.f, lo = 0.f, di = 0.f;
    if (r < S) {
      lse = a.lse[bh * S + r];
      lo = a.lse_lo[bh * S + r];
      const float* gr = gb + r * a.g_ss;
      const float* orow = a.out + ((static_cast<long long>(b) * S + r) * a.H + h) * D;
      for (int d = 0; d < D; d += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(gr + d);
        const float4 ov = *reinterpret_cast<const float4*>(orow + d);
        di = fmaf(gv.x, ov.x, di);
        di = fmaf(gv.y, ov.y, di);
        di = fmaf(gv.z, ov.z, di);
        di = fmaf(gv.w, ov.w, di);
      }
    }
    lse_s[r] = lse;
    lo_s[r] = lo;
    di_s[r] = di;
  }
  for (int idx = tid; idx < s_pad * LD; idx += TC_THREADS) dqa[idx] = 0.f;

  const int total = (j1 - j0) * ntile;
  int n = 0;  // (key tile, query tile) step
  for (int j = j0; j < j1; ++j) {
    const int k0 = j * 64;
    __syncthreads();  // K_{j-1}, V_{j-1} and dS are read; the prologue is done
    uniter::stage_rows_f32<DP>(ks, kb, a.k_ss, k0, S, D);
    uniter::stage_rows_f32<DP>(vs, vb, a.v_ss, k0, S, D);
    uniter::cp_async_commit();

    // this warp's keys: rows kr0 and kr0 + 8 of the tile
    const int kr0 = 16 * warp + (lane >> 2);
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
      const int q0 = i * 64;
      // the bits' last readers passed the previous step's dS barrier
      if (a.thr) {  // the tile's mask: thread t draws query t/2, keys 32 (t%2) ..
        const int ql = tid >> 1, half = tid & 1;
        const long long row = static_cast<long long>(a.row_base) + mbh * S + q0 + ql;
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
      uniter::cp_async_wait<0>();  // Q_i, g_i (and at i = 0 K_j, V_j)
      __syncthreads();

      // S^T = K Q^T and dP^T = V g^T: keys kr0 (+8), queries 8 t + 2c + {0,1}
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
      uniter::add_rows_product<8, DP>(st, ks, 16 * warp, qt, LD, lane);
      uniter::add_rows_product<8, DP>(dpt, vs, 16 * warp, gt, LD, lane);

      // P = exp(s - LSE), P_d, dS = P (dPm - Di) sm_scale in registers;
      // dS also to shared memory, query-major, for the dQ product
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * t + 2 * c + e;
          const float lse = lse_s[q0 + ql], lo = lo_s[q0 + ql];
          const float di = di_s[q0 + ql];
          const unsigned bits = a.thr ? mask_s[ql * 2 + (warp >> 1)] : 0u;
#pragma unroll
          for (int u = 0; u < 2; ++u) {  // key rows kr0 + 8u
            const float p =
                lk[u] ? expf((fmaf(st[t][2 * u + e], a.sm_scale, bk[u]) - lse) - lo) : 0.f;
            float pd = p, dpm = dpt[t][2 * u + e];
            if (a.thr) {
              const bool keep = (bits >> ((kr0 + 8 * u) & 31)) & 1u;
              pd = keep ? p * a.inv_keep : 0.f;
              dpm = keep ? dpm * a.inv_keep : 0.f;
            }
            st[t][2 * u + e] = pd;
            const float ds = p * (dpm - di) * a.sm_scale;
            dpt[t][2 * u + e] = ds;
            dss[ql * LDSF + kr0 + 8 * u] = ds;
          }
        }
      }

      // dV += P_d^T g_i, then dK += dS^T Q_i: A from the accumulators
      // (paired k-slots: queries), B down paired rows of g_i and Q_i
      uniter::add_acc_product<NDT>(dv, st, gt, LD, lane);
      uniter::add_acc_product<NDT>(dk, dpt, qt, LD, lane);
      __syncthreads();  // dS of every warp is in shared memory; Q_i, g_i read
      if (n + 1 < total) {  // the next step's Q/g (the next j wraps to 0)
        const int qn = (i + 1 < ntile ? i + 1 : 0) * 64;
        uniter::stage_rows_f32<DP>(qt, qb, a.q_ss, qn, S, D);
        uniter::stage_rows_f32<DP>(gt, gb, a.g_ss, qn, S, D);
        uniter::cp_async_commit();
      }

      // dQ rows q0 + 16 warp + g (+8) += dS K_j: A = dS (rows: queries,
      // paired k-slots: keys), B = K_j down paired rows
      float tq[NDT][4];
#pragma unroll
      for (int t = 0; t < NDT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) tq[t][e] = 0.f;
      uniter::add_paired_product<NDT>(tq, dss, LDSF, 16 * warp, ks, LD, lane);
      const int qr = q0 + 16 * warp + (lane >> 2);
#pragma unroll
      for (int t = 0; t < NDT; ++t) {
        const int col = 8 * t + 2 * c;
        float2* r0 = reinterpret_cast<float2*>(dqa + qr * LD + col);
        float2* r1 = reinterpret_cast<float2*>(dqa + (qr + 8) * LD + col);
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
          *reinterpret_cast<float2*>(a.dk + o + col) =
              make_float2(dk[t][2 * u], dk[t][2 * u + 1]);
          *reinterpret_cast<float2*>(a.dv + o + col) =
              make_float2(dv[t][2 * u], dv[t][2 * u + 1]);
        }
      }
    }
  }
  if (a.G > 1) return;  // dq_sum_kernel adds the groups' dQ
  __syncthreads();  // every warp's dQ rows are summed
  for (int idx = tid; idx < S * (D / 4); idx += TC_THREADS) {
    const int r = idx / (D / 4), col = 4 * (idx - r * (D / 4));
    *reinterpret_cast<float4*>(
        a.dq + ((static_cast<long long>(b) * S + r) * a.H + h) * D + col) =
        *reinterpret_cast<const float4*>(dqa + r * LD + col);
  }
}

// dq = the sum of the G key groups' dQ accumulators, in group order (a
// fixed order: a replay is bitwise equal); 4 floats a thread
template <int DP>
__global__ void __launch_bounds__(256) dq_sum_kernel(F32Args a) {
  constexpr int LD = DP + 4;
  const int D4 = a.D / 4, s_pad = (a.S + 63) / 64 * 64;
  const long long n = static_cast<long long>(a.B) * a.S * a.H * D4;
  const long long plane = static_cast<long long>(a.B) * a.H * s_pad * LD;
  for (long long idx = blockIdx.x * 256ll + threadIdx.x; idx < n;
       idx += static_cast<long long>(gridDim.x) * 256) {
    const int col = 4 * static_cast<int>(idx % D4);
    const long long row = idx / D4;  // (b, s, h)
    const int h = static_cast<int>(row % a.H);
    const long long bs = row / a.H;
    const int r = static_cast<int>(bs % a.S), b = static_cast<int>(bs / a.S);
    const float* p =
        a.dq_acc + ((static_cast<long long>(b) * a.H + h) * s_pad + r) * LD + col;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int z = 1; z < a.G; ++z) {
      const float4 x = *reinterpret_cast<const float4*>(p + z * plane);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(a.dq + row * a.D + col) = acc;
  }
}

template <int DP>
int launch_tf32(const F32Args& a, cudaStream_t stream) {
  const int smem = tf32_smem<DP>(a.S);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_tf32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_tf32_kernel<DP><<<dim3(a.H, a.B, a.G), TC_THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.G == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(a.B) * a.S * a.H * (a.D / 4);
  const int blocks = static_cast<int>(n / 256 < 4096 ? (n + 255) / 256 : 4096);
  dq_sum_kernel<DP><<<blocks, 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: one pass on the tensor cores ----------------------------------

using bf16 = __nv_bfloat16;

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
  unsigned long long row_base;  // the mask row of score row 0 (philox.cuh)
  int heads_total, head0;  // head h of the launch is head0 + h of these
};

// dynamic shared memory of mha_bwd_tc_kernel<DP> (mirrored by
// ops/attention.py `_bwd_smem`)
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
  // the mask row's head: head h of the launch is head0 + h of heads_total
  const long long mbh = static_cast<long long>(b) * a.heads_total + a.head0 + h;

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
        const long long row = static_cast<long long>(a.row_base) + mbh * S + q0 + ql;
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
// dropout), inv_keep = 1 / (1 - rate). Both dtypes run one pass on the
// tensor cores from the forward's contiguous [B, S, H, D] output `out` and
// its [B, H, S] fp32 row log-sum-exp `lse`. dtype 0 = float32: `lse_lo`
// the LSE's fp32 remainder, `out_lo` null. dtype 1 = bfloat16: `out_lo`
// the output's bf16 remainder, `lse_lo` null. `scratch` is a
// [groups, B * H, S_pad, DP + 4] fp32 buffer for dQ in fp32, `groups` the
// key-tile groups (blocks per (b, h), 1..S_pad / 64); in bf16 `groups` is 1
// and `scratch` null (dQ in shared memory) or a [B * H, S_pad, DP + 8] one
// (ops/attention.py `_bwd_smem` says when). Returns the first launch error (0 = ok). The caller validates
// shapes, dtypes, devices and strides (16-byte aligned bases and strides).
extern "C" int uniter_mha_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* bias, const void* out, const void* out_lo, const void* lse,
    const void* lse_lo, void* dq, void* dk,
    void* dv, void* scratch, int B, int S, int H, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long g_sb, long long g_ss, long long g_sh, float sm_scale,
    unsigned thr, float inv_keep, unsigned long long seed,
    unsigned long long row_base, int heads_total, int head0, int dtype,
    int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out == nullptr || lse == nullptr || D % 8 || D > 128 || dtype < 0 ||
      dtype > 1 || (dtype == 0) != (out_lo == nullptr) ||
      (dtype == 0) != (lse_lo != nullptr) ||
      (dtype == 0 && (scratch == nullptr || groups < 1 ||
                      groups > (S + 63) / 64)) ||
      (dtype == 1 && groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const float*>(g),
                    static_cast<const float*>(out), static_cast<const float*>(bias),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(lse_lo), static_cast<float*>(dq),
                    static_cast<float*>(dk), static_cast<float*>(dv),
                    static_cast<float*>(scratch), B, S, H, D, groups, q_sb,
                    q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss,
                    g_sh, sm_scale, inv_keep, thr, seed, row_base, heads_total,
                    head0};
    if (D <= 16) return launch_tf32<16>(a, st);
    if (D <= 32) return launch_tf32<32>(a, st);
    if (D <= 64) return launch_tf32<64>(a, st);
    return launch_tf32<128>(a, st);
  }
  const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                 static_cast<const bf16*>(out), static_cast<const bf16*>(out_lo),
                 static_cast<const float*>(bias),
                 static_cast<const float*>(lse), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<float*>(scratch), B, S, H, D, q_sb, q_ss, q_sh,
                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
                 sm_scale, inv_keep, thr, seed, row_base, heads_total, head0};
  if (D <= 16) return launch_tc<16>(a, st);
  if (D <= 32) return launch_tc<32>(a, st);
  if (D <= 64) return launch_tc<64>(a, st);
  return launch_tc<128>(a, st);
}
