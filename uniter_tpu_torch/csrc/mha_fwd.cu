// K1: fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel uniter_tpu/ops/attention.py `_mha_fwd_kernel`
// (launched by `_mha_pallas_raw`, with `_attn_probs`) at dropout rate 0:
//
//     out[b, i, h, :] = softmax_j(q[b,i,h,:] . k[b,j,h,:] * sm_scale + bias[b,j]) @ v[b, :, h, :]
//
// q, k, v are read in their [B, S, H, D] layout through strides (the
// innermost dimension contiguous), so the caller transposes nothing; the
// output is a fresh contiguous [B, S, H, D] tensor. bias is the additive
// fp32 padding bias [B, S] (0 for a valid key, -10000 for padding).
//
// What bounds it on an H100. Inference runs fp32 (the inference drivers pin
// dtype=float32), and the precision contract (1e-5 against the plain version)
// rules out TF32 tensor cores, so the products run on the SIMT FP32 units
// (67 TFLOP/s at 700 W). At the main path's S=104, D=64 one (b, h) pair
// reads 3*S*D*4 = 80 KB and does 4*S*S*D = 2.8 MFLOP, about 34 FLOP per
// byte, above the card's SIMT ridge (~20 FLOP/B): the FMA rate, and the
// shared-memory bandwidth that feeds it, are the limit. The plain version
// additionally writes and re-reads the [B, H, S, S] fp32 score and
// probability tensors in device memory.
//
// The design for that. One block of 256 threads per (64-query tile, head,
// batch element) walks the keys in tiles of 64 with an fp32 online softmax,
// so scores and probabilities stay on the SM. Q and K tiles are stored
// transposed in shared memory and each thread owns a 4x4 register tile of
// scores (rows 4*ty.., keys 4*tx..), so two 16-byte shared loads feed 16
// FMAs; P.V reuses the same scheme with P transposed through shared memory.
// Making it faster (wgmma on bf16, TMA, double-buffered tiles) is later work.
//
// Numerics, as the reference computes them (`_attn_probs`):
//   * scores in fp32 (bf16 inputs are widened on load), sm_scale applied to
//     q.k before the bias is added;
//   * max-subtraction; padded keys (-10000) take part in the softmax with
//     weight exp(-10000 - max), so a row whose keys are all padding comes out
//     as the uniform average over all S keys, never NaN or zero;
//   * keys past S inside the last tile are absent, not padding: their score
//     is -inf and their weight exactly 0;
//   * expf (not __expf) so the fp32 result stays within 1e-5;
//   * the reference normalises P, rounds it to v.dtype and then forms P.V;
//     this kernel keeps the unnormalised P in fp32, accumulates P.V in fp32
//     and divides by the row sum at the end. In fp32 that differs by rounding
//     only; in bf16 it skips the reference's rounding of P to bf16, so bf16
//     results are compared at their own tolerance.
// Dropout on P (and the backward, K2) arrive with the training slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int LDQ = BQ + 4;     // pitch of the transposed Q tile [D][LDQ]
constexpr int LDK = BK + 4;     // pitch of the transposed K tile [D][LDK]
constexpr int LDP = BQ + 4;     // pitch of the transposed P tile [BK][LDP]
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int MAX_CG = 2;       // groups of 4 output columns per thread (D <= 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               T* __restrict__ out, int S, int H, int D,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               float sm_scale) {
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int S, int H, int D,
           long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh,
           float sm_scale, cudaStream_t stream) {
  const int smem = (D * LDQ + D * LDK + BK * D + BK * LDP) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  mha_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), S, H, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements (torch's convention). Returns the launch's cudaError_t (0 = ok).
// The caller validates shapes, dtypes, devices and strides.
extern "C" int uniter_mha_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int B, int S,
                              int H, int D, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, float sm_scale, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, out, B, S, H, D, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, out, B, S, H, D, q_sb, q_ss,
                                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                 sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
