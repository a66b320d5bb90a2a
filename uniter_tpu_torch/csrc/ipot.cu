// K7: the IPOT transport plan of the word-region alignment loss for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_ipot_kernel` of uniter_tpu/ops/ot.py (reached
// through `ipot_pallas`): for each example, `iteration` proximal-point steps
// of `k` Sinkhorn updates each, from T0 = (A > 0) and sigma0,
//   Q     = A * T                                   [N, M]
//   delta = 1 / (l_y * (Q sigma) + y_mask)          [N]   (k times, with
//   sigma = 1 / (l_x * (Q^T delta) + x_mask)        [M]    the line below)
//   T     = (delta * Q) * sigma
// all fp32, forward only (the plan carries no gradient). A = exp(-C^T / beta)
// zeroed at joint padding, sigma0, the masks (1e4 at padding) and the lengths
// (>= 1) are made by the caller, as the TPU kernel's are.
//
// What bounds it on an H100: neither bytes nor operations. A is read once and
// T written once (3.9 MB at B=48, N=64, M=160: 1.2 us at 3.35 TB/s), the loop
// does about 7 FLOP per element and step (0.17 GFLOP: 2.6 us at 67 TFLOP/s).
// The time goes into 50 dependent steps of two reductions along different
// axes, each ended by a block-wide barrier; the plain version pays for them
// with some ten launches and four passes over [B, N, M] in device memory per
// step.
//
// The design for that: one block of 512 threads per example runs the whole
// loop in one launch, and A and T stay in shared memory between the steps
// (row-major [N][M]; Q is recomputed where it is read, never stored).
//   * Q sigma sums along a row: one warp per row, lanes on neighbouring
//     columns, a shuffle tree at the end.
//   * Q^T delta sums down a column: one thread per column walks the N rows in
//     order (neighbouring threads on neighbouring banks).
//   * The update of T is folded into the next step's row pass (the warp that
//     owns row n rewrites it with the old delta[n] and the current sigma
//     before it sums it), so a step is two passes over the tile and two
//     barriers; a last pass writes T to device memory.
// Every sum has a fixed order and there are no atomics, so a launch repeats
// bit for bit. Divisions are IEEE (no fast-math flag).
//
// Three forms, chosen by the caller from N * M and the block's shared-memory
// limit (232,448 bytes on an H100, opted into per launch):
//   form 0: A and T in shared memory          (8 N M + 8 (N + M) bytes fit);
//   form 1: A in shared memory, T in its output buffer in device memory;
//   form 2: A read from device memory, T in its output buffer.
// Forms 1 and 2 run the same loop; the block's own writes to T are ordered
// by the barriers that already separate the passes.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <bool kASmem, bool kTSmem>
__global__ void __launch_bounds__(THREADS)
ipot_kernel(const float* __restrict__ gA, const float* __restrict__ sigma0,
            const float* __restrict__ x_mask, const float* __restrict__ y_mask,
            const float* __restrict__ x_len, const float* __restrict__ y_len,
            float* gT, int N, int M, int iteration, int k) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long ex = blockIdx.x;
  const int NM = N * M;
  gA += ex * NM;
  gT += ex * NM;

  float* sp = smem;
  float* sA = sp;
  if (kASmem) sp += NM;
  float* sT = sp;
  if (kTSmem) sp += NM;
  float* sigma = sp;
  float* delta = sigma + M;
  float* xm = delta + N;
  float* ym = xm + M;
  const float* A = kASmem ? sA : gA;
  float* T = kTSmem ? sT : gT;
  const float xl = x_len[ex];
  const float yl = y_len[ex];

  for (int i = tid; i < NM; i += THREADS) {
    const float a = gA[i];
    if (kASmem) sA[i] = a;
    T[i] = a > 0.f ? 1.f : 0.f;  // joint padding stays 0 through the loop
  }
  for (int m = tid; m < M; m += THREADS) {
    sigma[m] = sigma0[ex * M + m];
    xm[m] = x_mask[ex * M + m];
  }
  for (int n = tid; n < N; n += THREADS) {
    delta[n] = 0.f;
    ym[n] = y_mask[ex * N + n];
  }
  __syncthreads();

  for (int it = 0; it < iteration; ++it) {
    for (int kk = 0; kk < k; ++kk) {
      // The previous step's T = (delta * Q) * sigma, then delta from Q sigma.
      const bool update = it > 0 && kk == 0;
      for (int n = warp; n < N; n += WARPS) {
        const float* a_row = A + n * M;
        float* t_row = T + n * M;
        const float d_old = delta[n];
        float acc = 0.f;
        for (int m = lane; m < M; m += 32) {
          const float a = a_row[m];
          const float s = sigma[m];
          float t = t_row[m];
          if (update) {
            t = (d_old * (a * t)) * s;
            t_row[m] = t;
          }
          acc = fmaf(a * t, s, acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) delta[n] = 1.0f / (yl * acc + ym[n]);
      }
      __syncthreads();
      // sigma from Q^T delta
      for (int m = tid; m < M; m += THREADS) {
        float acc = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n)
          acc = fmaf(A[n * M + m] * T[n * M + m], delta[n], acc);
        sigma[m] = 1.0f / (xl * acc + xm[m]);
      }
      __syncthreads();
    }
  }

  // the last step's T, into device memory
  if (iteration > 0 && k > 0) {
    for (int i = tid; i < NM; i += THREADS) {
      const int n = i / M;
      gT[i] = (delta[n] * (A[i] * T[i])) * sigma[i - n * M];
    }
  } else if (kTSmem) {
    for (int i = tid; i < NM; i += THREADS) gT[i] = T[i];
  }
}

template <bool kASmem, bool kTSmem>
int launch(const float* A, const float* sigma0, const float* x_mask,
           const float* y_mask, const float* x_len, const float* y_len,
           float* T, int B, int N, int M, int iteration, int k,
           size_t smem_bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ipot_kernel<kASmem, kTSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ipot_kernel<kASmem, kTSmem><<<B, THREADS, smem_bytes, st>>>(
      A, sigma0, x_mask, y_mask, x_len, y_len, T, N, M, iteration, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. A and T are contiguous float32 [B, N, M]; sigma0
// and x_mask [B, M]; y_mask [B, N]; x_len and y_len [B]. `form` is 0, 1 or 2
// (see the head of this file); the caller picks the first whose shared memory
// fits the device's opt-in limit. Returns the launch's cudaError_t (0 = ok).
extern "C" int uniter_ipot(const void* A, const void* sigma0,
                           const void* x_mask, const void* y_mask,
                           const void* x_len, const void* y_len, void* T,
                           int B, int N, int M, int iteration, int k,
                           int form, void* stream) {
  if (B < 1 || N < 1 || M < 1 || iteration < 0 || k < 0 || form < 0 ||
      form > 2 || static_cast<long long>(N) * M > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t tiles = form == 0 ? 2 : (form == 1 ? 1 : 0);
  const size_t smem_bytes =
      (tiles * static_cast<size_t>(N) * M + 2 * (static_cast<size_t>(N) + M)) *
      sizeof(float);
  const float* a = static_cast<const float*>(A);
  const float* s0 = static_cast<const float*>(sigma0);
  const float* xm = static_cast<const float*>(x_mask);
  const float* ym = static_cast<const float*>(y_mask);
  const float* xl = static_cast<const float*>(x_len);
  const float* yl = static_cast<const float*>(y_len);
  float* t = static_cast<float*>(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0)
    return launch<true, true>(a, s0, xm, ym, xl, yl, t, B, N, M, iteration, k,
                              smem_bytes, st);
  if (form == 1)
    return launch<true, false>(a, s0, xm, ym, xl, yl, t, B, N, M, iteration,
                               k, smem_bytes, st);
  return launch<false, false>(a, s0, xm, ym, xl, yl, t, B, N, M, iteration, k,
                              smem_bytes, st);
}
