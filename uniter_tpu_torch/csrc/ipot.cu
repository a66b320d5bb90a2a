// K7: the IPOT transport plan of the word-region alignment loss for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_ipot_kernel` of uniter_tpu/ops/ot.py together
// with the XLA work `ipot_pallas` does around it: one launch computes the
// whole of `ipot_pallas`. For each example, from the masked cost C [M, N],
// the lengths, the pads and the joint padding as the caller has them,
//   l_x, l_y = max(len, 1);  x_mask, y_mask = 1e4 at padding, else 0
//   A     = exp(-C^T / beta), 0 at joint padding   [N, M]
//   sigma = 1 / l_x off x padding, else 0         [M]
//   Q     = A                         (T0 = 1 off joint padding)
// then `iteration` proximal-point steps of `k` Sinkhorn updates each,
//   delta = 1 / (l_y * (Q sigma) + y_mask)          [N]   (k times, with
//   sigma = 1 / (l_x * (Q^T delta) + x_mask)        [M]    the line below)
//   T     = (delta * Q) * sigma;  Q = A * T         (the next step's Q)
// and the plan T [N, M], exactly 0 at joint padding. All fp32, forward only
// (the plan carries no gradient); divisions are IEEE and the exponential is
// `expf` (no fast-math flag), as the plain version's.
//
// What bounds it on an H100: neither bytes nor operations. C is read once
// and T written once (3.9 MB at B=48, N=64, M=160: 1.2 us at 3.35 TB/s), the
// loop does about 7 FLOP per element and step (0.17 GFLOP: 2.6 us at 67
// TFLOP/s). The time goes into 50 dependent steps of two reductions along
// different axes: the loop is bound by latency and by the instruction rate
// of the one SM that holds an example.
//
// The design for that: one block of 512 threads (16 warps) per example runs
// the whole loop. Warp w owns rows {w, w + 16, ...} of the plan and lane l
// columns {l, l + 32, ...}, so every element has one owner thread for the
// whole launch, and only the vectors cross threads.
//   * Register form (form 0, N <= 128 and M <= 160, every bucket of
//     pretraining): each thread holds its R x C elements of A and Q in
//     registers (R rows in {4, 8}, C columns in {2, 5}; rows and columns
//     past the plan hold zeros, so the loop has no bounds checks). C is read
//     coalesced, 16 loads a thread in flight, into a transposing stage in
//     shared memory whose odd pitch keeps the owners' reads free of bank
//     conflicts. Joint padding is kept as A = -0, which is zero in every
//     product and sum and whose sign bit masks the final plan.
//   * Q sigma: each lane sums its C columns of each of its R rows in order;
//     the warp then reduce-scatters the R row sums over the lanes (each
//     shuffle level halves the rows a lane carries, so R - 1 + 5 - log2 R
//     shuffles in place of 5 R), one division gives the lane's delta, and R
//     shuffles hand every lane all R values. No barrier.
//   * Q^T delta: each lane sums its R rows of each of its C columns in order
//     into a [16][32 C] array of warp partials in shared memory; a barrier;
//     one thread per column adds the 16 partials in warp order and writes
//     sigma; a barrier; each lane reads its C values back. Two barriers a
//     step.
//   * The update T = (delta Q) sigma, Q = A T is done by the owners in
//     registers at the head of the next step; the first step of the loop is
//     compiled without it, so no step branches on it.
//   * Larger plans: the same owners and order, in loops, with A in the
//     caller's workspace in device memory (read once a step, by its owner)
//     and Q in shared memory (form 1: rows of M rounded up to 32, columns
//     XOR-swizzled by the row, so the transposing writes of the first pass
//     and the owners' reads are both free of bank conflicts) or in the output
//     buffer (form 2); the warp partials go through the workspace. A warp
//     takes its rows four at a time, their sums reduce-scattered.
// Every sum has a fixed order and there are no atomics, so a launch repeats
// bit for bit.
//
// Tried on the card and left out (PERF.md §6): a 2-block cluster
// per example, its rows split between the blocks and the column partials
// exchanged through distributed shared memory (the cluster barrier costs more
// than halving a block's instructions saves); one barrier a step, each warp adding the
// partials of its own columns (16 times the shared-memory reads); 8 warps a
// block. All ran slower at (48, 64, 160); a tree in place of the in-order
// sum of the 16 partials gained nothing.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float PAD = 1e4f;          // the masks' value at padding
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may opt into
constexpr int MAX_DEVICES = 64;
constexpr int REG_MAX_N = 128, REG_MAX_M = 160;  // the register form's plans

// The argument block of the entry point, as the caller packs it (ops/_kernels.py
// `IPOT_CALL`): one pointer to it keeps the ctypes call cheap. c: the masked
// cost, float32 [B, M, N]; x_len, y_len: float32 [B]; x_pad [B, M], y_pad
// [B, N], joint [B, M, N]: bool bytes; t: the plan, float32 [B, N, M]; ws: a
// float32 workspace of B * (16 * M + N * M) values for forms 1 and 2 (the
// warp partials, then A), 0 for form 0. All contiguous, on `device`, whose
// `stream` takes the launch.
struct IpotCall {
  unsigned long long c, x_len, y_len, x_pad, y_pad, joint, t, ws;
  int B, N, M, iteration, k, form;
  float beta;
  int device;
  unsigned long long stream;
};
static_assert(sizeof(IpotCall) == 104, "IpotCall is the caller's 104 bytes");

// One example's inputs and output, and its lengths clamped to >= 1.
struct Example {
  const float* cost;           // [M, N]
  const unsigned char* joint;  // [M, N]
  const unsigned char* x_pad;  // [M]
  const unsigned char* y_pad;  // [N]
  float* t;                    // [N, M]
  float xl, yl;
};

__device__ __forceinline__ Example example(const IpotCall& p) {
  const long long ex = blockIdx.x;
  const long long nm = static_cast<long long>(p.N) * p.M;
  Example e;
  e.cost = reinterpret_cast<const float*>(p.c) + ex * nm;
  e.joint = reinterpret_cast<const unsigned char*>(p.joint) + ex * nm;
  e.x_pad = reinterpret_cast<const unsigned char*>(p.x_pad) + ex * p.M;
  e.y_pad = reinterpret_cast<const unsigned char*>(p.y_pad) + ex * p.N;
  e.t = reinterpret_cast<float*>(p.t) + ex * nm;
  e.xl = fmaxf(reinterpret_cast<const float*>(p.x_len)[ex], 1.f);
  e.yl = fmaxf(reinterpret_cast<const float*>(p.y_len)[ex], 1.f);
  return e;
}

// A = exp(-c / beta); joint padding is -0.
__device__ __forceinline__ float plan_a(float c, unsigned char jp,
                                        float beta) {
  return jp ? -0.0f : expf(-c / beta);
}

__device__ __forceinline__ bool masked(float a) {
  return __float_as_uint(a) >> 31;
}

// sigma0 and x_mask for the example's columns.
__device__ __forceinline__ void init_columns(const Example& e, int M,
                                             float* sig, float* xmask) {
  for (int m = threadIdx.x; m < M; m += THREADS) {
    const bool pad = e.x_pad[m];
    xmask[m] = pad ? PAD : 0.f;
    sig[m] = pad ? 0.f : 1.0f / e.xl;
  }
}

// sigma = 1 / (l_x (Q^T delta) + x_mask), each column's 16 warp partials
// (rows of `pitch` values) added in warp order.
__device__ __forceinline__ void column_sigma(const float* part, int pitch,
                                             const float* xmask, float* sig,
                                             int M, float xl) {
  for (int m = threadIdx.x; m < M; m += THREADS) {
    float s = part[m];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += part[w * pitch + m];
    sig[m] = 1.0f / (xl * s + xmask[m]);
  }
}

// The reduce-scatter of R = 2^p row sums over a warp: at level j (lane bit
// o = 16 >> j) a lane keeps half of the rows it carries and receives its
// partner's partials of them, so after p levels it carries one row, r(lane)
// = sum over j of h_j where lane bit o_j is set (h_j = R >> (j + 1)); the
// remaining 5 - p levels add across the lanes that carry the same row. Every
// lane of a row ends with the same sum (each addition is commutative).
template <int R>
__device__ __forceinline__ float row_sums(float (&v)[R], int lane) {
#pragma unroll
  for (int h = R / 2, o = 16; h >= 1; h /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = 16 / R; o > 0; o /= 2) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// r(lane) of `row_sums`, and a lane that carries row r.
template <int R>
__device__ __forceinline__ int lane_row(int lane) {
  int r = 0;
#pragma unroll
  for (int h = R / 2, o = 16; h >= 1; h /= 2, o /= 2)
    if (lane & o) r += h;
  return r;
}

template <int R>
__device__ __forceinline__ int row_lane(int r) {
  int lane = 0;
#pragma unroll
  for (int h = R / 2, o = 16; h >= 1; h /= 2, o /= 2)
    if (r & h) lane += o;
  return lane;
}

// A = exp(-C^T / beta) of every element, handed to put(n, m, a). C and the
// joint padding are read along n (coalesced), 16 loads a thread in flight.
template <typename Put>
__device__ __forceinline__ void make_a(const Example& e, int N, int M,
                                       float beta, Put put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m0 = warp; m0 < M; m0 += 4 * WARPS)
    for (int n0 = lane; n0 < N; n0 += 4 * 32) {
      float cb[4][4];
      unsigned char jb[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int m = m0 + j * WARPS, n = n0 + 32 * t;
          const bool in = m < M && n < N;
          cb[j][t] = in ? e.cost[m * N + n] : 0.f;
          jb[j][t] = in ? e.joint[m * N + n] : 1;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int m = m0 + j * WARPS, n = n0 + 32 * t;
          if (m < M && n < N) put(n, m, plan_a(cb[j][t], jb[j][t], beta));
        }
    }
}

// The register form's state: the thread's R x C elements of A and Q, the
// sigma of its columns and the delta of its rows.
template <int R, int C>
struct Tile {
  float a[R][C], q[R][C], s[C], d[R];
};

// One Sinkhorn update of the register form: delta from Q sigma (after the
// proximal step T = (delta Q) sigma, Q = A T when kUpdate), sigma from
// Q^T delta. Rows past N hold zeros and count as padding (ym_l), so they
// add nothing; columns past M hold zeros, and their sigma stays 0.
template <bool kUpdate, int R, int C>
__device__ __forceinline__ void reg_step(Tile<R, C>& x, float* part,
                                         float* sig, const float* xmask,
                                         int M, int SP, float xl, float yl,
                                         float ym_l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (kUpdate) x.q[r][c] = x.a[r][c] * ((x.d[r] * x.q[r][c]) * x.s[c]);
      v[r] = fmaf(x.q[r][c], x.s[c], v[r]);
    }
  }
  const float d_l = 1.0f / (yl * row_sums<R>(v, lane) + ym_l);
#pragma unroll
  for (int r = 0; r < R; ++r) x.d[r] = __shfl_sync(FULL, d_l, row_lane<R>(r));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float pc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) pc = fmaf(x.q[r][c], x.d[r], pc);
    part[warp * SP + lane + 32 * c] = pc;
  }
  __syncthreads();
  column_sigma(part, SP, xmask, sig, M, xl);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) x.s[c] = sig[lane + 32 * c];
}

// Form 0: A and Q of the thread's R x C elements in registers.
template <int R, int C>
__global__ void __launch_bounds__(THREADS, 1)
ipot_reg_kernel(const IpotCall p) {
  extern __shared__ float smem[];
  constexpr int SP = 32 * C;  // the vectors' pitch: every lane's columns
  const int N = p.N, M = p.M, PN = N | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Example e = example(p);
  float* stage = smem;           // A as C is laid out: [M][PN]
  float* part = stage + M * PN;  // [WARPS][SP]
  float* sig = part + WARPS * SP;
  float* xmask = sig + SP;

  make_a(e, N, M, p.beta,
         [&](int n, int m, float a) { stage[m * PN + n] = a; });
  init_columns(e, M, sig, xmask);
  for (int m = M + threadIdx.x; m < SP; m += THREADS) sig[m] = 0.f;
  __syncthreads();

  Tile<R, C> x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = warp + WARPS * r;
    x.d[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int m = lane + 32 * c;
      x.a[r][c] = (n < N && m < M) ? stage[m * PN + n] : 0.f;
      x.q[r][c] = x.a[r][c];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) x.s[c] = sig[lane + 32 * c];
  // y_mask of the row this lane's delta comes from (rows past N count as
  // padding, so their delta stays finite)
  const int n_l = warp + WARPS * lane_row<R>(lane);
  const float ym_l = (n_l < N && !e.y_pad[n_l]) ? 0.f : PAD;

  for (int it = 0; it < p.iteration; ++it) {
    if (it == 0)
      reg_step<false>(x, part, sig, xmask, M, SP, e.xl, e.yl, ym_l);
    else
      reg_step<true>(x, part, sig, xmask, M, SP, e.xl, e.yl, ym_l);
    for (int kk = 1; kk < p.k; ++kk)
      reg_step<false>(x, part, sig, xmask, M, SP, e.xl, e.yl, ym_l);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = warp + WARPS * r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int m = lane + 32 * c;
      if (n < N && m < M) {
        const float t =
            p.iteration > 0 ? (x.d[r] * x.q[r][c]) * x.s[c] : 1.f;
        e.t[n * M + m] = masked(x.a[r][c]) ? 0.f : t;
      }
    }
  }
}

// Forms 1 and 2: A in the workspace, Q in shared memory (kQSmem: rows of M
// rounded up to 32, columns XOR-swizzled by the row) or in the output
// buffer, the warp partials in the workspace. A warp takes its rows four at
// a time, their row sums reduce-scattered as in the register form.
template <bool kQSmem>
__global__ void __launch_bounds__(THREADS, 1)
ipot_mem_kernel(const IpotCall p) {
  extern __shared__ float smem[];
  const int N = p.N, M = p.M, PM = (M + 31) & ~31;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ex = blockIdx.x;
  const Example e = example(p);
  float* ws = reinterpret_cast<float*>(p.ws);
  float* part = ws + ex * WARPS * M;  // [WARPS][M]
  float* A = ws + static_cast<long long>(p.B) * WARPS * M + ex * N * M;
  float* Q = kQSmem ? smem : e.t;
  float* sig = smem + (kQSmem ? N * PM : 0);
  float* xmask = sig + M;
  float* delta = xmask + M;
  float* ymask = delta + N;
  auto at = [&](int n, int m) {
    return kQSmem ? n * PM + (m ^ (n & 31)) : n * M + m;
  };

  make_a(e, N, M, p.beta, [&](int n, int m, float a) {
    A[n * M + m] = a;
    Q[at(n, m)] = a;
  });
  init_columns(e, M, sig, xmask);
  for (int n = threadIdx.x; n < N; n += THREADS) {
    delta[n] = 0.f;
    ymask[n] = e.y_pad[n] ? PAD : 0.f;
  }
  __syncthreads();

  for (int it = 0; it < p.iteration; ++it) {
    for (int kk = 0; kk < p.k; ++kk) {
      const bool update = it > 0 && kk == 0;
      for (int n0 = warp; n0 < N; n0 += 4 * WARPS) {
        float v[4], dn[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j * WARPS;
          dn[j] = n < N ? delta[n] : 0.f;
          v[j] = 0.f;
        }
#pragma unroll 4
        for (int m = lane; m < M; m += 32) {
          const float s = sig[m];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + j * WARPS;
            if (n < N) {
              float q = Q[at(n, m)];
              if (update) {
                q = A[n * M + m] * ((dn[j] * q) * s);
                Q[at(n, m)] = q;
              }
              v[j] = fmaf(q, s, v[j]);
            }
          }
        }
        const float rs = row_sums<4>(v, lane);
        const int n_l = n0 + WARPS * lane_row<4>(lane);
        if ((lane & 7) == 0 && n_l < N)
          delta[n_l] = 1.0f / (e.yl * rs + ymask[n_l]);
      }
      __syncwarp();
#pragma unroll 4
      for (int m = lane; m < M; m += 32) {
        float pc = 0.f;
        for (int n = warp; n < N; n += WARPS)
          pc = fmaf(Q[at(n, m)], delta[n], pc);
        part[warp * M + m] = pc;
      }
      __syncthreads();
      column_sigma(part, M, xmask, sig, M, e.xl);
      __syncthreads();
    }
  }

  for (int n = warp; n < N; n += WARPS)
    for (int m = lane; m < M; m += 32) {
      const float t =
          p.iteration > 0 ? (delta[n] * Q[at(n, m)]) * sig[m] : 1.f;
      e.t[n * M + m] = masked(A[n * M + m]) ? 0.f : t;
    }
}

using Kernel = void (*)(const IpotCall);

// One launch of `kernel`, its shared-memory limit raised once per device.
template <Kernel kernel>
int launch(const IpotCall& p, int smem_bytes) {
  static bool opted[MAX_DEVICES] = {};
  if (!opted[p.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[p.device] = true;
  }
  kernel<<<p.B, THREADS, smem_bytes,
           reinterpret_cast<cudaStream_t>(p.stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

long long smem_bytes(const IpotCall& p) {
  const long long N = p.N, M = p.M;
  if (p.form == 0) {  // the vectors' pitch 32 C covers M
    const long long sp = M <= 64 ? 64 : 160;
    return 4 * (M * (N | 1) + WARPS * sp + 2 * sp);
  }
  const long long vecs = 2 * (M + N);
  if (p.form == 1) return 4 * (N * ((M + 31) & ~31LL) + vecs);
  return 4 * vecs;
}

int run(const IpotCall& p) {
  const long long smem = smem_bytes(p);
  if (p.B < 1 || p.N < 1 || p.M < 1 || p.iteration < 0 || p.k < 1 ||
      p.form < 0 || p.form > 2 || p.device < 0 || p.device >= MAX_DEVICES ||
      static_cast<long long>(p.N) * p.M > (1LL << 30) || smem > SMEM_LIMIT ||
      (p.form == 0 && (p.N > REG_MAX_N || p.M > REG_MAX_M)) ||
      (p.form > 0 && p.ws == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(smem);
  if (p.form == 1) return launch<ipot_mem_kernel<true>>(p, bytes);
  if (p.form == 2) return launch<ipot_mem_kernel<false>>(p, bytes);
  if (p.N <= 64)
    return p.M <= 64 ? launch<ipot_reg_kernel<4, 2>>(p, bytes)
                     : launch<ipot_reg_kernel<4, 5>>(p, bytes);
  return p.M <= 64 ? launch<ipot_reg_kernel<8, 2>>(p, bytes)
                   : launch<ipot_reg_kernel<8, 5>>(p, bytes);
}

}  // namespace

// Plain C entry for ctypes: one `IpotCall` (see above), launched on its
// device (the caller's current device is left as it was). `form` is what
// ops/ot.py `ipot_form` gives for N, M: 0 for N <= 128 and M <= 160, else 1
// where A fits the block's shared memory, else 2. Returns the launch's
// cudaError_t (0 = ok); the caller validates shapes, dtypes and devices.
extern "C" int uniter_ipot(const void* call) {
  IpotCall p;
  std::memcpy(&p, call, sizeof p);  // the block may sit at any alignment
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != p.device && (err = cudaSetDevice(p.device)) != cudaSuccess)
    return static_cast<int>(err);
  const int rc = run(p);
  if (cur != p.device) cudaSetDevice(cur);
  return rc;
}
