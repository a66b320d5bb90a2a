// K3-K6 and K8: the fused dropout + residual + LayerNorm tails and the
// standalone LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernels of uniter_tpu/ops/fused_block.py:
//   K3 `_fwd_kernel`          y  = LN(dropout(x) + res) * w + b
//   K4 `_bwd_kernel`          dx, dres, dw, db of K3 (mask replayed, LN
//                             statistics recomputed)
//   K5 `_ln_drop_fwd_kernel`  y  = dropout(LN(x) * w + b)
//   K6 `_ln_drop_bwd_kernel`  dx, dw, db of K5
// and the forward kernel of uniter_tpu/ops/layer_norm.py:
//   K8 `_ln_fwd_kernel`       y  = LN(x) * w + b   (its backward is plain
//                             tensor code there, and in the port)
// over the last axis of a contiguous [rows, H] tensor (fp32 or bf16; w, b
// fp32), LayerNorm statistics in fp32 by two passes (the mean, then the mean
// of squared deviations, as `_ln_stats` computes them), eps as given.
//
// Dropout: element (r, c) is kept iff word (c % 4) of
//   philox4x32_10(counter = (c / 4, lo32(r), hi32(r), 0), key = seed)
// is >= thr = floor(rate * 2^32), and kept values scale by inv_keep =
// 1 / (1 - rate). That is uniter_tpu_torch/ops/dropout.py `keep_mask(seed, 0,
// shape, rate)` (philox.cuh), so these kernels, their plain versions and the
// plain composition of the trunk drop the same elements from one seed.
// thr == 0 (rate 0) draws no bits.
//
// What bounds them on an H100: bytes. K3 reads x and res and writes y, about
// 4 FLOP and a quarter of a Philox call per element: at (9984, 768) bf16 that
// is 46.0 MB, 13.7 us at 3.35 TB/s. K4 reads x, res, g and writes dx, dres
// (76.7 MB). The plain versions read and write every intermediate (mask
// words, dropped x, the sum, the statistics) in separate passes.
//
// The design for that: one warp per row, four rows per block of 128 threads.
// Lane l owns the columns 4*(l + 32*i) .. +3, i < V (V = ceil(H / 128), a
// template parameter: 6 for H = 768, 8 for H = 1024), so a row lives in
// registers, every load and store is a vector of 4 elements with neighbouring
// lanes on neighbouring addresses, and one Philox call gives a lane all four
// bits of its columns. The row statistics are warp-shuffle sums (all lanes
// end with the same value). Each row is read once and written once.
//
// The backward's dw/db are deterministic: a fixed grid of at most 528 blocks
// (4 per SM) walks the rows in a fixed order; each lane keeps its columns'
// partial sums in registers, the block adds its four warps' partials in
// shared memory in warp order and stores one [H] row of a [2, blocks, H]
// scratch, and a second small kernel adds the scratch over blocks in order.
// No float atomics, so a step replays bit for bit.
//
// K8 is K5's row code with no dropout: the same warp per row, the same
// two-pass statistics, no Philox call. It reads x and writes y (30.7 MB at
// (9984, 768) bf16: 9.2 us at 3.35 TB/s) and also takes the wider rows of the
// task heads (H up to 2048: V up to 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int WARPS = 4;               // rows in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_H = 1024;            // V <= 8
constexpr int MAX_BWD_BLOCKS = 4 * 132;

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}

// w and b: parameters may be views into a flat buffer at any 4-byte offset,
// so they are read element by element (the four loads hit one cache line).
__device__ __forceinline__ void load4_param(const float* p, float (&o)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __ldg(p + j);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<const unsigned*>(&lo);
  a.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The keep bits of columns c .. c+3 of `row`, as bits 0..3.
__device__ __forceinline__ unsigned keep_bits(unsigned long long seed,
                                              long long row, int c,
                                              unsigned thr) {
  const uint4 m = uniter::mask_words(seed, row, c >> 2);
  return (m.x >= thr) | ((m.y >= thr) << 1) | ((m.z >= thr) << 2) |
         ((m.w >= thr) << 3);
}

// Row `row` of t (x, dropped and plus res when kRes), the row's mean and
// 1/sqrt(var + eps); `keep` gets the keep bits (4 per column group) when kRes
// and thr != 0. Columns past H read as 0 and take no part in the sums.
template <typename T, int V, bool kRes>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ res,
                                         long long row, int H, int lane,
                                         unsigned thr, float inv_keep,
                                         unsigned long long seed, float eps,
                                         float (&t)[V][4], unsigned& keep,
                                         float& mean, float& inv) {
  const T* xr = x + row * H;
  float s = 0.f;
  keep = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < H) {
      load4(xr + c, t[i]);
      if (kRes) {
        if (thr) {
          const unsigned kb = keep_bits(seed, row, c, thr);
          keep &= ~(0xfu << (4 * i)) | (kb << (4 * i));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            t[i][j] = (kb >> j) & 1u ? t[i][j] * inv_keep : 0.f;
        }
        float r[4];
        load4(res + row * H + c, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) t[i][j] += r[j];
      }
      s += (t[i][0] + t[i][1]) + (t[i][2] + t[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) t[i][j] = 0.f;
    }
  }
  mean = warp_sum(s) / static_cast<float>(H);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < H) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = t[i][j] - mean;
        q = fmaf(d, d, q);
      }
    }
  }
  inv = rsqrtf(warp_sum(q) / static_cast<float>(H) + eps);
}

template <typename T, int V, bool kRes>
__global__ void __launch_bounds__(THREADS)
tail_fwd(const T* __restrict__ x, const T* __restrict__ res,
         const float* __restrict__ w, const float* __restrict__ b,
         T* __restrict__ y, long long rows, int H, unsigned thr,
         float inv_keep, unsigned long long seed, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float t[V][4];
  unsigned keep;
  float mean, inv;
  load_row<T, V, kRes>(x, res, row, H, lane, thr, inv_keep, seed, eps, t,
                       keep, mean, inv);
  T* yr = y + row * H;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < H) {
      float wv[4], bv[4], o[4];
      load4_param(w + c, wv);
      load4_param(b + c, bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = (t[i][j] - mean) * inv * wv[j] + bv[j];
      if (!kRes && thr) {
        const unsigned kb = keep_bits(seed, row, c, thr);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = (kb >> j) & 1u ? o[j] * inv_keep : 0.f;
      }
      store4(yr + c, o);
    }
  }
}

// K8: y = LN(x) * w + b, one warp per row; draws no random bits.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      long long rows, int H, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float t[V][4];
  unsigned keep;
  float mean, inv;
  load_row<T, V, false>(x, nullptr, row, H, lane, 0u, 1.f, 0ull, eps, t, keep,
                        mean, inv);
  T* yr = y + row * H;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < H) {
      float wv[4], bv[4], o[4];
      load4_param(w + c, wv);
      load4_param(b + c, bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = (t[i][j] - mean) * inv * wv[j] + bv[j];
      store4(yr + c, o);
    }
  }
}

// dx (and dres when kRes) per row; per-block partial dw/db into
// part[0][blockIdx.x][:] and part[1][blockIdx.x][:].
template <typename T, int V, bool kRes>
__global__ void __launch_bounds__(THREADS)
tail_bwd(const T* __restrict__ x, const T* __restrict__ res,
         const float* __restrict__ w, const T* __restrict__ g,
         T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ part,
         long long rows, int H, unsigned thr, float inv_keep,
         unsigned long long seed, float eps) {
  __shared__ float red[2][WARPS][MAX_H];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_h = 1.f / static_cast<float>(H);
  float dw[V][4], db[V][4];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dw[i][j] = db[i][j] = 0.f;

  for (long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
       row < rows; row += static_cast<long long>(gridDim.x) * WARPS) {
    float t[V][4];
    unsigned keep;
    float mean, inv;
    load_row<T, V, kRes>(x, res, row, H, lane, thr, inv_keep, seed, eps, t,
                         keep, mean, inv);
    // t <- x_hat; gv <- g (masked for K6); sums of g*w and g*w*x_hat
    float gv[V][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 4 * (lane + 32 * i);
      if (c < H) {
        float wv[4];
        load4(g + row * H + c, gv[i]);
        load4_param(w + c, wv);
        if (!kRes && thr) {
          const unsigned kb = keep_bits(seed, row, c, thr);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            gv[i][j] = (kb >> j) & 1u ? gv[i][j] * inv_keep : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[i][j] = (t[i][j] - mean) * inv;
          const float gw = gv[i][j] * wv[j];
          s1 += gw;
          s2 = fmaf(gw, t[i][j], s2);
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_h;
    const float m2 = warp_sum(s2) * inv_h;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 4 * (lane + 32 * i);
      if (c < H) {
        float wv[4], d[4];
        load4_param(w + c, wv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j] = inv * ((gv[i][j] * wv[j] - m1) - t[i][j] * m2);
          dw[i][j] = fmaf(gv[i][j], t[i][j], dw[i][j]);
          db[i][j] += gv[i][j];
        }
        if (kRes) {
          store4(dres + row * H + c, d);
          if (thr) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              d[j] = (keep >> (4 * i + j)) & 1u ? d[j] * inv_keep : 0.f;
          }
        }
        store4(dx + row * H + c, d);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < H) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[0][warp][c + j] = dw[i][j];
        red[1][warp][c + j] = db[i][j];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += THREADS) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[k][wi][c];
      part[(static_cast<long long>(k) * gridDim.x + blockIdx.x) * H + c] = s;
    }
  }
}

// out[k][c] = sum over blocks, in block order, of part[k][blk][c].
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, int n_blocks, int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * H) return;
  const int k = idx / H, c = idx - k * H;
  const float* p = part + static_cast<long long>(k) * n_blocks * H + c;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) s += p[static_cast<long long>(blk) * H];
  out[idx] = s;
}

int fwd_blocks(long long rows) {
  return static_cast<int>((rows + WARPS - 1) / WARPS);
}

int bwd_blocks(long long rows) {
  const long long n = (rows + WARPS - 1) / WARPS;
  return static_cast<int>(n < MAX_BWD_BLOCKS ? n : MAX_BWD_BLOCKS);
}

template <typename T, int V, bool kRes>
int launch_fwd(const void* x, const void* res, const void* w, const void* b,
               void* y, long long rows, int H, unsigned thr, float inv_keep,
               unsigned long long seed, float eps, cudaStream_t st) {
  tail_fwd<T, V, kRes><<<fwd_blocks(rows), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, H, thr, inv_keep, seed, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool kRes>
int launch_bwd(const void* x, const void* res, const void* w, const void* g,
               void* dx, void* dres, void* part, void* dwdb, long long rows,
               int H, unsigned thr, float inv_keep, unsigned long long seed,
               float eps, cudaStream_t st) {
  const int nblk = bwd_blocks(rows);
  tail_bwd<T, V, kRes><<<nblk, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(dres), static_cast<float*>(part),
      rows, H, thr, inv_keep, seed, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(2 * H + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dwdb), nblk, H);
  return static_cast<int>(cudaGetLastError());
}

// V = 2 for H <= 256, 6 for H <= 768, 8 for H <= 1024.
template <bool kRes, typename T>
int fwd_v(const void* x, const void* res, const void* w, const void* b,
          void* y, long long rows, int H, unsigned thr, float inv_keep,
          unsigned long long seed, float eps, cudaStream_t st) {
  if (H <= 256)
    return launch_fwd<T, 2, kRes>(x, res, w, b, y, rows, H, thr, inv_keep, seed, eps, st);
  if (H <= 768)
    return launch_fwd<T, 6, kRes>(x, res, w, b, y, rows, H, thr, inv_keep, seed, eps, st);
  return launch_fwd<T, 8, kRes>(x, res, w, b, y, rows, H, thr, inv_keep, seed, eps, st);
}

template <bool kRes, typename T>
int bwd_v(const void* x, const void* res, const void* w, const void* g,
          void* dx, void* dres, void* part, void* dwdb, long long rows, int H,
          unsigned thr, float inv_keep, unsigned long long seed, float eps,
          cudaStream_t st) {
  if (H <= 256)
    return launch_bwd<T, 2, kRes>(x, res, w, g, dx, dres, part, dwdb, rows, H,
                                  thr, inv_keep, seed, eps, st);
  if (H <= 768)
    return launch_bwd<T, 6, kRes>(x, res, w, g, dx, dres, part, dwdb, rows, H,
                                  thr, inv_keep, seed, eps, st);
  return launch_bwd<T, 8, kRes>(x, res, w, g, dx, dres, part, dwdb, rows, H,
                                thr, inv_keep, seed, eps, st);
}

constexpr int LN_MAX_H = 2048;         // K8 alone: V <= 16

template <typename T, int V>
int launch_ln(const void* x, const void* w, const void* b, void* y,
              long long rows, int H, float eps, cudaStream_t st) {
  layer_norm_fwd_kernel<T, V><<<fwd_blocks(rows), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), rows, H, eps);
  return static_cast<int>(cudaGetLastError());
}

// V = 2, 6, 8, 12, 16 for H <= 256, 768, 1024, 1536, 2048.
template <typename T>
int ln_v(const void* x, const void* w, const void* b, void* y, long long rows,
         int H, float eps, cudaStream_t st) {
  if (H <= 256) return launch_ln<T, 2>(x, w, b, y, rows, H, eps, st);
  if (H <= 768) return launch_ln<T, 6>(x, w, b, y, rows, H, eps, st);
  if (H <= 1024) return launch_ln<T, 8>(x, w, b, y, rows, H, eps, st);
  if (H <= 1536) return launch_ln<T, 12>(x, w, b, y, rows, H, eps, st);
  return launch_ln<T, 16>(x, w, b, y, rows, H, eps, st);
}

bool bad_shape(long long rows, int H) {
  return rows < 1 || H < 4 || H > MAX_H || H % 4 != 0;
}

}  // namespace

// Plain C entries for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, res, g,
// and the outputs dx, dres, y); w, b and dw/db are float32. All tensors are
// contiguous [rows, H] with 16-byte aligned rows (w, b [H], 4-byte aligned). thr =
// floor(rate * 2^32) (0: no dropout), inv_keep = 1 / (1 - rate). The
// backward's `part` is a float32 scratch of [2, min(ceil(rows / 4), 528), H]
// and `dwdb` a float32 [2, H] output (dw, then db). Each returns the launch's
// cudaError_t (0 = ok); the caller validates shapes, dtypes and devices.

extern "C" int uniter_drop_res_ln_fwd(const void* x, const void* res,
                                      const void* w, const void* b, void* y,
                                      long long rows, int H, unsigned thr,
                                      float inv_keep, unsigned long long seed,
                                      float eps, int dtype, void* stream) {
  if (bad_shape(rows, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_v<true, float>(x, res, w, b, y, rows, H, thr, inv_keep, seed, eps, st);
  if (dtype == 1)
    return fwd_v<true, __nv_bfloat16>(x, res, w, b, y, rows, H, thr, inv_keep, seed, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int uniter_drop_res_ln_bwd(const void* x, const void* res,
                                      const void* w, const void* g, void* dx,
                                      void* dres, void* part, void* dwdb,
                                      long long rows, int H, unsigned thr,
                                      float inv_keep, unsigned long long seed,
                                      float eps, int dtype, void* stream) {
  if (bad_shape(rows, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_v<true, float>(x, res, w, g, dx, dres, part, dwdb, rows, H, thr,
                              inv_keep, seed, eps, st);
  if (dtype == 1)
    return bwd_v<true, __nv_bfloat16>(x, res, w, g, dx, dres, part, dwdb, rows,
                                      H, thr, inv_keep, seed, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int uniter_ln_drop_fwd(const void* x, const void* w, const void* b,
                                  void* y, long long rows, int H, unsigned thr,
                                  float inv_keep, unsigned long long seed,
                                  float eps, int dtype, void* stream) {
  if (bad_shape(rows, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_v<false, float>(x, nullptr, w, b, y, rows, H, thr, inv_keep, seed, eps, st);
  if (dtype == 1)
    return fwd_v<false, __nv_bfloat16>(x, nullptr, w, b, y, rows, H, thr, inv_keep, seed,
                                       eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int uniter_ln_drop_bwd(const void* x, const void* w, const void* g,
                                  void* dx, void* part, void* dwdb,
                                  long long rows, int H, unsigned thr,
                                  float inv_keep, unsigned long long seed,
                                  float eps, int dtype, void* stream) {
  if (bad_shape(rows, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_v<false, float>(x, nullptr, w, g, dx, nullptr, part, dwdb, rows, H,
                               thr, inv_keep, seed, eps, st);
  if (dtype == 1)
    return bwd_v<false, __nv_bfloat16>(x, nullptr, w, g, dx, nullptr, part, dwdb,
                                       rows, H, thr, inv_keep, seed, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8. x and y contiguous [rows, H] of `dtype`, 16-byte aligned rows; w, b
// float32 [H]; H a multiple of 4 up to 2048.
extern "C" int uniter_layer_norm_fwd(const void* x, const void* w,
                                     const void* b, void* y, long long rows,
                                     int H, float eps, int dtype,
                                     void* stream) {
  if (rows < 1 || H < 4 || H > LN_MAX_H || H % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ln_v<float>(x, w, b, y, rows, H, eps, st);
  if (dtype == 1) return ln_v<__nv_bfloat16>(x, w, b, y, rows, H, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
