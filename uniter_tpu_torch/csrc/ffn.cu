// K9: the fused feed-forward block of a BERT layer for Hopper (sm_90a),
//   y = cast(cast(gelu(x W1^T + b1)) W2^T + b2)
// over x [rows, D_in], W1 [D_mid, D_in] and W2 [D_out, D_mid] (torch's
// Linear layout, [out, in]), both products accumulated in fp32, b1 and b2
// added in fp32, erf-GELU in fp32, the intermediate rounded once to x's
// dtype.
//
// Replaces the TPU kernel `_ffn_fwd_kernel` of uniter_tpu/ops/ffn.py
// (reached through `_ffn_pallas_raw`). What it keeps from it: the
// [rows, D_mid] intermediate lives on chip (shared memory and registers)
// and never reaches device memory.
//
// What bounds it on an H100: operations. At the retrieval train shape
// (rows, H) = (15360, 768), D_mid = 3072, it does 4 rows H D_mid = 1.45e11
// FLOP (147 us at 989 TFLOP/s bf16, 2.16 ms at 67 TFLOP/s fp32) and moves
// ~57 MB in bf16 (x, y, W1, W2: 17 us at 3.35 TB/s).
//
// The design, right and simple first: one block owns a tile of rows and all
// of that tile's D_out output columns, so no block depends on another (no
// atomics, a fixed summation order: a launch repeats bit for bit). The block
// walks D_mid in chunks; for each chunk it computes h = x W1[chunk]^T into
// shared memory in fp32, adds b1, applies GELU and rounds to x's dtype, then
// adds h W2[:, chunk]^T into the tile's fp32 accumulator. The accumulator is
// written once, with b2, at the end.
//   * bf16: 32 rows a block, 16 warps, the products on the tensor cores
//     through `nvcuda::wmma` (16x16x16, fp32 accumulators). The x tile sits
//     in shared memory; the weights' fragments are read straight from device
//     memory (L2 holds both matrices: 9.4 MB at uniter-base), so every block
//     streams all of W1 and W2 once. The accumulator is 2 x D_out / 16
//     fragments spread over the warps (at most 4 column tiles, 64 fp32
//     registers, a warp).
//   * fp32: true fp32 FMA on the CUDA cores (no TF32): 16 rows a block, 256
//     threads; W1 and W2 slices staged through shared memory, transposed, so
//     that neighbouring threads read neighbouring words; each thread keeps
//     16 rows x D_out / 256 columns of the accumulator in registers.
// Neither form is near the bound: the weights are re-read by every block and
// the products run without a pipeline of asynchronous copies.
//
// Ragged row counts are masked (rows past the end read as zero and are not
// written). D_in and D_out are multiples of 16 up to 1024, D_mid a multiple
// of 16; the last chunk of D_mid may be partial. The launch opts into the
// dynamic shared memory it needs (over 48 KB at these widths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int kMaxWidth = 1024;

__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * kInvSqrt2));
}

// ---------------------------------------------------------------- bf16 ----

constexpr int BM = 32;           // rows a block
constexpr int BN = 128;          // D_mid columns a chunk
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = BN + 4;      // fp32 h chunk, row stride (floats)
constexpr int LDB = BN + 8;      // bf16 h chunk, row stride (elements)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int KP = 64;           // products a tensor-core partial sum holds

// acc += part in IEEE fp32. The tensor cores' own fp32 accumulation rounds
// differently (truncating within an instruction); summing at most KP products
// there and the partial sums here keeps the first product close enough to an
// IEEE fp32 sum that h rounds to bf16 as the plain version's does.
__device__ __forceinline__ void promote(FragC& acc, const FragC& part) {
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += part.x[i];
}

size_t bf16_smem_bytes(int d_in) {
  return static_cast<size_t>(BM) * (d_in + 8) * sizeof(bf16) +
         static_cast<size_t>(BM) * LDH * sizeof(float) +
         static_cast<size_t>(BM) * LDB * sizeof(bf16) +
         static_cast<size_t>(WARPS) * 256 * sizeof(float);
}

// NT: output column tiles a warp owns (tile ot = warp + j * WARPS, j < NT).
template <int NT>
__global__ void __launch_bounds__(THREADS)
ffn_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ y,
                long long rows, int d_in, int d_mid, int d_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = d_in + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);                  // [BM][ldx]
  float* hf = reinterpret_cast<float*>(xs + BM * ldx);       // [BM][LDH]
  bf16* hb = reinterpret_cast<bf16*>(hf + BM * LDH);         // [BM][LDB]
  float* scratch = reinterpret_cast<float*>(hb + BM * LDB);  // [WARPS][256]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * BM;
  const int n_out_tiles = d_out / 16;

  // the x tile, 16 bytes a thread, zeros past the last row
  const int vecs = d_in / 8;
  for (int i = tid; i < BM * vecs; i += THREADS) {
    const int r = i / vecs;
    const int c = i - r * vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      v = reinterpret_cast<const uint4*>(x + (r0 + r) * d_in)[c];
    *reinterpret_cast<uint4*>(xs + r * ldx + c * 8) = v;
  }

  FragC acc[2][NT];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[rt][j], 0.0f);
  __syncthreads();

  for (int c0 = 0; c0 < d_mid; c0 += BN) {
    const int cw = min(BN, d_mid - c0);
    // h chunk = x W1[c0 : c0 + cw]^T: one 16x16 tile a warp
    {
      const int rt = warp >> 3;
      const int ct = warp & 7;
      if (ct * 16 < cw) {
        FragC h, part;
        wmma::fill_fragment(h, 0.0f);
        const bf16* a_ptr = xs + rt * 16 * ldx;
        const bf16* b_ptr = w1 + static_cast<long long>(c0 + ct * 16) * d_in;
        for (int k0 = 0; k0 < d_in; k0 += KP) {
          wmma::fill_fragment(part, 0.0f);
          for (int k = k0; k < min(k0 + KP, d_in); k += 16) {
            FragA a;
            FragB b;
            wmma::load_matrix_sync(a, a_ptr + k, ldx);
            wmma::load_matrix_sync(b, b_ptr + k, d_in);
            wmma::mma_sync(part, a, b, part);
          }
          promote(h, part);
        }
        wmma::store_matrix_sync(hf + rt * 16 * LDH + ct * 16, h, LDH,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // + b1, GELU in fp32, one rounding to bf16
    for (int i = tid; i < BM * cw; i += THREADS) {
      const int r = i / cw;
      const int c = i - r * cw;
      hb[r * LDB + c] = __float2bfloat16(gelu(hf[r * LDH + c] + b1[c0 + c]));
    }
    __syncthreads();
    // acc += h W2[:, c0 : c0 + cw]^T, the chunk's sum promoted once
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ot = warp + j * WARPS;
      if (ot >= n_out_tiles) continue;
      FragC p0, p1;
      wmma::fill_fragment(p0, 0.0f);
      wmma::fill_fragment(p1, 0.0f);
      const bf16* b_ptr = w2 + static_cast<long long>(ot) * 16 * d_mid + c0;
      for (int k = 0; k < cw; k += 16) {
        FragA a0, a1;
        FragB b;
        wmma::load_matrix_sync(a0, hb + k, LDB);
        wmma::load_matrix_sync(a1, hb + 16 * LDB + k, LDB);
        wmma::load_matrix_sync(b, b_ptr + k, d_mid);
        wmma::mma_sync(p0, a0, b, p0);
        wmma::mma_sync(p1, a1, b, p1);
      }
      promote(acc[0][j], p0);
      promote(acc[1][j], p1);
    }
    __syncthreads();  // hf and hb are rewritten by the next chunk
  }

  // y = acc + b2, rounded to bf16, through a 16x16 scratch tile a warp
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int ot = warp + j * WARPS;
    if (ot >= n_out_tiles) continue;
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      wmma::store_matrix_sync(sc, acc[rt][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long row = r0 + rt * 16 + (e >> 4);
        const int col = ot * 16 + (e & 15);
        if (row < rows) y[row * d_out + col] = __float2bfloat16(sc[e] + b2[col]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

constexpr int FM = 16;           // rows a block
constexpr int FN = 64;           // D_mid columns a chunk
constexpr int FK1 = 32;          // D_in slice of W1 staged at a time
constexpr int FK2 = 16;          // D_mid slice of W2 staged at a time
constexpr int FTHREADS = 256;

size_t f32_smem_bytes(int d_in, int d_out) {
  return (static_cast<size_t>(FM) * d_in + FK1 * (FN + 1) + FM * FN +
          static_cast<size_t>(FK2) * (d_out + 1)) *
         sizeof(float);
}

// NC: output columns a thread owns (column t + j * FTHREADS, j < NC).
template <int NC>
__global__ void __launch_bounds__(FTHREADS)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ y,
               long long rows, int d_in, int d_mid, int d_out) {
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                        // [FM][d_in]
  float* w1s = xs + FM * d_in;            // [FK1][FN + 1]: W1 slice, transposed
  float* hs = w1s + FK1 * (FN + 1);       // [FM][FN]
  float* w2s = hs + FM * FN;              // [FK2][d_out + 1]: W2 slice, transposed
  const int ldw2 = d_out + 1;

  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * FM;
  for (int i = tid; i < FM * d_in; i += FTHREADS) {
    const int r = i / d_in;
    xs[i] = r0 + r < rows ? x[r0 * d_in + i] : 0.0f;
  }
  float acc[FM][NC];
#pragma unroll
  for (int r = 0; r < FM; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.0f;

  // the h thread: column n of the chunk, rows 4 rg .. 4 rg + 3
  const int n = tid % FN;
  const int rg = tid / FN;

  for (int c0 = 0; c0 < d_mid; c0 += FN) {
    const int cw = min(FN, d_mid - c0);
    float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < d_in; k0 += FK1) {
      const int ks = min(FK1, d_in - k0);
      __syncthreads();  // the previous slice is consumed (and xs written)
      for (int i = tid; i < FN * FK1; i += FTHREADS) {
        const int nn = i / FK1;
        const int kk = i - nn * FK1;
        w1s[kk * (FN + 1) + nn] =
            nn < cw && kk < ks
                ? w1[static_cast<long long>(c0 + nn) * d_in + k0 + kk]
                : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < ks; ++kk) {
        const float w = w1s[kk * (FN + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = fmaf(xs[(rg * 4 + i) * d_in + k0 + kk], w, h[i]);
      }
    }
    if (n < cw) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hs[(rg * 4 + i) * FN + n] = gelu(h[i] + b1[c0 + n]);
    }
    for (int k0 = 0; k0 < cw; k0 += FK2) {
      __syncthreads();  // hs written, the previous W2 slice consumed
      for (int i = tid; i < d_out * FK2; i += FTHREADS) {
        const int c = i / FK2;
        const int kk = i - c * FK2;
        w2s[kk * ldw2 + c] = w2[static_cast<long long>(c) * d_mid + c0 + k0 + kk];
      }
      __syncthreads();
      for (int kk = 0; kk < FK2; ++kk) {
        float hv[FM];
#pragma unroll
        for (int r = 0; r < FM; ++r) hv[r] = hs[r * FN + k0 + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = tid + j * FTHREADS;
          if (c < d_out) {
            const float w = w2s[kk * ldw2 + c];
#pragma unroll
            for (int r = 0; r < FM; ++r) acc[r][j] = fmaf(hv[r], w, acc[r][j]);
          }
        }
      }
    }
    __syncthreads();  // hs is rewritten by the next chunk
  }

#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + j * FTHREADS;
    if (c >= d_out) continue;
    const float bias = b2[c];
#pragma unroll
    for (int r = 0; r < FM; ++r)
      if (r0 + r < rows) y[(r0 + r) * d_out + c] = acc[r][j] + bias;
  }
}

// Opt into the dynamic shared memory, launch on the caller's stream, and
// return the launch's cudaError_t (0 = ok).
template <typename... P, typename... A>
int launch(void (*kernel)(P...), long long grid, int threads, size_t smem,
           cudaStream_t st, A... args) {
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(grid), threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. x [rows, D_in], w1 [D_mid, D_in], w2 [D_out,
// D_mid] and y [rows, D_out] contiguous in one dtype (0 float32, 1 bfloat16;
// bf16 pointers 32-byte aligned), b1 [D_mid] and b2 [D_out] contiguous fp32.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int uniter_ffn_fwd(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y,
                              long long rows, int d_in, int d_mid, int d_out,
                              int dtype, void* stream) {
  if (rows < 1 || d_in < 16 || d_mid < 16 || d_out < 16 || d_in % 16 ||
      d_mid % 16 || d_out % 16 || d_in > kMaxWidth || d_out > kMaxWidth ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype == 1) {
    const long long grid = (rows + BM - 1) / BM;
    const size_t smem = bf16_smem_bytes(d_in);
    const bf16* bx = static_cast<const bf16*>(x);
    const bf16* bw1 = static_cast<const bf16*>(w1);
    const bf16* bw2 = static_cast<const bf16*>(w2);
    bf16* by = static_cast<bf16*>(y);
    switch ((d_out / 16 + WARPS - 1) / WARPS) {
      case 1:
        return launch(ffn_bf16_kernel<1>, grid, THREADS, smem, st, bx, bw1,
                      fb1, bw2, fb2, by, rows, d_in, d_mid, d_out);
      case 2:
        return launch(ffn_bf16_kernel<2>, grid, THREADS, smem, st, bx, bw1,
                      fb1, bw2, fb2, by, rows, d_in, d_mid, d_out);
      case 3:
        return launch(ffn_bf16_kernel<3>, grid, THREADS, smem, st, bx, bw1,
                      fb1, bw2, fb2, by, rows, d_in, d_mid, d_out);
      default:
        return launch(ffn_bf16_kernel<4>, grid, THREADS, smem, st, bx, bw1,
                      fb1, bw2, fb2, by, rows, d_in, d_mid, d_out);
    }
  }
  const long long grid = (rows + FM - 1) / FM;
  const size_t smem = f32_smem_bytes(d_in, d_out);
  const float* fx = static_cast<const float*>(x);
  const float* fw1 = static_cast<const float*>(w1);
  const float* fw2 = static_cast<const float*>(w2);
  float* fy = static_cast<float*>(y);
  switch ((d_out + FTHREADS - 1) / FTHREADS) {
    case 1:
      return launch(ffn_f32_kernel<1>, grid, FTHREADS, smem, st, fx, fw1, fb1,
                    fw2, fb2, fy, rows, d_in, d_mid, d_out);
    case 2:
      return launch(ffn_f32_kernel<2>, grid, FTHREADS, smem, st, fx, fw1, fb1,
                    fw2, fb2, fy, rows, d_in, d_mid, d_out);
    case 3:
      return launch(ffn_f32_kernel<3>, grid, FTHREADS, smem, st, fx, fw1, fb1,
                    fw2, fb2, fy, rows, d_in, d_mid, d_out);
    default:
      return launch(ffn_f32_kernel<4>, grid, FTHREADS, smem, st, fx, fw1, fb1,
                    fw2, fb2, fy, rows, d_in, d_mid, d_out);
  }
}
