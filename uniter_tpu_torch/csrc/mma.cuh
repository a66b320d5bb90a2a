// Tensor-core building blocks of the bf16 attention kernels (mha_fwd.cu,
// mha_bwd.cu): 16-byte cp.async staging, ldmatrix and the m16n8k16 bf16
// mma.sync with fp32 accumulators, as inline PTX (no CUTLASS include, so a
// source still builds in seconds).
//
// Fragment layouts of mma.m16n8k16 (lane l, group g = l / 4, c = l % 4):
//   A (16 x 16, row): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//                     a3 (g+8, 2c+8..)
//   B (16 x 8, col):  b0 (k 2c..2c+1, n g), b1 (k 2c+8.., n g)
//   C (16 x 8):       c0,c1 (g, 2c..2c+1), c2,c3 (g+8, 2c..2c+1)
// so the C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one 16-deep k-step: a score tile feeds the next product from
// registers. Two bf16 values pack into one 32-bit register, the lower
// column in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uniter {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
// (rows past S, head-dim padding) and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores (bf16 inputs, exact products, fp32 sums)
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) rounded to bf16, x0 in the low half
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// x = hi + lo + O(2^-16 |x|): hi = bf16(x), lo = bf16(x - hi). Two products
// (hi and lo) carry an fp32 operand through the bf16 tensor cores.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// rows r0..r0+63 of x (row stride ss, in elements) into a [64][DP + 8] bf16
// tile by 16-byte cp.async; rows past S and columns past D come out zero, so
// absent keys and queries and the head-dim padding add exactly nothing. x and
// ss must be 16-byte aligned (the wrappers check it).
template <int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile,
                                           const __nv_bfloat16* x,
                                           long long ss, int r0, int S,
                                           int D) {
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += blockDim.x) {
    const int r = idx / CH, col = (idx - r * CH) * 8;
    const bool ok = r0 + r < S && col < D;
    cp_async16(tile + r * (DP + 8) + col, ok ? x + (r0 + r) * ss + col : x,
               ok ? 16 : 0);
  }
}

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;

// acc[t] (8-column tile t of DP) += (hi + lo) B for one warp's 16 rows:
// hi/lo the A fragments of 4 k-steps (64 rows of B), B a [64][DP + 8] bf16
// tile read by ldmatrix.trans. The 64-term product is one tensor-core
// partial per tile, all tiles in flight at once, added in IEEE fp32.
template <int DP>
__device__ __forceinline__ void add_split_product(float acc[][4],
                                                  const unsigned hi[4][4],
                                                  const unsigned lo[4][4],
                                                  const __nv_bfloat16* tile,
                                                  int lane) {
  float part[DP / 8][4];
#pragma unroll
  for (int t = 0; t < DP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[t][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      unsigned bf[4];
      ldsm_x4_t(bf, tile + (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * (DP + 8)
                        + 16 * dp + 8 * (lane >> 4));
      mma_bf16(part[2 * dp], lo[kc], bf[0], bf[1]);
      mma_bf16(part[2 * dp], hi[kc], bf[0], bf[1]);
      mma_bf16(part[2 * dp + 1], lo[kc], bf[2], bf[3]);
      mma_bf16(part[2 * dp + 1], hi[kc], bf[2], bf[3]);
    }
#pragma unroll
  for (int t = 0; t < DP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] += part[t][e];
}

}  // namespace uniter
