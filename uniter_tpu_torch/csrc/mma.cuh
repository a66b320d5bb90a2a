// Tensor-core building blocks of the attention kernels (mha_fwd.cu,
// mha_bwd.cu): 16-byte cp.async staging, ldmatrix and the m16n8k16 bf16
// mma.sync with fp32 accumulators; for fp32 operands the m16n8k8 TF32
// mma.sync with the three-pass split. All inline PTX (no CUTLASS include,
// so a source still builds in seconds).
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
//
// Fragment layouts of mma.m16n8k8 TF32 (one value a register):
//   A (16 x 8, row):  a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4)
//   B (8 x 8, col):   b0 (k c, n g), b1 (k c+4, n g)
//   C (16 x 8):       c0,c1 (g, 2c..2c+1), c2,c3 (g+8, 2c..2c+1)
// The accumulator is not the A layout here. A product's sum over k does not
// care which k a slot stands for, as long as A and B agree, so where A comes
// from an accumulator (P V, P_d^T g, dS^T Q) the kernels let k-slot c stand
// for row 2c of the 8-row k-step and slot c + 4 for row 2c + 1: then
// (c0, c2, c1, c3) of an n-tile is the A fragment of one k-step as it sits
// in registers, and B reads rows 2c and 2c + 1 of its tile ("paired" below).
// Where A comes from shared memory the slots keep their plain meaning.
//
// fp32 tiles in shared memory have a pitch of DP + 4 floats (16-byte rows
// for cp.async). With g*pitch + c (A, and B read along a row) and
// 2c*pitch + g (B read down paired rows) both land on 32 distinct banks for
// a pitch of 4 mod 32, so every 32-bit fragment load is conflict-free.

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

// The fp32 form of stage_rows: rows r0..r0+63 of x into a [64][DP + 4]
// float tile, 4 floats a cp.async; rows past S and columns past D are
// zero. x and ss must be 16-byte aligned (multiples of 4 floats).
template <int DP>
__device__ __forceinline__ void stage_rows_f32(float* tile, const float* x,
                                               long long ss, int r0, int S,
                                               int D) {
  constexpr int CH = DP / 4;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += blockDim.x) {
    const int r = idx / CH, col = (idx - r * CH) * 4;
    const bool ok = r0 + r < S && col < D;
    cp_async16(tile + r * (DP + 4) + col, ok ? x + (r0 + r) * ss + col : x,
               ok ? 16 : 0);
  }
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// the 32-bit pattern the tensor cores read; a raw fp32 word would be
// truncated by the tensor core instead. This is cvt.rna.tf32.f32's rounding
// done on the bits: adding half a TF32 step to the magnitude and clearing
// the 13 low bits, two integer instructions. The instruction adds a guard
// for Inf and NaN that costs as much again; no operand here is either.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The three-pass split: x = hi + lo + O(2^-22 |x|), hi = tf32(x),
// lo = tf32(x - hi). a b = a_lo b_hi + a_hi b_lo + a_hi b_hi carries fp32
// operands through the TF32 tensor cores (the dropped a_lo b_lo and the
// rounding of lo are each at most ~2^-22 |a b|).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b on the tensor cores (TF32 inputs, fp32 sums). Not volatile: it
// has no side effects, so independent products may be scheduled freely.
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b_t for NT n-tiles: a split (hi/lo), b_t = (b[t][0], b[t][1]) raw
// fp32, split here; a_lo b_hi and a_hi b_lo into small[t], then a_hi b_hi
// into part[t] (small may be part itself). Each pass runs over all NT tiles
// before the next, so NT independent accumulators are in flight and no
// product waits on the one before it.
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float part[NT][4],
                                           float small[NT][4],
                                           const unsigned ah[4],
                                           const unsigned al[4],
                                           const float b[NT][2]) {
  unsigned bh[NT][2], bl[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    split_tf32(b[t][0], bh[t][0], bl[t][0]);
    split_tf32(b[t][1], bh[t][1], bl[t][1]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) mma_tf32(small[t], al, bh[t][0], bh[t][1]);
#pragma unroll
  for (int t = 0; t < NT; ++t) mma_tf32(small[t], ah, bl[t][0], bl[t][1]);
#pragma unroll
  for (int t = 0; t < NT; ++t) mma_tf32(part[t], ah, bh[t][0], bh[t][1]);
}

// acc[t] += part[t] (+ small[t], summed first when they are apart)
template <int NT, bool SEP>
__device__ __forceinline__ void add_partials(float acc[NT][4],
                                             const float part[NT][4],
                                             const float small[][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (SEP)
        acc[t][e] += part[t][e] + small[t][e];
      else
        acc[t][e] += part[t][e];
    }
}

// The A fragment of one k-step from 16 rows of a [.][pitch] fp32 tile
// (rows row0 + g, + 8; columns k0 + c, + 4), split.
__device__ __forceinline__ void load_a_tf32(unsigned ah[4], unsigned al[4],
                                            const float* tile, int pitch,
                                            int row0, int k0, int lane) {
  const float* p = tile + (row0 + (lane >> 2)) * pitch + k0 + (lane & 3);
  split_tf32(p[0], ah[0], al[0]);
  split_tf32(p[8 * pitch], ah[1], al[1]);
  split_tf32(p[4], ah[2], al[2]);
  split_tf32(p[8 * pitch + 4], ah[3], al[3]);
}

// acc[nt] (n-tile nt: rows 8 nt.. of a B tile) += A B^T over k = 0..K-1,
// NT n-tiles, for one warp's 16 rows of A: A rows row0.. of tile `a`, B rows
// of tile `b` (both [.][pitch] fp32, k along the row), B's element (k c, n g)
// at b[(8 nt + g) pitch + k]. One tensor-core partial per n-tile for each 64
// columns of k, added to acc in IEEE fp32; the NT chains are in flight at
// once. SEP: the two small passes sum in partials of their own, so the
// tensor cores' truncating fp32 sums of the hi hi pass run over 8 steps a
// partial, not 24 (more registers, a smaller error).
template <int NT, int K, bool SEP = false>
__device__ __forceinline__ void add_rows_product(float acc[NT][4],
                                                 const float* a, int row0,
                                                 const float* b, int pitch,
                                                 int lane) {
  const float* bp = b + (lane >> 2) * pitch + (lane & 3);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 64) {
    float part[NT][4], small[SEP ? NT : 1][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[t][e] = small[SEP ? t : 0][e] = 0.f;
#pragma unroll
    for (int kk = k0; kk < (K < k0 + 64 ? K : k0 + 64); kk += 8) {
      unsigned ah[4], al[4];
      load_a_tf32(ah, al, a, pitch, row0, kk, lane);
      float bv[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        bv[t][0] = bp[8 * t * pitch + kk];
        bv[t][1] = bp[8 * t * pitch + kk + 4];
      }
      if constexpr (SEP)
        mma_3xtf32<NT>(part, small, ah, al, bv);
      else
        mma_3xtf32<NT>(part, part, ah, al, bv);
    }
    add_partials<NT, SEP>(acc, part, small);
  }
}

// acc[t] (output columns 8 t..) += X B for one warp's 16 rows, X the 16 x 64
// fp32 accumulator tiles x[8][4] of a score-shaped product (rows g, g + 8;
// columns 8 nt + 2c, + 1), B a [64][pitch] fp32 tile read down paired rows
// (k-slot c of step nt: row 8 nt + 2c; slot c + 4: row 8 nt + 2c + 1).
// The 64-term sum is one tensor-core partial per output tile (SEP: and one
// for the small passes, as add_rows_product), all NDT tiles in flight,
// added to acc in IEEE fp32.
template <int NDT, bool SEP = false>
__device__ __forceinline__ void add_acc_product(float acc[NDT][4],
                                                const float x[8][4],
                                                const float* b, int pitch,
                                                int lane) {
  const float* bp = b + 2 * (lane & 3) * pitch + (lane >> 2);
  float part[NDT][4], small[SEP ? NDT : 1][4];
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[t][e] = small[SEP ? t : 0][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    unsigned ah[4], al[4];
    split_tf32(x[nt][0], ah[0], al[0]);
    split_tf32(x[nt][2], ah[1], al[1]);
    split_tf32(x[nt][1], ah[2], al[2]);
    split_tf32(x[nt][3], ah[3], al[3]);
    const float* row = bp + 8 * nt * pitch;
    float bv[NDT][2];
#pragma unroll
    for (int t = 0; t < NDT; ++t) {
      bv[t][0] = row[8 * t];
      bv[t][1] = row[pitch + 8 * t];
    }
    if constexpr (SEP)
      mma_3xtf32<NDT>(part, small, ah, al, bv);
    else
      mma_3xtf32<NDT>(part, part, ah, al, bv);
  }
  add_partials<NDT, SEP>(acc, part, small);
}

// acc[t] += A B for one warp's 16 rows of A, A rows row0.. of a [.][a_pitch]
// fp32 tile read as paired k-slots (two adjacent floats a lane: columns
// 8 nt + 2c, + 1; a_pitch 8 mod 32 keeps the 64-bit loads conflict-free),
// B a [64][pitch] tile read down paired rows as in add_acc_product. One
// 64-term partial per output tile, added in IEEE fp32.
template <int NDT>
__device__ __forceinline__ void add_paired_product(float acc[NDT][4],
                                                   const float* a,
                                                   int a_pitch, int row0,
                                                   const float* b, int pitch,
                                                   int lane) {
  const float* ap = a + (row0 + (lane >> 2)) * a_pitch + 2 * (lane & 3);
  const float* bp = b + 2 * (lane & 3) * pitch + (lane >> 2);
  float part[NDT][4];
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[t][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 x0 = *reinterpret_cast<const float2*>(ap + 8 * nt);
    const float2 x1 = *reinterpret_cast<const float2*>(ap + 8 * a_pitch + 8 * nt);
    unsigned ah[4], al[4];
    split_tf32(x0.x, ah[0], al[0]);
    split_tf32(x1.x, ah[1], al[1]);
    split_tf32(x0.y, ah[2], al[2]);
    split_tf32(x1.y, ah[3], al[3]);
    const float* row = bp + 8 * nt * pitch;
    float bv[NDT][2];
#pragma unroll
    for (int t = 0; t < NDT; ++t) {
      bv[t][0] = row[8 * t];
      bv[t][1] = row[pitch + 8 * t];
    }
    mma_3xtf32<NDT>(part, part, ah, al, bv);
  }
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] += part[t][e];
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
