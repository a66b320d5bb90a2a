// Philox4x32-10 for the kernels' dropout masks (attention, fused tails).
//
// The mask bit of score (b, h, q, k) is word (k % 4) of
//   philox4x32_10(counter = (k / 4, lo32(row), hi32(row), 0),
//                 key     = (lo32(seed), hi32(seed))),
//   row = row_base + (b*H_total + h0 + h)*S + q,
// kept iff that word >= threshold = floor(rate * 2^32), with H_total the
// model's heads and h0 the first head of the launch (H_total = H, h0 = 0
// but under tensor parallelism). This is the rule of
// uniter_tpu_torch/ops/dropout.py (`keep_mask` over a [B, H_total, S, S]
// tensor at `row_base`, heads h0... of it), so the plain versions, K1 and K2
// draw the same bits whatever their tiling and head split. The fused tails (fused_tail.cu) take element (r, c) of a
// [rows, H] tensor as row row_base + r, key c of the same rule. The row base
// (passed by value beside the seed) places a rank's block of the batch in the
// global one: b0*H_total*S for attention, b0*S for a tail, b0 the rank's
// first example row.

#pragma once

#include <cuda_runtime.h>

namespace uniter {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four mask words of keys 4*k4 .. 4*k4+3 in score row `row`.
__device__ __forceinline__ uint4 mask_words(unsigned long long seed,
                                            long long row, int k4) {
  const unsigned long long r = static_cast<unsigned long long>(row);
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(k4), static_cast<unsigned>(r),
                 static_cast<unsigned>(r >> 32), 0u),
      static_cast<unsigned>(seed), static_cast<unsigned>(seed >> 32));
}

__device__ __forceinline__ unsigned word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

}  // namespace uniter
