// K9: the fused feed-forward block of a BERT layer for Hopper (sm_90a),
//   y = cast(cast(gelu(x W1^T + b1)) W2^T + b2)
// over x [rows, D_in], W1 [D_mid, D_in] and W2 [D_out, D_mid] (torch's
// Linear layout, [out, in]), both products accumulated in fp32, b1 and b2
// added in fp32, erf-GELU in fp32, the intermediate rounded once to x's
// dtype.
//
// Replaces the TPU kernel `_ffn_fwd_kernel` of uniter_tpu/ops/ffn.py
// (reached through `_ffn_pallas_raw`). What it keeps from it: the
// [rows, D_mid] intermediate lives on chip (registers and shared memory) and
// never reaches device memory.
//
// What bounds it on an H100: operations. At the retrieval train shape
// (rows, H) = (15360, 768), D_mid = 3072, it does 4 rows H D_mid = 1.45e11
// FLOP (147 us at 989 TFLOP/s bf16, 2.16 ms at 67 TFLOP/s fp32) and moves
// ~57 MB in bf16 (x, y, W1, W2: 17 us at 3.35 TB/s).
//
// bf16: `ffn_wgmma_kernel<NUW>`, warpgroup MMAs (`wgmma`) fed by TMA, in
// clusters of two blocks.
//   The budget that sets the layout: the fp32 y accumulator of 64 rows (the
//   least a wgmma takes) by all 768 columns is 64 x 768 x 4 B = 192 KB, 3/4
//   of an SM's 256 KB register file; at 1024 columns it does not fit. So a
//   64-row tile goes to a cluster of two blocks, and block r owns half of
//   D_out (2 NUW 64-column units: 384 columns at H = 768, 512 at 1024).
//   Each block also computes half of every 256-column chunk of h (warpgroup
//   w the 64-column unit v = 2 r + w) and sends its units to the other block
//   by a bulk copy into its shared memory, so every product is computed once
//   and h never leaves the chips' shared memory.
//   * Registers: two consumer warpgroups at 232 a thread and a producer
//     warpgroup cut to 40 by setmaxnreg (256 x 232 + 128 x 40 = 64,512 of
//     65,536). A consumer holds NUW x 32 fp32 y registers (96 at H = 768,
//     128 at 1024), two 32-register tensor-core partials and their
//     32-register fp32 sum: 192 at 768 (ptxas spills 4 bytes), 224 at 1024
//     (more; the `sass` phase of chip_smoke.py prints each instance).
//   * Shared memory at D_in = 768: the x tile (64 x D_in, 96 KB, loaded once
//     by TMA), the h chunk (4 units, 32 KB; two chunks where D_in <= 512),
//     and a ring of 6 weight units a warpgroup (2 x 6 x 8 KB): 230,808 bytes
//     of the 232,448 a block may have. Every weight operand is a 64 x 64
//     unit (8 KB, one TMA box, 128-byte swizzle). One producer warp a ring
//     loads the units in the order they are used, each into the slot its
//     consumers released last (full and empty mbarriers a slot).
//   * Per chunk, warpgroup w: h unit v = x W1[unit]^T over D_in in 64-deep
//     steps, two steps (8 wgmma m64n64k16) a commit group; each step's
//     partial holds 64 products and is added to the sum in IEEE fp32, in
//     order (the tensor cores' own fp32 sums truncate: one accumulator over
//     D_in missed the bf16 tolerance). Then + b1, GELU, one rounding to bf16
//     into the h chunk in the swizzle a wgmma operand wants, and the unit's
//     copy to the other block. Then y[:, own units] += h W2[own units,
//     chunk]^T, one commit group of NUW x 4 wgmma per h unit, its own unit
//     first, accumulating in the tensor cores over D_mid (within the
//     tolerance on the card). The warpgroups and the two blocks meet only
//     at mbarriers (an h unit present; the chunk read by all four
//     warpgroups), so one warpgroup's GELU overlaps the others' MMAs.
//   * Epilogue: + b2 in fp32, one rounding, the tile staged in the
//     warpgroup's own (now idle) ring slots, 16-byte stores.
//   Rows past the end, D_in and D_mid past a multiple of 64 and columns past
//   D_out read as zeros (TMA's out-of-bounds fill) and are not stored.
//
// fp32: `ffn_f32_kernel<NJ>`, true fp32 FMA on the CUDA cores (no TF32).
//   A block owns 32 rows and all D_out columns (NJ x 64 <= 1024); its 256
//   threads are 4 row groups x 64 column lanes, each holding an 8-row x NJ
//   tile of y (columns lane + 64 i: 96 registers at 768) and, per
//   256-column chunk of h, an 8 x 4 tile of h. x and W1 slices (32 deep)
//   and W2 slices (8 deep) are staged by 16-byte cp.async, double-buffered,
//   in [row][k] layouts padded so that a warp's 16-byte reads do not
//   conflict; each 4-deep step is an outer product of registers, the row
//   values read once for the warp (a broadcast) and each weight value used
//   for 8 rows, so that shared memory feeds the FMA units (32 FMA per 12
//   loads for h, 32 NJ per 8 + NJ for y). h (rounded to fp32, i.e. not at
//   all) passes through shared memory.
//
// Both forms: no atomics and a fixed summation order, so a launch repeats
// bit for bit. D_in and D_out are multiples of 16 up to 1024, D_mid a
// multiple of 16, any row count.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int kMaxWidth = 1024;
constexpr int kSmemLimit = 232448;  // 227 KB, a block's dynamic maximum

__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * kInvSqrt2));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- bf16 ----

constexpr int BM = 64;                  // rows a block
constexpr int UNIT = 64;                // columns of a unit (and a TMA box)
constexpr int UNIT_BYTES = UNIT * UNIT * 2;  // 8 KB of bf16
constexpr int WGS = 2;                  // consumer warpgroups a block
constexpr int CLUSTER = 2;              // blocks a row tile (halves of D_out)
// + a producer warpgroup (warp w of it fills ring w; the rest idle): its
// registers, released by setmaxnreg, let a consumer thread hold 232
constexpr int THREADS = 128 * (WGS + 1);
constexpr int HU = WGS * CLUSTER;       // h units a chunk, one a warpgroup
constexpr int HC = UNIT * HU;           // D_mid columns a chunk
constexpr int MAX_STAGES = 8;           // ring slots a warpgroup
// x, the rings' slots full and empty, h units present (2 buffers x HU),
// buffers free (2)
constexpr int BAR_BYTES = 8 * (1 + 2 * WGS * MAX_STAGES + 2 * HU + 2);

size_t bf16_smem_bytes(int ku, int nbuf, int stages) {
  return 1024 +
         static_cast<size_t>(ku + nbuf * HU + WGS * stages) * UNIT_BYTES +
         BAR_BYTES;
}

// h buffers and ring slots a warpgroup gets beside the x tile's ku units:
// a deeper ring beats a second h buffer (at D_in = 768, 6 slots and one
// buffer ran 448 us where 4 slots and two ran 470, NVIDIA H100 80GB HBM3,
// 700 W), so two buffers only where 6 slots remain (D_in <= 512). At least
// 4 slots: the epilogue stages NUW <= 4 units there.
void bf16_plan(int ku, int* nbuf, int* stages) {
  for (int nb = 2; nb >= 1; --nb) {
    const long long left =
        kSmemLimit - static_cast<long long>(bf16_smem_bytes(ku, nb, 0));
    const int s = static_cast<int>(left / (WGS * UNIT_BYTES));
    *nbuf = nb;
    *stages = s < MAX_STAGES ? s : MAX_STAGES;
    if (*stages >= 6) return;
  }
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// `bar` of block `rank` of the cluster (rank may be this block)
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_arrive_cluster(unsigned cbar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cbar)
      : "memory");
}

// one thread's wait for the phase of `bar` with this parity to complete
__device__ __forceinline__ void mbar_wait_lane(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the whole warp's wait, converged after it (the next instruction may be an
// aligned one)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  mbar_wait_lane(bar, parity);
  __syncwarp();
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// one 64 x 64 box at (c0 inner, c1 outer) of `map` into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(bar)
      : "memory");
}

// `bytes` of this block's shared memory at src into another block's at the
// cluster address dst, completing on that block's barrier cbar
__device__ __forceinline__ void copy_to_peer(unsigned dst, unsigned src,
                                             unsigned bytes, unsigned cbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(cbar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma operand: a K-major 64-wide (128-byte) swizzled tile at `addr`
// (1024-byte aligned, rows 128 bytes apart, 8-row groups 1024 apart).
// Moving 16 columns along K adds 32 bytes to the start address.
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<unsigned long long>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until this warp's committed wgmma groups have completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (m64n64, fp32) = [d +] A B^T for one 16-deep step; A and B from shared
// memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32],
                                               unsigned long long da,
                                               unsigned long long db,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d [+]= A[64 x 64] B[64 x 64]^T: four 16-deep steps, 64 products, issued
// into the open wgmma group (the caller fences, commits and waits)
__device__ __forceinline__ void mma_unit(float (&d)[32], unsigned a,
                                         unsigned b, bool accumulate) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_64x64x16(d, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k),
                   accumulate || k > 0);
}

// Byte offset of (row, col) in a 64 x 64 bf16 unit with the 128-byte
// swizzle: 16-byte chunk (col / 8) of row r sits at chunk (col / 8) ^ (r % 8).
__device__ __forceinline__ unsigned sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// NUW: 64-column y units a warpgroup owns. A cluster of two blocks takes a
// row tile (blockIdx.x / 2); block r of it owns the y columns from
// 2 r NUW 64 to 2 (r + 1) NUW 64 and, in every chunk of 256 h columns,
// computes the h units 2 r + w (warpgroup w) and sends them to the other
// block.
template <int NUW>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mw1,
                 const __grid_constant__ CUtensorMap mw2,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 bf16* __restrict__ y, long long rows, int d_mid, int d_out,
                 int ku, int nbuf, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const unsigned xs = base;                            // ku units
  const unsigned hs = xs + ku * UNIT_BYTES;            // nbuf x HU units
  const unsigned ring0 = hs + nbuf * HU * UNIT_BYTES;  // WGS x stages units
  const unsigned bars = ring0 + WGS * stages * UNIT_BYTES;
  const unsigned x_full = bars;

  unsigned r;  // this block's rank in its cluster
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  const unsigned peer = r ^ 1;
  const int tid = threadIdx.x;
  const int w = tid >> 7;   // consumer warpgroup
  const int t = tid & 127;  // thread in it
  const int v = 2 * r + w;  // the h unit of a chunk this warpgroup computes
  const int row0 = static_cast<int>((blockIdx.x / CLUSTER) * BM);
  const int col_base = v * NUW * UNIT;  // first y column owned
  const int nc = (d_mid + HC - 1) / HC;
  const int per_chunk = ku + HU * NUW;  // units through the ring a chunk
  const int total = nc * per_chunk;
  const unsigned ring = ring0 + w * stages * UNIT_BYTES;
  const unsigned full0 = bars + 8 + 8 * w * MAX_STAGES;
  const unsigned empty0 = full0 + 8 * WGS * MAX_STAGES;
  const unsigned hfull = bars + 8 + 16 * WGS * MAX_STAGES;  // [2][HU]
  const unsigned hfree = hfull + 8 * 2 * HU;                // [2]

  if (tid == 0) {
    mbar_init(x_full, 1);
    for (int i = 0; i < 2 * WGS * MAX_STAGES; ++i)
      mbar_init(bars + 8 + 8 * i, 1);
    // h unit u is written here by 128 threads, or arrives from the peer
    // (one local arrival with its bytes)
    for (int i = 0; i < 2 * HU; ++i) {
      const bool here = (i % HU) / WGS == static_cast<int>(r);
      mbar_init(hfull + 8 * i, here ? 128 : 1);
    }
    // a buffer is free once every warpgroup of the cluster has read it
    for (int i = 0; i < 2; ++i) mbar_init(hfree + 8 * i, WGS * CLUSTER);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers exist before either signals one

  if (tid >= 128 * WGS) {
    // A producer warp a ring (warp 8 + w, lane 0) loads the sequence of
    // units through warpgroup w's ring: per chunk c, ku W1 units (h unit v,
    // 64 deep each), then for h unit v ^ uu (its own first) and y unit j the
    // W2 unit (y columns of j) x (chunk columns of the h unit). The n-th
    // unit takes slot n % stages once the consumers have released that
    // slot's previous unit (its `empty` barrier).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pw = (tid - 128 * WGS) >> 5;  // the ring this warp fills
    if (pw < WGS && (tid & 31) == 0) {
      const int pv = 2 * r + pw;
      const int pcol = pv * NUW * UNIT;
      const unsigned pring = ring0 + pw * stages * UNIT_BYTES;
      const unsigned pfull = bars + 8 + 8 * pw * MAX_STAGES;
      const unsigned pempty = pfull + 8 * WGS * MAX_STAGES;
      if (pw == 0) {
        mbar_expect_tx(x_full, ku * UNIT_BYTES);
        for (int k = 0; k < ku; ++k)
          tma_load(xs + k * UNIT_BYTES, &mx, k * UNIT, row0, x_full);
      }
      int pc = 0, pi = 0, ps = 0;
      unsigned eph = 0;  // phase parity of the slot's previous release
      for (int n = 0; n < total; ++n) {
        if (n >= stages) mbar_wait_lane(pempty + 8 * ps, eph);
        const unsigned bar = pfull + 8 * ps;
        const unsigned dst = pring + ps * UNIT_BYTES;
        mbar_expect_tx(bar, UNIT_BYTES);
        if (pi < ku) {
          tma_load(dst, &mw1, pi * UNIT, pc * HC + pv * UNIT, bar);
        } else {
          const int uu = (pi - ku) / NUW;
          const int j = (pi - ku) - uu * NUW;
          tma_load(dst, &mw2, pc * HC + (uu ^ pv) * UNIT, pcol + j * UNIT,
                   bar);
        }
        if (++pi == per_chunk) {
          pi = 0;
          ++pc;
        }
        if (++ps == stages) {
          ps = 0;
          if (n >= stages) eph ^= 1;
        }
      }
    }
    return;  // the consumers' last cluster barrier counts no exited thread
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  int cs = 0;        // slot of the next unit to consume
  unsigned cph = 0;  // and its barrier's phase parity
  auto wait_next = [&]() {
    mbar_wait(full0 + 8 * cs, cph);
    const int slot = cs;
    if (++cs == stages) {
      cs = 0;
      cph ^= 1;
    }
    return slot;
  };
  // the MMAs on these slots have completed (a wait in one warp sees the
  // warpgroup's whole group done): the producer may refill them
  auto release = [&](int slot) {
    if (t == 0) mbar_arrive(empty0 + 8 * slot);
  };

  float yacc[NUW][32];
#pragma unroll
  for (int j = 0; j < NUW; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) yacc[j][e] = 0.f;
  float pa[32], pb[32], hacc[32];  // two 64-product partials, their fp32 sum

  const int warp = t >> 5, lane = t & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // accumulator rows r_lo, +8
  const int c_lo = (lane & 3) * 2;           // columns c_lo + 8 n, +1

  mbar_wait(x_full, 0);
  for (int c = 0; c < nc; ++c) {
    // h unit v of chunk c: two 64-deep steps a group (8 wgmma), each step's
    // partial added to the fp32 sum in order; the other warpgroup's MMAs
    // keep the tensor cores busy while this one waits and adds
    for (int k = 0; k < ku; k += 2) {
      const bool two = k + 1 < ku;
      const int sa = wait_next();
      const int sb = two ? wait_next() : 0;
      fence_regs(pa);
      fence_regs(pb);
      wgmma_fence();
      mma_unit(pa, xs + k * UNIT_BYTES, ring + sa * UNIT_BYTES, false);
      if (two)
        mma_unit(pb, xs + (k + 1) * UNIT_BYTES, ring + sb * UNIT_BYTES, false);
      wgmma_commit();
      wgmma_wait();
      fence_regs(pa);
      fence_regs(pb);
      if (k == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) hacc[e] = pa[e];
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) hacc[e] += pa[e];
      }
      if (two) {
#pragma unroll
        for (int e = 0; e < 32; ++e) hacc[e] += pb[e];
      }
      release(sa);
      if (two) release(sb);
    }
    // + b1, GELU, one rounding, into h buffer c % nbuf, unit v, once every
    // reader in the cluster is done with the buffer's last use; then the
    // unit goes to the peer block by one bulk copy. The warpgroups meet only
    // through mbarriers, so one's GELU overlaps the other's MMAs.
    const int hbuf = c % nbuf;
    const unsigned hpar = (c / nbuf) & 1;
    const unsigned hb = hs + hbuf * HU * UNIT_BYTES;
    if (c >= nbuf) mbar_wait(hfree + 8 * hbuf, hpar ^ 1);
    unsigned char* hunit = gbase + (hb - base) + v * UNIT_BYTES;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int col = (e >> 2) * 8 + c_lo;
      const int row = r_lo + ((e >> 1) & 1) * 8;
      const int g = c * HC + v * UNIT + col;  // d_mid is even: g, g + 1 both in
      const float c0 = g < d_mid ? b1[g] : 0.f;
      const float c1 = g < d_mid ? b1[g + 1] : 0.f;
      *reinterpret_cast<unsigned*>(hunit + sw128_offset(row, col)) =
          pack_bf16(gelu(hacc[e] + c0), gelu(hacc[e + 1] + c1));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned own = hfull + 8 * (hbuf * HU + v);
    mbar_arrive(own);
    if (t == 0) {
      // the peer's warpgroup w sends its unit v ^ 2 here; then, all 128
      // threads' writes in, this unit goes there
      mbar_expect_tx(hfull + 8 * (hbuf * HU + (v ^ 2)), UNIT_BYTES);
      mbar_wait_lane(own, hpar);
      copy_to_peer(cluster_addr(hb + v * UNIT_BYTES, peer),
                   hb + v * UNIT_BYTES, UNIT_BYTES, cluster_addr(own, peer));
    }
    __syncwarp();
    // y[:, own units] += h W2^T: per h unit (its own first), one group over
    // the NUW units
#pragma unroll
    for (int uu = 0; uu < HU; ++uu) {
      const int u = uu ^ v;
      mbar_wait(hfull + 8 * (hbuf * HU + u), hpar);
      int b[NUW];
#pragma unroll
      for (int j = 0; j < NUW; ++j) b[j] = wait_next();
#pragma unroll
      for (int j = 0; j < NUW; ++j) fence_regs(yacc[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NUW; ++j)
        mma_unit(yacc[j], hb + u * UNIT_BYTES, ring + b[j] * UNIT_BYTES, true);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < NUW; ++j) fence_regs(yacc[j]);
#pragma unroll
      for (int j = 0; j < NUW; ++j) release(b[j]);
    }
    if (t == 0) {  // this warpgroup is done with the buffer, in both blocks
      mbar_arrive(hfree + 8 * hbuf);
      mbar_arrive_cluster(cluster_addr(hfree + 8 * hbuf, peer));
    }
    __syncwarp();
  }

  // y = acc + b2, one rounding, staged (swizzled) in this warpgroup's ring,
  // then 16-byte stores of whole rows of a unit
  unsigned char* stage = gbase + (ring - base);
#pragma unroll
  for (int j = 0; j < NUW; ++j)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int col = (e >> 2) * 8 + c_lo;
      const int row = r_lo + ((e >> 1) & 1) * 8;
      const int g = col_base + j * UNIT + col;
      const float c0 = g < d_out ? b2[g] : 0.f;
      const float c1 = g < d_out ? b2[g + 1] : 0.f;
      *reinterpret_cast<unsigned*>(stage + j * UNIT_BYTES +
                                   sw128_offset(row, col)) =
          pack_bf16(yacc[j][e] + c0, yacc[j][e + 1] + c1);
    }
  named_sync(2 + w, 128);
  for (int idx = t; idx < NUW * UNIT * 8; idx += 128) {
    const int j = idx / (UNIT * 8);
    const int row = (idx >> 3) & (UNIT - 1);
    const int ch = idx & 7;
    const long long grow = row0 + row;
    const int g = col_base + j * UNIT + ch * 8;
    if (grow < rows && g < d_out)
      *reinterpret_cast<uint4*>(y + grow * d_out + g) =
          *reinterpret_cast<const uint4*>(stage + j * UNIT_BYTES + row * 128 +
                                          (((ch ^ row) & 7) << 4));
  }
  cluster_sync();  // no block leaves while the other may still signal it
}

// ---------------------------------------------------------------- fp32 ----

constexpr int FM = 32;          // rows a block
constexpr int FT = 256;         // threads: 4 row groups x 64 column lanes
constexpr int FH = 256;         // D_mid columns a chunk
constexpr int FK1 = 32;         // depth of an x / W1 slice
constexpr int FK2 = 8;          // depth of a W2 slice
constexpr int LD1 = FK1 + 4;    // row stride of the x and W1 slices (floats)
constexpr int LD2 = FK2 + 4;    // of the W2 slices
constexpr int LDH = FH + 4;     // of the h chunk

size_t f32_smem_bytes(int nj) {
  return (2 * FM * LD1 + 2 * FH * LD1 + FM * LDH +
          2 * static_cast<size_t>(nj) * 64 * LD2) *
         sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NJ: 64-column groups of y a thread walks (column lane + 64 i, i < NJ).
// Thread (g, lane) = (tid / 64, tid % 64) holds rows 8 g .. 8 g + 7 of y
// and, per chunk, of h (h columns lane + 64 j, j < 4).
template <int NJ>
__global__ void __launch_bounds__(FT, 1)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ y,
               long long rows, int d_in, int d_mid, int d_out) {
  extern __shared__ __align__(16) float fsm[];
  float* const xs = fsm;                   // [2][FM][LD1]
  float* const w1s = xs + 2 * FM * LD1;    // [2][FH][LD1]
  float* const hs = w1s + 2 * FH * LD1;    // [FM][LDH]
  float* const w2s = hs + FM * LDH;        // [2][NJ * 64][LD2]

  const int tid = threadIdx.x;
  const int rg = tid >> 6;    // rows 8 rg .. 8 rg + 7
  const int lane = tid & 63;  // h columns lane + 64 j, y columns lane + 64 i
  const long long r0 = static_cast<long long>(blockIdx.x) * FM;
  const int k1s = (d_in + FK1 - 1) / FK1;
  constexpr int k2s = FH / FK2;
  const int per_chunk = k1s + k2s;
  const int nc = (d_mid + FH - 1) / FH;
  const int total = nc * per_chunk;

  // stage step st into buffer st & 1 of its kind: an x and a W1 slice
  // (first product) or a W2 slice (second product); zeros past the ends
  auto load = [&](int st) {
    const int c = st / per_chunk;
    const int i = st - c * per_chunk;
    const int buf = st & 1;
    if (i < k1s) {
      const int k0 = i * FK1;
      {
        const int r = tid >> 3, v = (tid & 7) * 4;
        const bool ok = r0 + r < rows && k0 + v < d_in;
        cp_async16(xs + (buf * FM + r) * LD1 + v,
                   ok ? x + (r0 + r) * d_in + k0 + v : x, ok);
      }
#pragma unroll
      for (int p = 0; p < FH * 8 / FT; ++p) {
        const int idx = tid + p * FT;
        const int m = idx >> 3, v = (idx & 7) * 4;
        const int gm = c * FH + m;
        const bool ok = gm < d_mid && k0 + v < d_in;
        cp_async16(w1s + (buf * FH + m) * LD1 + v,
                   ok ? w1 + static_cast<long long>(gm) * d_in + k0 + v : w1,
                   ok);
      }
    } else {
      const int k0 = c * FH + (i - k1s) * FK2;
#pragma unroll
      for (int p = 0; p < NJ * 64 * 2 / FT; ++p) {
        const int idx = tid + p * FT;
        const int n = idx >> 1, v = (idx & 1) * 4;
        const bool ok = n < d_out && k0 + v < d_mid;
        cp_async16(w2s + (buf * NJ * 64 + n) * LD2 + v,
                   ok ? w2 + static_cast<long long>(n) * d_mid + k0 + v : w2,
                   ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < NJ; ++i) acc[r][i] = 0.f;
  float h[8][4];

  load(0);
  for (int st = 0; st < total; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // step st staged; every thread is past step st - 1
    if (st + 1 < total) load(st + 1);
    const int c = st / per_chunk;
    const int i = st - c * per_chunk;
    const int buf = st & 1;
    if (i < k1s) {
      if (i == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) h[r][j] = 0.f;
      }
      const float* xb = xs + (buf * FM + 8 * rg) * LD1;
      const float* wb = w1s + (buf * FH + lane) * LD1;
#pragma unroll 2
      for (int k = 0; k < FK1; k += 4) {
        float4 xv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          xv[r] = *reinterpret_cast<const float4*>(xb + r * LD1 + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wb + j * 64 * LD1 + k);
#pragma unroll
          for (int r = 0; r < 8; ++r) h[r][j] = dot4(h[r][j], xv[r], wv);
        }
      }
      if (i == k1s - 1) {  // + b1, GELU into the h chunk (read from st + 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int g = c * FH + lane + 64 * j;
          const float bias = g < d_mid ? b1[g] : 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r)
            hs[(8 * rg + r) * LDH + lane + 64 * j] = gelu(h[r][j] + bias);
        }
      }
    } else {
      const int k0 = (i - k1s) * FK2;
      const float* hb = hs + 8 * rg * LDH + k0;
      const float* wb = w2s + (buf * NJ * 64 + lane) * LD2;
#pragma unroll
      for (int k = 0; k < FK2; k += 4) {
        float4 hv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hb + r * LDH + k);
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wb + n * 64 * LD2 + k);
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][n] = dot4(acc[r][n], hv[r], wv);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int col = lane + 64 * n;
    if (col >= d_out) continue;
    const float bias = b2[col];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long row = r0 + 8 * rg + r;
      if (row < rows) y[row * d_out + col] = acc[r][n] + bias;
    }
  }
}

// ------------------------------------------------------------ launches ----

// The argument block of `uniter_ffn_fwd`, as the caller packs it
// (ops/ffn.py `_CALL`): one pointer to it keeps the ctypes call cheap.
struct FfnCall {
  unsigned long long x, w1, b1, w2, b2, y;
  long long rows;
  int d_in, d_mid, d_out, dtype, device, pad;
  unsigned long long stream;
};
static_assert(sizeof(FfnCall) == 88, "FfnCall is the caller's 88 bytes");

// A row-major [outer, inner] bf16 matrix as 64 x 64 boxes, 128-byte swizzle,
// zeros out of bounds.
bool bf16_map(CUtensorMap* map, unsigned long long ptr, long long outer,
              int inner) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {UNIT, UNIT};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             reinterpret_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt into the dynamic shared memory once per kernel, then launch.
template <typename K, typename... A>
int launch(K kernel, bool& opted, long long grid, int threads, size_t smem,
           cudaStream_t st, A... args) {
  if (grid < 1 || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem > 48 * 1024 ? kSmemLimit : 48 * 1024));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  kernel<<<static_cast<int>(grid), threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int NUW>
int launch_bf16(const FfnCall& a, cudaStream_t st) {
  static bool opted = false;
  CUtensorMap mx, mw1, mw2;
  if (!bf16_map(&mx, a.x, a.rows, a.d_in) ||
      !bf16_map(&mw1, a.w1, a.d_mid, a.d_in) ||
      !bf16_map(&mw2, a.w2, a.d_out, a.d_mid))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ku = (a.d_in + UNIT - 1) / UNIT;
  int nbuf, stages;
  bf16_plan(ku, &nbuf, &stages);
  return launch(ffn_wgmma_kernel<NUW>, opted,
                CLUSTER * ((a.rows + BM - 1) / BM), THREADS,
                bf16_smem_bytes(ku, nbuf, stages), st, mx, mw1, mw2,
                reinterpret_cast<const float*>(a.b1),
                reinterpret_cast<const float*>(a.b2),
                reinterpret_cast<bf16*>(a.y), a.rows, a.d_mid, a.d_out, ku,
                nbuf, stages);
}

template <int NJ>
int launch_f32(const FfnCall& a, cudaStream_t st) {
  static bool opted = false;
  return launch(ffn_f32_kernel<NJ>, opted, (a.rows + FM - 1) / FM, FT,
                f32_smem_bytes(NJ), st, reinterpret_cast<const float*>(a.x),
                reinterpret_cast<const float*>(a.w1),
                reinterpret_cast<const float*>(a.b1),
                reinterpret_cast<const float*>(a.w2),
                reinterpret_cast<const float*>(a.b2),
                reinterpret_cast<float*>(a.y), a.rows, a.d_in, a.d_mid,
                a.d_out);
}

int dispatch(const FfnCall& a) {
  if (a.rows < 1 || a.d_in < 16 || a.d_mid < 16 || a.d_out < 16 ||
      a.d_in % 16 || a.d_mid % 16 || a.d_out % 16 || a.d_in > kMaxWidth ||
      a.d_out > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a.stream);
  if (a.dtype == 1) {
    // y units of D_out, 4 NUW a row tile (two blocks of two warpgroups)
    switch (((a.d_out + UNIT - 1) / UNIT + 3) / 4) {
      case 1: return launch_bf16<1>(a, st);
      case 2: return launch_bf16<2>(a, st);
      case 3: return launch_bf16<3>(a, st);
      default: return launch_bf16<4>(a, st);
    }
  }
  if (a.dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (a.d_out + 63) / 64;
  if (groups <= 4) return launch_f32<4>(a, st);
  if (groups <= 8) return launch_f32<8>(a, st);
  if (groups <= 12) return launch_f32<12>(a, st);
  return launch_f32<16>(a, st);
}

}  // namespace

// Dynamic shared memory of a launch at these widths (dtype 0 float32, 1
// bfloat16), for the record.
extern "C" int uniter_ffn_smem_bytes(int d_in, int d_out, int dtype) {
  if (dtype == 1) {
    const int ku = (d_in + UNIT - 1) / UNIT;
    int nbuf, stages;
    bf16_plan(ku, &nbuf, &stages);
    return static_cast<int>(bf16_smem_bytes(ku, nbuf, stages));
  }
  const int groups = (d_out + 63) / 64;
  return static_cast<int>(f32_smem_bytes(
      groups <= 4 ? 4 : groups <= 8 ? 8 : groups <= 12 ? 12 : 16));
}

// Plain C entry for ctypes: one `FfnCall`. x [rows, D_in], w1 [D_mid, D_in],
// w2 [D_out, D_mid] and y [rows, D_out] contiguous in one dtype (0 float32,
// 1 bfloat16; 16-byte aligned), b1 [D_mid] and b2 [D_out] contiguous fp32,
// on `device`, whose `stream` takes the launch (the caller's current device
// is left as it was). Returns the launch's cudaError_t (0 = ok).
extern "C" int uniter_ffn_fwd(const void* call) {
  FfnCall a;
  std::memcpy(&a, call, sizeof a);  // the block may sit at any alignment
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != a.device && (err = cudaSetDevice(a.device)) != cudaSuccess)
    return static_cast<int>(err);
  const int rc = dispatch(a);
  if (cur != a.device) cudaSetDevice(cur);
  return rc;
}
