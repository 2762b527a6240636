// The tensor-core bf16 dot shared by the certified scans (K1's template in
// scan_select_v3.cu, K6's in maxsim_scan.cu, K8 in scan_select_v1.cu): a
// 64 x 128 tile of f32 dots S = A . B^T between 64 "A rows" (queries, or
// query tokens) and 128 "B rows" (corpus rows, or the chunks' tokens at one
// position), over any width, fed from shared memory by ldmatrix into
// mma.sync m16n8k16 bf16, with the staging ring that streams the B rows in.
//
// The split accumulation. Every mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32
// is issued with C = 0, so it sums at most 16 products of one 16-column
// slice and nothing else; its result is added into an f32 register with
// __fadd_rn, slice after slice in ascending column order. Nothing else
// touches the sum, so the kernels that use this header produce the same bits
// on the same bf16 values whatever else they do around the dot.
//
// Why the certificates still hold (the budgets are the port's, unchanged:
// dense_tiered._bf16_query_bounds's acc_eps = d*2^-23 per unit |a||b|, and
// the H*2^-23 dot share of maxsim._scan16_fused_widths's
// kappa = (H+Lq)*2^-23). Let p_i = a_i*b_i and P = sum|p_i| <= |a||b|.
//  1. Products. bf16 significands have 8 bits, so a product has at most 16
//     and is exact in f32 unless it falls below 2^-126. What a flush of such
//     a product (or of a subnormal bf16 input) loses is below H*2^-126 times
//     the rows' norms, under the certificates' flat _BOUND_EPS = 1e-7 by
//     some 30 orders of magnitude at the norms the tiers hold.
//  2. One mma, the worst-case model. All h_b <= 16 nonzero terms of a
//     slice b are aligned to the largest one's exponent e and truncated to a
//     24-bit window (no guard bits), the aligned terms are summed exactly and
//     the sum is truncated once to f32. The largest term fits its window
//     whole (16 <= 24 bits), and each of the other h_b - 1 loses less than
//     min(|p_i|, 2^(e-23)) <= 2^-23*max|p|, so the alignment loses
//     T <= min(P_b - max|p|, (h_b-1)*2^-23*max|p|); the final truncation
//     loses less than 2^-23*(P_b + T). Together that is at most
//     2^-23*((h_b-1)*max|p| + (P_b - max|p|) + P_b) <= h_b*2^-23*P_b for
//     h_b >= 2 (h_b = 1 is exact). Round-to-nearest, guard bits or a wider
//     window only lose less. Zero columns past the width add no term.
//  3. The outer sum. acc = 0 + d_1 is exact; each of the other
//     ceil(H/16) - 1 adds rounds once, by at most 2^-24 of a partial sum,
//     so it adds at most (ceil(H/16)-1)*2^-24*P (to first order).
//  4. Total: at most (min(H,16) + (ceil(H/16)-1)/2)*2^-23*P. For H <= 16 this
//     is H*2^-23*P (one mma, step 3 adds nothing); for H >= 17 it is below
//     (H - 1/2)*2^-23*P, and the half that is left covers every
//     second-order term. So the error stays within H*2^-23*|a||b|: the
//     budget of both certificates, for every H >= 1.
// Grouping: one k16 slice per mma. Chaining two slices through C would
// make the second mma sum 17 terms, one of them the first slice's sum, for
// a bound of (16*P_1 + 17*P) * 2^-23 at H = 32, over the budget's 32*P; so
// the split stays at one slice per mma.
// The model is an assumption about the card, so chip_smoke.py's mma-probe
// phase holds it to crafted inputs (truncation just under one ulp of the
// largest term, cancellation, exponent spreads, widths 1 to 384) and fails
// the run if any dot's error passes the allowance above;
// tests/test_torch_mma_bound.py emulates the model in numpy against both
// budgets.
//
// Layout. 256 threads = 8 warps in a 2 x 4 grid over the 64 x 128 tile,
// each warp a 32 x 32 tile of 2 x 4 mma tiles, acc[mt][nt][e] at
//   A row  wm*32 + mt*16 + (lane >> 2) + 8*(e >> 1),
//   B row  wn*32 + nt*8 + 2*(lane & 3) + (e & 1).
// Staged rows keep 8 bf16 of padding (a 144-byte stride for a 64-column
// slice), so the 8 row addresses of every ldmatrix phase fall on distinct
// bank quads. Widths round up to 16 (the mma's depth) with zero columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_load.cuh"

namespace mma_bf16 {

constexpr int THREADS = 256;
constexpr int TILE_A = 64;        // A rows of the tile
constexpr int TILE_B = 128;       // B rows of the tile
constexpr int KD = 64;            // columns of B rows per ring stage
constexpr int PAD = 8;            // bf16 of padding per staged row
constexpr int SROW = KD + PAD;    // a ring row's stride (bf16)
constexpr int MT = 2, NT = 4;     // a warp's m16 and n8 tiles
constexpr int RES_MAX = 512;      // widest padded width whose A rows stay resident

// The width rounded up to the mma's depth.
__host__ __device__ constexpr int pad16(int w) { return (w + 15) & ~15; }

// Whether the A rows stay resident in shared memory for the whole block
// (else each ring stage carries their slice beside the B rows').
__host__ __device__ constexpr bool a_resident(int width) { return pad16(width) <= RES_MAX; }

// Depth slices of KD columns per pass over a padded width.
__host__ __device__ constexpr int k_slices(int width) { return (pad16(width) + KD - 1) / KD; }

// Bytes of one ring stage: 128 B rows, and the A rows' slice when it
// streams beside them.
__host__ __device__ constexpr int stage_bytes(bool with_a) {
  return (TILE_B + (with_a ? TILE_A : 0)) * SROW * 2;
}

// Bytes of the resident A rows (0 when they stream).
__host__ __device__ constexpr int resident_bytes(int width) {
  return a_resident(width) ? TILE_A * (pad16(width) + PAD) * 2 : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d = A(16x16) . B(16x8) over one 16-column slice, with C = 0.
__device__ __forceinline__ void mma_slice(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

using Acc = float[MT][NT][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// acc += A . B^T over nk16 <= KD/16 16-column slices: A rows at `a`
// (stride a_stride bf16), B rows at `b` (stride SROW), both starting at the
// slice's first column. A warp's m16 tiles at or past a_rows hold no live row and
// are skipped (warp-uniform).
__device__ __forceinline__ void dot_slices(Acc& acc, const __nv_bfloat16* a, int a_stride,
                                           const __nv_bfloat16* b, int nk16, int a_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const __nv_bfloat16* pa = a + (wm * 32 + (lane & 15)) * a_stride + (lane >> 4) * 8;
  const __nv_bfloat16* pb = b + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * SROW + ((lane >> 3) & 1) * 8;
  bool live[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) live[mt] = wm * 32 + mt * 16 < a_rows;
#pragma unroll
  for (int k = 0; k < KD / 16; ++k) {  // unrolled: the next slice's ldmatrix overlaps this one's mma
    if (k >= nk16) break;
    uint32_t fa[MT][4], fb[NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (live[mt]) ldmatrix_x4(fa[mt], pa + mt * 16 * a_stride + k * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) ldmatrix_x4(fb[np], pb + np * 16 * SROW + k * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!live[mt]) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float d[4];
        mma_slice(d, fa[mt], fb[nt >> 1][(nt & 1) * 2], fb[nt >> 1][(nt & 1) * 2 + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], d[e]);
      }
    }
  }
}

// Eight values of an f32 row, each rounded to bf16 with __float2bfloat16_rn
// (round to nearest even, as torch's .to(torch.bfloat16)), packed.
__device__ __forceinline__ uint4 round8(uint4 lo, uint4 hi) {
  const uint32_t f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(f[2 * e])));
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(f[2 * e + 1])));
    w[e] = a | (b << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage columns [k0, k0 + VE*nv) of `rows` rows into dst (row stride
// `stride` elements), iterating nvp >= nv vector slots per row, each one
// 16-byte vector of VE = 8 bf16 (or 16 int8, mma_s8.cuh's tiles). row_src(i)
// is row i's first element in src, or -1 for an absent row (zeros). Columns
// at or past `width` stage as zero. Rows of the staged type at an aligned
// width (ALIGNED: a whole number of vectors) go by cp.async, with no
// registers on the way; f32 rows (rounded to bf16) and unaligned widths
// (row_load.cuh's bytewise path) go through registers and are stored at once.
template <bool ALIGNED, typename DstT, typename RowT, typename RowSrc>
__device__ __forceinline__ void stage_rows(DstT* dst, int stride, const RowT* src, RowSrc row_src,
                                           int rows, int k0, int nvp, int nv, int width) {
  constexpr int VE = 16 / sizeof(DstT);
  for (int v = threadIdx.x; v < rows * nvp; v += THREADS) {
    const int r = v / nvp, c = v - r * nvp;
    if (c >= nv) continue;
    const int col = k0 + c * VE;
    const int64_t off = row_src(r);
    DstT* to = dst + r * stride + c * VE;
    if constexpr (std::is_same<RowT, float>::value) {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (off >= 0) {
        w = round8(load_row16<4, ALIGNED>(src, off, col, width),
                   load_row16<4, ALIGNED>(src, off, col + 4, width));
      }
      *reinterpret_cast<uint4*>(to) = w;
    } else if constexpr (ALIGNED) {
      const bool full = off >= 0 && col < width;
      cp_async16(to, full ? static_cast<const void*>(src + off + col) : static_cast<const void*>(src),
                 full);
    } else {
      *reinterpret_cast<uint4*>(to) =
          off >= 0 ? load_row16<sizeof(RowT), false>(src, off, col, width) : make_uint4(0, 0, 0, 0);
    }
  }
}

// The ring: `steps` steps, step s staged into stage s % NST of `ring` by
// issue(s, stage) NST - 1 steps ahead and consumed by use(s, stage) once
// every thread's copies of it have landed. Copies a caller starts before the
// call join the first group. Every thread of the block must call it.
template <int NST, typename Issue, typename Use>
__device__ __forceinline__ void ring_run(int steps, unsigned char* ring, int bytes, Issue issue,
                                         Use use) {
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) issue(s, ring + s * bytes);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // step s has landed; every thread is done with step s - 1's stage
    const int next = s + NST - 1;
    if (next < steps) issue(next, ring + (next % NST) * bytes);
    cp_async_commit();
    use(s, ring + (s % NST) * bytes);
  }
  cp_async_wait<0>();
}

}  // namespace mma_bf16
