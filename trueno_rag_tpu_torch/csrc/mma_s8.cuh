// The tensor-core int8 dot: mma_bf16.cuh's 64 x 128 tile S = A . B^T of
// exact integer dots between 64 "A rows" (query tokens) and 128 "B rows"
// (the chunks' tokens at one position), over any width, fed from shared
// memory by ldmatrix into mma.sync m16n8k32 s8 with s32 accumulation
// (K7's in maxsim_scan.cu).
//
// Exactness. Every product of two int8 values is at most 127^2 in
// magnitude, and the callers require width*127^2 < 2^24, so every partial
// sum is an integer below 2^24 in magnitude: the s32 sum is exact in any
// grouping and its conversion to f32 is exact. So the accumulator is chained
// through C across the whole depth (no split, no probe).
//
// Layout. The same as mma_bf16.cuh's in bytes, so the same ring, staging
// (mma_bf16::stage_rows, 16 int8 per vector) and warp grid serve both:
// a ring stage holds 128 int8 columns of each row (mma_bf16's 64 bf16),
// rows keep 16 bytes of padding (a 144-byte stride), and one mma takes
// 32 bytes of depth (32 int8 here, 16 bf16 there). The s8 A and B fragments
// of m16n8k32 have ldmatrix's b16 register layout over 16-byte rows (a0/a1:
// k 0-15 of rows g and g + 8, a2/a3: k 16-31; b0: k 0-15, b1: k 16-31 of
// column g), and the s32 C fragment sits at the f32 C fragment's (row,
// column) positions of m16n8k16:
//   acc[mt][nt][e] at A row  wm*32 + mt*16 + (lane >> 2) + 8*(e >> 1),
//                     B row  wn*32 + nt*8 + 2*(lane & 3) + (e & 1).
// Widths round up to 32 (the mma's depth) with zero columns.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma_s8 {

namespace mb = mma_bf16;

constexpr int KD = 2 * mb::KD;    // int8 columns of B rows per ring stage (128)
constexpr int PAD = 2 * mb::PAD;  // int8 of padding per staged row (16)
constexpr int SROW = KD + PAD;    // a ring row's stride (int8): mb::SROW's 144 bytes
static_assert(SROW == 2 * mb::SROW, "one ring serves both element types");

// The width rounded up to the mma's depth.
__host__ __device__ constexpr int pad32(int w) { return (w + 31) & ~31; }

// Whether the A rows stay resident in shared memory (as mma_bf16.cuh: up
// to RES_MAX columns).
__host__ __device__ constexpr bool a_resident(int width) { return pad32(width) <= mb::RES_MAX; }

// Depth slices of KD columns per pass over a padded width.
__host__ __device__ constexpr int k_slices(int width) { return (pad32(width) + KD - 1) / KD; }

// Bytes of the resident A rows (0 when they stream).
__host__ __device__ constexpr int resident_bytes(int width) {
  return a_resident(width) ? mb::TILE_A * (pad32(width) + PAD) : 0;
}

// c += A(16x32) . B(32x8), s32.
__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using Acc = int[mb::MT][mb::NT][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < mb::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < mb::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
}

// acc += A . B^T over nk32 <= KD/32 32-column slices: A rows at `a`
// (stride a_stride int8), B rows at `b` (stride SROW), both starting at the
// slice's first column. A warp's m16 tiles at or past a_rows hold no live
// row and are skipped (warp-uniform).
__device__ __forceinline__ void dot_slices(Acc& acc, const int8_t* a, int a_stride, const int8_t* b,
                                           int nk32, int a_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int8_t* pa = a + (wm * 32 + (lane & 15)) * a_stride + (lane >> 4) * 16;
  const int8_t* pb = b + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * SROW + ((lane >> 3) & 1) * 16;
  bool live[mb::MT];
#pragma unroll
  for (int mt = 0; mt < mb::MT; ++mt) live[mt] = wm * 32 + mt * 16 < a_rows;
#pragma unroll
  for (int k = 0; k < KD / 32; ++k) {
    if (k >= nk32) break;
    uint32_t fa[mb::MT][4], fb[mb::NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < mb::MT; ++mt)
      if (live[mt]) mb::ldmatrix_x4(fa[mt], pa + mt * 16 * a_stride + k * 32);
#pragma unroll
    for (int np = 0; np < mb::NT / 2; ++np) mb::ldmatrix_x4(fb[np], pb + np * 16 * SROW + k * 32);
#pragma unroll
    for (int mt = 0; mt < mb::MT; ++mt) {
      if (!live[mt]) continue;
#pragma unroll
      for (int nt = 0; nt < mb::NT; ++nt)
        mma_k32(acc[mt][nt], fa[mt], fb[nt >> 1][(nt & 1) * 2], fb[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
}

}  // namespace mma_s8
