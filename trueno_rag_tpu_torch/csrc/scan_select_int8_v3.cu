// scan_select_int8_v3 for Hopper (sm_90a): the certified int8 tile scan,
// and its v2 sibling scan_select_int8_v2 (one template, the tile-scan
// program of scan_select_tile.cuh at element type int8, two entry points
// at the end of this file).
//
// Replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_int8_v3
// (pallas_call at scan_select_v2.py:775). Semantics, per 1024-row
// selection tile and query:
//   1. s = (f32(sum q_i8 * m_i8) * s_row[row]) * t_q[q]: an exact int32 dot,
//      then two f32 multiplies in the JAX code's order
//      (scan_select_v2.py:706); -inf on invalid rows and, with a tag
//      filter, on rows failing the query's predicate;
//   2. and 3. exactly K1's selection: per-128-row block top-2 and third
//      value plus the block bound correction, then the per-1024-row
//      tournament (scan_select_common.cuh, shared with scan_select_v3.cu).
// Outputs: v_pack [B, t_top+1, N/1024] f32, r_pack [B, t_top, N/1024] i32.
//
// The v2 sibling replaces the Pallas TPU kernel scan_select_int8_v2
// (pallas_call at scan_select_v2.py:847): step 1 adds each row's own bound,
// upper = (((dot*s_row)*t_q) + e_l2*u) + a_l2*v (scan_select_v2.py:209-212),
// before the mask, and the selection ranks those upper bounds with no
// correction after it (Bound::kRow in scan_select_common.cuh).
//
// Exactness. |q_i8|, |m_i8| <= 127, so every partial sum of the dot is an
// integer of magnitude <= d*127^2 < 2^24 (the wrapper checks d): int32
// accumulation is exact in any order, and the conversion to f32 is exact.
// The two scale multiplies, and the v2 sibling's two bound terms and two
// adds, are written as __fmul_rn/__fadd_rn so nothing contracts into an
// fma. The plain version (an f32 matmul of the same integers, then the same
// multiplies and adds, each its own rounded tensor op) therefore gives
// bit-identical values, and the same selection gives identical rows.
//
// What bounds it on the H100. At the main path's shape (N = 1,048,576,
// d = 384, B = 256) the int8 replica is 0.40 GB, 0.12 ms at 3.35 TB/s;
// the dot is 2*B*N*d = 2.06e11 integer operations, 0.10 ms at the int8
// tensor-core peak (1,979 TOP/s). So the card's bound is the HBM stream.
// The program is K1's (scan_select_tile.cuh) at element type int8: one
// thread block per (64-query group, 1024-row tile), the tile's eight
// 128-row blocks and the group's queries streaming through the 2-stage
// cp.async ring in 128-column int8 slices (the same 144-byte staged rows
// as K1's 64 bf16 columns, so 3 ring steps per block at d = 384 where K1
// takes 6), each block's 64 x 128 tile of exact s32 dots computed by
// mma_s8.cuh (ldmatrix + mma.sync m16n8k32 s8, C chained across the whole
// depth: half K1's ldmatrix and mma count per byte of a row, no split
// adds), then through shared memory into the 8-row x 4-query thread tiles
// (tile_scores, __int2float_rn), the two scale multiplies there, and K1's
// masks, selection and tournament. Widths round up to 32 with zero
// columns; rows whose width is not a multiple of 16 are staged byte by
// byte (row_load.cuh). What is left beside the bytes is K1's: the
// selection epilogue and the ring's L2 and ldmatrix traffic.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             at the end of this file on the caller's stream.

#include "scan_select_tile.cuh"

using namespace scan_select;

namespace {

template <Bound BF>
int launch(const void* q, const void* m, const void* s_row, const void* eb, const void* ab,
           const void* valid, const void* tq, const void* uq, const void* vq,
           const void* tag_bits, const void* t_all, const void* t_any, const void* t_none,
           void* v_pack, void* r_pack, int nq, int d, int n, int t_top, void* stream) {
  if (bad_shape(nq, d, n, t_top) || (long long)d * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  return scan_tile::launch<false, BF, int8_t, int8_t>(q, m, s_row, tq, eb, ab, valid, uq, vq, nullptr,
                                                      tag_bits, t_all, t_any, t_none, v_pack, r_pack,
                                                      nq, d, n / SEL, t_top, SEL, n / SEL, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: q [nq, d] int8,
// m [n, d] int8, s_row [n] f32, eb/ab [n/128] f32, valid [n] i32,
// tq/uq/vq [nq] f32, and either all four tag arrays (tag_bits [n] i32;
// t_all/t_any/t_none [nq] i32) or none (null pointers: no filter);
// outputs v_pack [nq, t_top+1, n/1024] f32, r_pack [nq, t_top, n/1024]
// i32. Requires n % 1024 == 0, d*127^2 < 2^24 (any d >= 1: a width that
// is not a multiple of 16 reads its rows through row_load.cuh), 16-byte
// aligned q/m/s_row/valid/tag_bits, 1 <= t_top <= 16. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() (0 on
// success).
extern "C" int scan_select_int8_v3_launch(const void* q, const void* m, const void* s_row,
                                          const void* eb, const void* ab, const void* valid,
                                          const void* tq, const void* uq, const void* vq,
                                          const void* tag_bits, const void* t_all,
                                          const void* t_any, const void* t_none, void* v_pack,
                                          void* r_pack, int nq, int d, int n, int t_top,
                                          void* stream) {
  return launch<Bound::kBlock>(q, m, s_row, eb, ab, valid, tq, uq, vq, tag_bits, t_all, t_any,
                               t_none, v_pack, r_pack, nq, d, n, t_top, stream);
}

// scan_select_int8_v2 (K10c): replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_int8_v2
// (pallas_call at scan_select_v2.py:847): scan_select_int8_v3_launch with
// the per-row bound, so e_l2/a_l2 are the per-row [n] f32 norms (16-byte
// aligned), not block maxes. Same shapes and requirements otherwise, and
// bit-identical to its plain version. What bounds it is K3's: the bytes of
// the int8 rows (the dot on the int8 tensor cores stays below them); the
// per-row bound adds 4*B*N operations and N*8 bytes.
extern "C" int scan_select_int8_v2_launch(const void* q, const void* m, const void* s_row,
                                          const void* e_l2, const void* a_l2, const void* valid,
                                          const void* tq, const void* uq, const void* vq,
                                          const void* tag_bits, const void* t_all,
                                          const void* t_any, const void* t_none, void* v_pack,
                                          void* r_pack, int nq, int d, int n, int t_top,
                                          void* stream) {
  return launch<Bound::kRow>(q, m, s_row, e_l2, a_l2, valid, tq, uq, vq, tag_bits, t_all, t_any,
                             t_none, v_pack, r_pack, nq, d, n, t_top, stream);
}
