// scan_select_v3 for Hopper (sm_90a): the certified bf16 tile scan, its
// tile-indirect form scan_select_v3_indirect, and their v2 siblings
// scan_select_v2 and scan_select_v2_indirect (one template, the tile-scan
// program of scan_select_tile.cuh at element type bf16, four entry points
// at the end of this file, so the four cannot drift apart). The
// template's parameters here: direct or indirect tiles, the bound form
// (scan_select_common.cuh: per-block for v3, per-row for v2), and the row
// type of the corpus (bf16, or f32 rows rounded to bf16 as they are staged:
// the inline-cast layout).
//
// Replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_v3
// (pallas_call at scan_select_v2.py:433). Semantics, per 1024-row
// selection tile and query:
//   1. s = bf16(m_row) . bf16(q) with f32 accumulation, -inf on invalid
//      rows and, with a tag filter, on rows failing the query's predicate
//      (scan_select_v2.py::_apply_tags);
//   2. per 128-row block: top-2 raw scores with their rows and the third
//      value v3, each plus the block's bound correction
//      corr = eb[blk]*u_q + ab[blk]*v_q (scan_select_common.cuh);
//   3. a tournament over the 16 block candidates emitting the top t_top
//      (value, row) pairs and the tile threshold (scan_select_common.cuh).
// Outputs: v_pack [B, t_top+1, N/1024] f32, r_pack [B, t_top, N/1024] i32.
//
// The v2 siblings replace the Pallas TPU kernels scan_select_v2
// (pallas_call at scan_select_v2.py:274) and scan_select_v2_indirect
// (:664): step 1 adds each row's own bound, upper = (s + e_l2*u) + a_l2*v,
// before the mask, and step 2 ranks those upper bounds with no correction
// after it (Bound::kRow). They cost 4 extra operations per (row, query),
// under 0.3% of the dot at d = 384, and two f32 loads per row.
//
// The inline-cast layout (every entry point's m_f32 = 1): m is the f32
// corpus itself, and each value is rounded to bf16 with __float2bfloat16_rn
// as it is staged, the same round-to-nearest-even as prepare_tiered's
// .to(torch.bfloat16), so the packs are bit-identical to a run over the
// bf16 replica. It reads 4 bytes per element instead of 2 and keeps no
// replica on the card.
//
// What bounds it on the H100. At the main path's shape (N = 1,048,576,
// d = 384, B = 256) the scan is 2*B*N*d ~ 2.1e11 FLOP and reads the 0.8 GB
// bf16 replica (0.25 ms at 3.35 TB/s); at the segment path's (N =
// 17,825,792, B = 64 a call) 8.8e11 FLOP against 13.7 GB (4.1 ms). On the
// tensor cores the dot takes well under a millisecond at 1M, so the bytes
// and the selection epilogue are what is left. The program is
// scan_select_tile.cuh's, at element type bf16 (K3 and K10c are its int8
// instantiation): the tile's rows and the 64-query group stream through a
// 2-stage cp.async ring, each 128-row block's score tile is the tensor-core
// dot of mma_bf16.cuh (ldmatrix + mma.sync m16n8k16 bf16, one 16-column
// slice per mma, f32 __fadd_rn between slices), then goes through shared
// memory into the 8-row x 4-query thread tiles of the unchanged epilogue
// (scan_select_common.cuh). Two thread blocks share an SM.
// f32 rows (the inline-cast layout) and widths that are not a multiple of
// 8 take a register path into the same ring (rounded to bf16 with
// __float2bfloat16_rn, or read bytewise, as they are staged).
//
// Certificate soundness. dense_tiered._bf16_query_bounds budgets
// d*2^-23*|a||b| for the dot's accumulation error; mma_bf16.cuh derives
// the tensor-core dot's worst case, (min(d,16) + (ceil(d/16)-1)/2)*2^-23 *
// sum|p_i|, which stays within it for every d, and chip_smoke.py's
// mma-probe phase holds the card to that model.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points at
//             the end of this file on the caller's stream.

#include <cuda_bf16.h>

#include "scan_select_tile.cuh"

using namespace scan_select;

namespace {

// The row type by the m_f32 flag of the entry points.
template <bool INDIRECT, Bound BF>
int launch(int m_f32, const void* q, const void* m, const void* eb, const void* ab,
           const void* valid, const void* uq, const void* vq, const void* tile_ids,
           const void* tag_bits, const void* t_all, const void* t_any, const void* t_none,
           void* v_pack, void* r_pack, int nq, int d, int g_tiles, int t_top, int tile_n,
           int n_tiles, void* stream) {
  auto run = m_f32 ? scan_tile::launch<INDIRECT, BF, __nv_bfloat16, float>
                   : scan_tile::launch<INDIRECT, BF, __nv_bfloat16, __nv_bfloat16>;
  return run(q, m, nullptr, nullptr, eb, ab, valid, uq, vq, tile_ids, tag_bits, t_all, t_any,
             t_none, v_pack, r_pack, nq, d, g_tiles, t_top, tile_n, n_tiles, stream);
}

bool bad_indirect(int nq, int d, int n, int t_top, int tile_n, int g) {
  return bad_shape(nq, d, n, t_top) || tile_n < SEL || tile_n % SEL != 0 || n % tile_n != 0 ||
         g < 1 || (int64_t)g * (tile_n / SEL) > 65535;
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: q [nq, d] bf16,
// m [n, d] bf16 (m_f32 = 0) or f32 (m_f32 = 1: the inline-cast layout),
// eb/ab [n/128] f32, valid [n] i32, uq/vq [nq] f32, and either all four
// tag arrays (tag_bits [n] i32; t_all/t_any/t_none [nq] i32) or none (null
// pointers: no filter); outputs v_pack [nq, t_top+1, n/1024] f32, r_pack
// [nq, t_top, n/1024] i32. Requires n % 1024 == 0, 16-byte aligned
// q/m/valid/tag_bits (any d >= 1: a width that is not a multiple of 8
// reads its rows through row_load.cuh), 1 <= t_top <= 16. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() (0 on
// success).
extern "C" int scan_select_v3_launch(const void* q, const void* m, const void* eb,
                                     const void* ab, const void* valid, const void* uq,
                                     const void* vq, const void* tag_bits, const void* t_all,
                                     const void* t_any, const void* t_none, void* v_pack,
                                     void* r_pack, int nq, int d, int n, int t_top, int m_f32,
                                     void* stream) {
  if (bad_shape(nq, d, n, t_top)) return (int)cudaErrorInvalidValue;
  return launch<false, Bound::kBlock>(m_f32, q, m, eb, ab, valid, uq, vq, nullptr, tag_bits,
                                      t_all, t_any, t_none, v_pack, r_pack, nq, d, n / SEL,
                                      t_top, SEL, n / SEL, stream);
}

// scan_select_v3_indirect (K5): replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_v3_indirect
// (pallas_call at scan_select_v2.py:579), the cluster-pruned tier's
// selective fetch: K1 over only the g corpus tiles of tile_n rows listed in
// tile_ids [g] i32 (entries >= n/tile_n are pads), reading those tiles in
// place. Outputs v_pack [nq, t_top+1, g*tile_n/1024], r_pack
// [nq, t_top, g*tile_n/1024] with GLOBAL rows. eb/ab are the whole corpus's
// per-128-row block maxes. What bounds it: the selected tiles' bytes
// (|tiles|*tile_n*d*2 B) or their dot (2*B*|tiles|*tile_n*d FLOP on the
// tensor cores), whichever is larger; at small B the warps whose queries are
// all padding skip their mma tiles. Same requirements as scan_select_v3_launch, plus
// tile_n a positive multiple of 1024 dividing n, g >= 1, and
// g*tile_n/1024 <= 65535.
extern "C" int scan_select_v3_indirect_launch(const void* q, const void* m, const void* eb,
                                              const void* ab, const void* valid, const void* uq,
                                              const void* vq, const void* tile_ids,
                                              const void* tag_bits, const void* t_all,
                                              const void* t_any, const void* t_none,
                                              void* v_pack, void* r_pack, int nq, int d, int n,
                                              int t_top, int tile_n, int g, int m_f32,
                                              void* stream) {
  if (bad_indirect(nq, d, n, t_top, tile_n, g)) return (int)cudaErrorInvalidValue;
  return launch<true, Bound::kBlock>(m_f32, q, m, eb, ab, valid, uq, vq, tile_ids, tag_bits,
                                     t_all, t_any, t_none, v_pack, r_pack, nq, d,
                                     g * (tile_n / SEL), t_top, tile_n, n / tile_n, stream);
}

// scan_select_v2 (K10a): replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_v2
// (pallas_call at scan_select_v2.py:274): scan_select_v3_launch with the
// per-row bound (Bound::kRow), so e_l2/a_l2 are the per-row [n] f32 norms
// (16-byte aligned), not block maxes. Same shapes and requirements as
// scan_select_v3_launch otherwise. What bounds it is K1's: the bytes of
// the rows or the dot (2*B*N*d); the per-row bound adds 4*B*N operations and
// N*8 bytes.
extern "C" int scan_select_v2_launch(const void* q, const void* m, const void* e_l2,
                                     const void* a_l2, const void* valid, const void* uq,
                                     const void* vq, const void* tag_bits, const void* t_all,
                                     const void* t_any, const void* t_none, void* v_pack,
                                     void* r_pack, int nq, int d, int n, int t_top, int m_f32,
                                     void* stream) {
  if (bad_shape(nq, d, n, t_top)) return (int)cudaErrorInvalidValue;
  return launch<false, Bound::kRow>(m_f32, q, m, e_l2, a_l2, valid, uq, vq, nullptr, tag_bits,
                                    t_all, t_any, t_none, v_pack, r_pack, nq, d, n / SEL, t_top,
                                    SEL, n / SEL, stream);
}

// scan_select_v2_indirect (K10b): replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_v2_indirect
// (pallas_call at scan_select_v2.py:664): scan_select_v3_indirect_launch
// with the per-row bound. A pad slot (id outside [0, n/tile_n)) scores
// -inf everywhere and emits rows sel*tile_n + offset from the unclamped id,
// as the Pallas kernel does. e_l2/a_l2 are per-row [n]; the other shapes and
// requirements are scan_select_v3_indirect_launch's.
extern "C" int scan_select_v2_indirect_launch(const void* q, const void* m, const void* e_l2,
                                              const void* a_l2, const void* valid, const void* uq,
                                              const void* vq, const void* tile_ids,
                                              const void* tag_bits, const void* t_all,
                                              const void* t_any, const void* t_none,
                                              void* v_pack, void* r_pack, int nq, int d, int n,
                                              int t_top, int tile_n, int g, int m_f32,
                                              void* stream) {
  if (bad_indirect(nq, d, n, t_top, tile_n, g)) return (int)cudaErrorInvalidValue;
  return launch<true, Bound::kRow>(m_f32, q, m, e_l2, a_l2, valid, uq, vq, tile_ids, tag_bits,
                                   t_all, t_any, t_none, v_pack, r_pack, nq, d,
                                   g * (tile_n / SEL), t_top, tile_n, n / tile_n, stream);
}
