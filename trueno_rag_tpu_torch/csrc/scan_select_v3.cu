// scan_select_v3 for Hopper (sm_90a): the certified bf16 tile scan, its
// tile-indirect form scan_select_v3_indirect, and their v2 siblings
// scan_select_v2 and scan_select_v2_indirect (one template, four entry
// points at the end of this file, so the four cannot drift apart). The
// template's parameters: direct or indirect tiles, the bound form
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
// and the selection epilogue are what is left. The design:
//   - one thread block per (group of QB = 64 queries, 1024-row tile); the
//     query group is the fastest grid axis, so the B/64 blocks that read
//     one tile run together and the tile comes from HBM once, then L2;
//   - the tile's rows and the group's queries stream through a 2-stage
//     cp.async ring of 64-column bf16 slices (128 rows and 64 queries,
//     zero past d and past nq), the 128-row blocks back to back. The
//     queries' slices come again for every 128-row block, from L2; kept
//     resident instead (50 KB at d = 384) they left room for one thread
//     block per SM, and with one block the dot, the loads and the
//     epilogue of a block run one after another. At ~105 KB two blocks
//     share an SM and each one's epilogue overlaps the other's dot and
//     loads (1.5x faster at the main path's shape on an H100);
//   - each 128-row block's 128 x 64 score tile is computed by the mma dot
//     of mma_bf16.cuh (ldmatrix + mma.sync m16n8k16 bf16, one 16-column
//     slice per mma, f32 __fadd_rn between slices), then staged through
//     shared memory into the epilogue's 8-row x 4-query thread tiles
//     (scan_select_common.cuh), whose masks, bounds, selection and
//     tournament are unchanged.
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

#include "mma_bf16.cuh"
#include "scan_select_common.cuh"

using namespace scan_select;
namespace mb = mma_bf16;

namespace {

constexpr int NST = 2;                 // ring stages
static_assert(mb::TILE_A == QB && mb::TILE_B == BLOCK && mb::THREADS == THREADS,
              "the mma tile is one 128-row block of one query group");

// Shared memory: the tournament pool, the score tile [QB][SSTR]
// (scan_select_common.cuh's tile_scores), the ring (rows and queries):
// 105,216 bytes at any d.
constexpr int SEL_BYTES = (sizeof(SelectSmem) + 15) / 16 * 16;
constexpr int SCORE_BYTES = QB * SSTR * 4;
constexpr int SMEM_BYTES = SEL_BYTES + SCORE_BYTES + NST * mb::stage_bytes(true);

// INDIRECT = false: K1, output column y scans rows y*1024 .. y*1024+1023.
// INDIRECT = true: K5 (scan_select_v3_indirect), output column y scans
// 1024-row part (y mod spt) of corpus tile sel = tile_ids[y / spt], with
// spt = tile_n / 1024. A pad slot (sel outside [0, n_tiles)) loads
// nothing, scores -inf everywhere, and still emits rows from the unclamped
// sel (sel*tile_n + offset), as the Pallas kernel does; its bound
// corrections read the clamped tile's blocks (or rows, under kRow).
// ALIGNED: d is a multiple of 8, so every row of q and m (bf16 or f32)
// starts 16-byte aligned and loads as whole vectors.
template <bool INDIRECT, bool ALIGNED, Bound BF, typename RowT>
__global__ void __launch_bounds__(THREADS, 2)
scan_select_v3_kernel(const __nv_bfloat16* __restrict__ q,  // [B, d]
                      const RowT* __restrict__ m,           // [N, d] bf16 or f32
                      const float* __restrict__ eb,         // kBlock: [N/128] block max e_l2; kRow: [N] e_l2
                      const float* __restrict__ ab,         // kBlock: [N/128] block max a_l2; kRow: [N] a_l2
                      const int* __restrict__ valid,        // [N]
                      const float* __restrict__ uq,         // [B]
                      const float* __restrict__ vq,         // [B]
                      const int* __restrict__ tile_ids,     // [G] (INDIRECT only)
                      const int* __restrict__ tag_bits,     // [N] or null: no filter
                      const int* __restrict__ t_all,        // [B]
                      const int* __restrict__ t_any,        // [B]
                      const int* __restrict__ t_none,       // [B]
                      float* __restrict__ v_pack,           // [B, T+1, G']
                      int* __restrict__ r_pack,             // [B, T, G']
                      int nq, int d, int g_tiles, int t_top, int tile_n, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  SelectSmem& sel = *reinterpret_cast<SelectSmem*>(smem);
  float* scores = reinterpret_cast<float*>(smem + SEL_BYTES);
  unsigned char* ring = smem + SEL_BYTES + SCORE_BYTES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;

  int64_t base = (int64_t)tile * SEL;  // first row as emitted
  int64_t lbase = base;                // first row read
  bool live = true;                    // uniform over the thread block
  if (INDIRECT) {
    const int spt = tile_n / SEL;
    const int s = __ldg(tile_ids + tile / spt);
    const int64_t off = (int64_t)(tile % spt) * SEL;
    live = s >= 0 && s < n_tiles;
    base = (int64_t)s * tile_n + off;
    lbase = (int64_t)min(max(s, 0), n_tiles - 1) * tile_n + off;
  }

  // masks, bounds and the block's candidates from this thread's 8 x 4 scores
  auto epilogue = [&](int blk, const float (&s)[TQ][TM]) {
    const int64_t row0 = lbase + blk * BLOCK;
    float x[TQ][TM];
    mask_scores<BF>(s, live, row0 + lane0, q0, qg, nq, valid, tag_bits, t_all, t_any, t_none,
                    eb, ab, uq, vq, x);
    block_candidates<BF>(x, tid, q0, nq, base + blk * BLOCK, blk, (int)(row0 / BLOCK), eb, ab, uq,
                         vq, sel);
  };

  if (!live) {  // a pad slot: nothing loaded, every score -inf
    float s[TQ][TM] = {};
    for (int blk = 0; blk < BPT; ++blk) epilogue(blk, s);
  } else {
    const int a_rows = min(QB, nq - q0);
    const int dp = mb::pad16(d);
    const int ks = mb::k_slices(d);
    auto q_src = [&](int i) -> int64_t { return i < a_rows ? (int64_t)(q0 + i) * d : -1; };
    mb::Acc acc;
    mb::zero(acc);
    mb::ring_run<NST>(
        BPT * ks, ring, mb::stage_bytes(true),
        [&](int step, unsigned char* st) {
          const int blk = step / ks, k0 = (step % ks) * mb::KD;
          const int nv = min(mb::KD, dp - k0) / 8;
          const int64_t row0 = lbase + blk * BLOCK;
          auto m_src = [&](int i) -> int64_t { return (row0 + i) * d; };
          auto* rows = reinterpret_cast<__nv_bfloat16*>(st);
          mb::stage_rows<ALIGNED>(rows, mb::SROW, m, m_src, BLOCK, k0, 8, nv, d);
          mb::stage_rows<ALIGNED>(rows + BLOCK * mb::SROW, mb::SROW, q, q_src, QB, k0, 8, nv, d);
        },
        [&](int step, unsigned char* st) {
          const int blk = step / ks, kc = step % ks, k0 = kc * mb::KD;
          auto* rows = reinterpret_cast<const __nv_bfloat16*>(st);
          mb::dot_slices(acc, rows + BLOCK * mb::SROW, mb::SROW, rows, min(mb::KD, dp - k0) / 16, a_rows);
          if (kc != ks - 1) return;
          // the block's scores → shared memory → the epilogue's thread tiles
          float s[TQ][TM];
          tile_scores(acc, scores, s);
          mb::zero(acc);
          epilogue(blk, s);
        });
  }
  __syncthreads();
  tile_tournament(sel, tid, q0, nq, tile, g_tiles, t_top, v_pack, r_pack);
}

template <bool INDIRECT, Bound BF, typename RowT>
int launch_rows(const void* q, const void* m, const void* eb, const void* ab, const void* valid,
                const void* uq, const void* vq, const void* tile_ids, const void* tag_bits,
                const void* t_all, const void* t_any, const void* t_none, void* v_pack,
                void* r_pack, int nq, int d, int g_tiles, int t_top, int tile_n, int n_tiles,
                void* stream) {
  const dim3 grid((nq + QB - 1) / QB, g_tiles);
  auto kernel = rows_aligned<2>(d) ? scan_select_v3_kernel<INDIRECT, true, BF, RowT>
                                   : scan_select_v3_kernel<INDIRECT, false, BF, RowT>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const RowT*>(m),
      static_cast<const float*>(eb), static_cast<const float*>(ab),
      static_cast<const int*>(valid), static_cast<const float*>(uq),
      static_cast<const float*>(vq), static_cast<const int*>(tile_ids),
      static_cast<const int*>(tag_bits), static_cast<const int*>(t_all),
      static_cast<const int*>(t_any), static_cast<const int*>(t_none),
      static_cast<float*>(v_pack), static_cast<int*>(r_pack), nq, d, g_tiles, t_top, tile_n,
      n_tiles);
  return (int)cudaGetLastError();
}

// The row type by the m_f32 flag of the entry points.
template <bool INDIRECT, Bound BF>
int launch(int m_f32, const void* q, const void* m, const void* eb, const void* ab,
           const void* valid, const void* uq, const void* vq, const void* tile_ids,
           const void* tag_bits, const void* t_all, const void* t_any, const void* t_none,
           void* v_pack, void* r_pack, int nq, int d, int g_tiles, int t_top, int tile_n,
           int n_tiles, void* stream) {
  auto run = m_f32 ? launch_rows<INDIRECT, BF, float> : launch_rows<INDIRECT, BF, __nv_bfloat16>;
  return run(q, m, eb, ab, valid, uq, vq, tile_ids, tag_bits, t_all, t_any, t_none, v_pack,
             r_pack, nq, d, g_tiles, t_top, tile_n, n_tiles, stream);
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
