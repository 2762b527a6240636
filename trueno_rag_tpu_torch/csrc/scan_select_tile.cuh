// The tile-scan program for Hopper (sm_90a), one template over the element
// type of the dot, built into two libraries: scan_select_v3.cu
// instantiates it at bf16 (K1, K5, K10a, K10b; bf16 rows, or f32 rows
// rounded to bf16 as they are staged) and scan_select_int8_v3.cu at int8
// (K3, K10c). So the ring, the staging, the score tile, the masks, the
// bounds and the selection exist once, and the two element types cannot
// drift apart. The semantics of each entry point are in those files.
//
// The program, per thread block (QB = 64 queries x one 1024-row tile):
//   - one thread block per (query group, tile), the query group the
//     fastest grid axis, so the B/64 blocks that read one tile run together
//     and the tile comes from HBM once, then from L2;
//   - the tile's eight 128-row blocks and the group's queries stream
//     through a 2-stage cp.async ring (mma_bf16::ring_run) of 128-byte
//     column slices (64 bf16 or 128 int8 columns: 128 rows and 64 queries a
//     stage, zero past d and past nq), the blocks back to back. The queries'
//     slices come again for every block, from L2; kept resident instead
//     (50 KB at d = 384 bf16) they left room for one thread block per SM,
//     and with one block the dot, the loads and the epilogue of a block run
//     one after another. At ~105 KB two blocks share an SM and each one's
//     epilogue overlaps the other's dot and loads (1.5x faster at K1's main
//     shape on an H100);
//   - each block's 64 x 128 score tile is the tensor-core dot of
//     mma_dot.cuh, fed by ldmatrix: bf16 through mma_bf16.cuh (mma.sync
//     m16n8k16, one 16-column slice per mma from C = 0, f32 __fadd_rn
//     between slices), int8 through mma_s8.cuh (mma.sync m16n8k32 s8, the
//     s32 sum chained through C across the whole depth: exact). Warps whose
//     queries are all padding skip their mma tiles;
//   - the tile then goes through shared memory into the epilogue's 8-row x
//     4-query thread tiles (tile_scores; an s32 sum converts exactly with
//     __int2float_rn), int8 dequantizes there with (f * s_row) * t_q
//     (scale_int8), and the unchanged masks, bounds, block selection and
//     tournament of scan_select_common.cuh follow.
// f32 rows and widths that are not a whole number of 16-byte vectors (8
// bf16, 16 int8) are staged through registers (rounded to bf16 with
// __float2bfloat16_rn, or read byte by byte with zeros past d,
// row_load.cuh). Widths round up to the mma's depth (16 bf16, 32 int8)
// with zero columns, which add exactly 0.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_dot.cuh"
#include "scan_select_common.cuh"

namespace scan_tile {

using namespace scan_select;
namespace mb = mma_bf16;

constexpr int NST = 2;  // ring stages
static_assert(mb::TILE_A == QB && mb::TILE_B == BLOCK && mb::THREADS == THREADS,
              "the mma tile is one 128-row block of one query group");

// Shared memory: the tournament pool, the score tile [QB][SSTR]
// (tile_scores), the ring (rows and queries): 105,216 bytes at any d and
// either element type.
constexpr int SEL_BYTES = (sizeof(SelectSmem) + 15) / 16 * 16;
constexpr int SCORE_BYTES = QB * SSTR * 4;
constexpr int SMEM_BYTES = SEL_BYTES + SCORE_BYTES + NST * mb::stage_bytes(true);

// E: the dot's element type (bf16 or int8; the query type). RowT: the
// corpus rows' type (E, or f32 rounded to bf16 as staged). s_row/tq: the
// int8 row and query scales (null for bf16).
// INDIRECT = false: output column y scans rows y*1024 .. y*1024+1023.
// INDIRECT = true (K5, K10b): output column y scans 1024-row part (y mod
// spt) of corpus tile sel = tile_ids[y / spt], with spt = tile_n / 1024.
// A pad slot (sel outside [0, n_tiles)) loads nothing, scores -inf
// everywhere, and still emits rows from the unclamped sel (sel*tile_n +
// offset), as the Pallas kernel does; its bound corrections read the
// clamped tile's blocks (or rows, under kRow).
// ALIGNED: every row of q and m starts 16-byte aligned (d a whole number
// of 16-byte vectors of E) and loads as whole vectors.
template <bool INDIRECT, bool ALIGNED, Bound BF, typename E, typename RowT>
__global__ void __launch_bounds__(THREADS, 2)
tile_scan_kernel(const E* __restrict__ q,              // [B, d]
                 const RowT* __restrict__ m,           // [N, d]
                 const float* __restrict__ s_row,      // [N] (int8) or null
                 const float* __restrict__ tq,         // [B] (int8) or null
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
  using D = mma_dot::Dot<E>;
  constexpr bool INT8 = std::is_same<E, int8_t>::value;
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
    const int dp = D::pad(d);
    const int ks = D::slices(d);
    auto q_src = [&](int i) -> int64_t { return i < a_rows ? (int64_t)(q0 + i) * d : -1; };
    typename D::Acc acc;
    D::zero(acc);
    mb::ring_run<NST>(
        BPT * ks, ring, mb::stage_bytes(true),
        [&](int step, unsigned char* st) {
          const int blk = step / ks, k0 = (step % ks) * D::KD;
          const int nv = min(D::KD, dp - k0) / D::VE;
          const int64_t row0 = lbase + blk * BLOCK;
          auto m_src = [&](int i) -> int64_t { return (row0 + i) * d; };
          auto* rows = reinterpret_cast<E*>(st);
          mb::stage_rows<ALIGNED>(rows, D::SROW, m, m_src, BLOCK, k0, D::KD / D::VE, nv, d);
          mb::stage_rows<ALIGNED>(rows + BLOCK * D::SROW, D::SROW, q, q_src, QB, k0, D::KD / D::VE, nv, d);
        },
        [&](int step, unsigned char* st) {
          const int blk = step / ks, kc = step % ks, k0 = kc * D::KD;
          auto* rows = reinterpret_cast<const E*>(st);
          D::run(acc, rows + BLOCK * D::SROW, D::SROW, rows, min(D::KD, dp - k0) / D::DK, a_rows);
          if (kc != ks - 1) return;
          // the block's scores → shared memory → the epilogue's thread tiles
          float s[TQ][TM];
          tile_scores(acc, scores, s);
          D::zero(acc);
          if constexpr (INT8) scale_int8(s, s_row + lbase + blk * BLOCK + lane0, tq, q0 + qg * TQ, nq);
          epilogue(blk, s);
        });
  }
  __syncthreads();
  tile_tournament(sel, tid, q0, nq, tile, g_tiles, t_top, v_pack, r_pack);
}

// Launches the kernel over g_tiles output columns on `stream`, picking the
// aligned form by d; returns the cudaError (0 = ok).
template <bool INDIRECT, Bound BF, typename E, typename RowT>
int launch(const void* q, const void* m, const void* s_row, const void* tq, const void* eb,
           const void* ab, const void* valid, const void* uq, const void* vq, const void* tile_ids,
           const void* tag_bits, const void* t_all, const void* t_any, const void* t_none,
           void* v_pack, void* r_pack, int nq, int d, int g_tiles, int t_top, int tile_n,
           int n_tiles, void* stream) {
  const dim3 grid((nq + QB - 1) / QB, g_tiles);
  auto kernel = rows_aligned<sizeof(E)>(d) ? tile_scan_kernel<INDIRECT, true, BF, E, RowT>
                                           : tile_scan_kernel<INDIRECT, false, BF, E, RowT>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const RowT*>(m), static_cast<const float*>(s_row),
      static_cast<const float*>(tq), static_cast<const float*>(eb), static_cast<const float*>(ab),
      static_cast<const int*>(valid), static_cast<const float*>(uq),
      static_cast<const float*>(vq), static_cast<const int*>(tile_ids),
      static_cast<const int*>(tag_bits), static_cast<const int*>(t_all),
      static_cast<const int*>(t_any), static_cast<const int*>(t_none),
      static_cast<float*>(v_pack), static_cast<int*>(r_pack), nq, d, g_tiles, t_top, tile_n,
      n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace scan_tile
