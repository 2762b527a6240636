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
// d = 384, B = 256) the scan is 2*B*N*d ~ 2.1e11 FLOP of fp32 FMA and
// reads the 0.8 GB bf16 replica. On CUDA cores (no tensor cores, see
// below) the FMA rate is the bound: ~67 TFLOP/s fp32 at the full power
// limit gives ~3 ms at best, while the replica streams in ~0.25 ms at
// 3.35 TB/s. The design therefore spends its effort on FMA density:
//   - one thread block per (group of QB=64 queries, 1024-row tile); the
//     query group is the fastest grid axis, so the B/64 blocks that read
//     one tile run together and the tile comes from HBM once, then L2;
//   - each of the 256 threads owns an 8-row x 4-query register tile of
//     one 128-row block, fed from shared memory as float4 loads (3 shared
//     loads per 32 FMAs); rows are converted bf16->f32 once, when staged;
//   - the score tile never leaves registers: the selection epilogue works
//     on it with half-warp shuffles.
//
// Certificate soundness. dense_tiered._bf16_query_bounds budgets
// d*2^-23*|a||b| for f32 accumulation error. A product of two bf16
// values is exact in f32 and fmaf rounds once, so the sum below is an
// f32 sum of exact products in some order, whose error is at most
// ~d*2^-24*sum|p_i| <= d*2^-24*|a||b|: inside the budget for any order.
// Tensor cores (mma/wgmma) do not promise IEEE f32 rounding of their
// accumulation, so they are not used until that bound is re-derived.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points at
//             the end of this file on the caller's stream.

#include <cuda_bf16.h>

#include "scan_select_common.cuh"

using namespace scan_select;

namespace {

constexpr int KC = 32;  // depth staged per step

// Elements [col, col + 8) of a row as f32, zero at or past the width:
// bf16 rows widen exactly; f32 rows are rounded to bf16 first (RNE).
template <bool ALIGNED>
__device__ __forceinline__ void load8(const __nv_bfloat16* base, int64_t row_off, int col,
                                      int width, float* f) {
  const uint4 raw = load_row16<2, ALIGNED>(base, row_off, col, width);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

template <bool ALIGNED>
__device__ __forceinline__ void load8(const float* base, int64_t row_off, int col, int width,
                                      float* f) {
  const uint4 lo = load_row16<4, ALIGNED>(base, row_off, col, width);
  const uint4 hi = load_row16<4, ALIGNED>(base, row_off, col + 4, width);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(__float2bfloat16_rn(__uint_as_float(w[e])));
}

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
  __shared__ __align__(16) float As[KC][BLOCK];  // staged rows, depth-major
  __shared__ __align__(16) float Qs[KC][QB];     // staged queries, depth-major
  __shared__ SelectSmem sel;

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

  for (int blk = 0; blk < BPT; ++blk) {
    const int64_t row0 = lbase + blk * BLOCK;
    float acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[i][r] = 0.0f;

    for (int k0 = 0; live && k0 < d; k0 += KC) {
      // rows: 128 x 4 vectors of 8 bf16; a warp covers 32 rows of one
      // vector column, so the shared stores are conflict-free
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tid & (BLOCK - 1);
        const int part = (tid >> 7) + 2 * j;
        const int kk = k0 + part * 8;
        float f[8];
        load8<ALIGNED>(m, (row0 + r) * d, kk, d, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) As[part * 8 + e][r] = f[e];
      }
      {
        const int qq = tid & (QB - 1);
        const int part = tid >> 6;
        const int kk = k0 + part * 8;
        float f[8];
        if (q0 + qq < nq) {
          load8<ALIGNED>(q, (int64_t)(q0 + qq) * d, kk, d, f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) Qs[part * 8 + e][qq] = f[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][lane0]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][lane0 + 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Qs[kk][qg * TQ]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[TQ] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[i][r] = fmaf(a[r], b[i], acc[i][r]);
      }
      __syncthreads();
    }

    // per-row bounds (kRow), then -inf on invalid rows and on rows failing
    // the query's filter
    float x[TQ][TM];
    mask_scores<BF>(acc, live, row0 + lane0, q0, qg, nq, valid, tag_bits, t_all, t_any, t_none,
                    eb, ab, uq, vq, x);
    block_candidates<BF>(x, tid, q0, nq, base + blk * BLOCK, blk, (int)(row0 / BLOCK), eb, ab, uq,
                         vq, sel);
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
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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
// (|tiles|*tile_n*d*2 B) or their FMA work (2*B*|tiles|*tile_n*d), whichever
// is larger; at small B the work per thread block is K1's, with most of the
// 64-query group padded. Same requirements as scan_select_v3_launch, plus
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
// scan_select_v3_launch otherwise. What bounds it is K1's: the fp32 FMA
// work of the dot (2*B*N*d) on CUDA cores; the per-row bound adds 4*B*N
// operations and N*8 bytes.
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
