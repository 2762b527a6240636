// scan_select and scan_select_int8 for Hopper (sm_90a): the block-kernel
// ("v1") scans of the bf16 and int8 tiers with scan_kernel="block", one
// kernel template over the element type, two entry points at the end of
// this file.
//
// Replaces the Pallas TPU kernels
//   trueno_rag_tpu/ops/pallas/scan_select.py::scan_select
//     (pallas_call at scan_select.py:107)
//   trueno_rag_tpu/ops/pallas/scan_select_int8.py::scan_select_int8
//     (pallas_call at scan_select_int8.py:107)
// Semantics, per query b and 128-row block g:
//   1. per row i, the upper bound
//        bf16: upper = f32(bf16 q . bf16 m_i) + e_l2[i]*u_q[b] + a_l2[i]*v_q[b]
//        int8: upper = (f32(sum q_i8*m_i8) * s_row[i]) * t_q[b]
//                      + e_l2[i]*u_q[b] + a_l2[i]*v_q[b]
//      (the adds left to right, each product and sum rounded once, as the
//      Pallas kernels write them); -inf on invalid rows. The bound is per
//      row, not the per-block max that K1 and K3 use;
//   2. top+1 passes over the block's 128 uppers: each emits the block max
//      v_t, and for t < top the LARGEST lane holding it (the Pallas
//      kernel's max(where(x == v, lane, -1))), whose entry then becomes
//      -inf. An all -inf block therefore emits lane 127 in every pass.
// Outputs: v [top+1, B, N/128] f32 and lanes [top, B, N/128] i32 (lanes
// within the block); the [B, N] score tensor is never written.
//
// Both kernels: one thread block per (64-query group, eight 128-row
// blocks), the query group the fastest grid axis, so a row block comes
// from HBM once and then from L2. Each of the 256 threads ends a block with
// an 8-row x 4-query tile of scores, from which it adds the per-row bound
// (scan_select_common.cuh's mask_scores, Bound::kRow) and runs the
// selection with half-warp shuffles (the 16 threads holding one query's
// 128 rows share a half-warp), so the only writes are the (2*top+1)*B*N/128
// outputs.
//
// Both are one program over the element type, K1's (scan_select_tile.cuh)
// with the block selection in place of the tournament: the eight blocks'
// rows and the group's query slices stream through a 2-stage cp.async ring
// of 128-byte column slices (64 bf16 or 128 int8 columns); each block's
// 64 x 128 score tile is the tensor-core dot of mma_dot.cuh, which then
// goes through shared memory into the thread tiles (tile_scores).
// bf16 (K8): mma_bf16.cuh (ldmatrix + mma.sync m16n8k16, one 16-column
// slice per mma from C = 0, the slices added with __fadd_rn); widths round
// up to 16 with zero columns, rows whose width is not a multiple of 8 are
// staged byte by byte (row_load.cuh).
// int8 (K9): mma_s8.cuh (ldmatrix + mma.sync m16n8k32 s8, the exact s32 sum
// chained through C across the whole depth), converted with __int2float_rn
// in tile_scores and dequantized as (f * s_row) * t_q (scale_int8); widths
// round up to 32, rows whose width is not a multiple of 16 are staged byte
// by byte.
//
// What bounds it on the H100. At the smoke's shape (N = 1,048,576,
// d = 384, B = 256) the bf16 scan reads the 0.8 GB replica (0.25 ms at
// 3.35 TB/s) and does 2*B*N*d = 2.06e11 FLOP, 0.21 ms at the bf16
// tensor-core peak; the int8 scan reads 0.40 GB (0.12 ms) and does the
// same count of integer operations, 0.10 ms at the int8 peak. The bytes
// bound both, and with the dot on the tensor cores what is left beside
// them is the selection epilogue (top+1 argmax passes of 4 half-warp
// shuffles per query and block) and the L2 and ldmatrix traffic of the
// shared tile, as in K1. The int8 form stages half the bytes per row and
// issues half the ldmatrix and mma instructions, with no split adds.
//
// Numbers. bf16: dense_tiered._bf16_query_bounds budgets d*2^-23*|q||m|
// for the dot's accumulation error, the budget of K1's certificate too.
// mma_bf16.cuh derives the split accumulation's worst case,
// (min(d,16) + (ceil(d/16)-1)/2)*2^-23*sum|p_i|, within it for every d,
// and chip_smoke.py's mma-probe phase holds the card to that model (and
// runs K8 over the probe's rows). The bound terms are __fmul_rn/__fadd_rn
// (no contraction). int8: the integer dot is exact in any order
// (d*127^2 < 2^24, checked) and the rest is written op by op, so the int8
// kernel is bit-identical to its plain version (ops/kernels/scan_select_v1.py).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             scan_select_v1_launch and scan_select_int8_v1_launch on the
//             caller's stream.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_dot.cuh"
#include "scan_select_common.cuh"

using namespace scan_select;
namespace mb = mma_bf16;

namespace {

constexpr int BPB = 8;        // 128-row blocks per thread block
constexpr int MAX_TOP = 8;
constexpr int NST = 2;        // ring stages
static_assert(mb::TILE_A == QB && mb::TILE_B == BLOCK && mb::THREADS == THREADS,
              "the mma tile is one 128-row block of one query group");

// Shared memory: the score tile [QB][SSTR] and the ring (rows and
// queries): 94,208 bytes at any d and either element type, two thread
// blocks per SM.
constexpr int SCORE_BYTES = QB * SSTR * 4;
constexpr int SMEM_BYTES = SCORE_BYTES + NST * mb::stage_bytes(true);

// The top+1 selection passes over one 128-row block of uppers x (this
// thread's 8 rows x 4 queries); every thread of the block must call it
// (shuffles). Writes v[t][b][gblk] and lanes[t][b][gblk].
__device__ __forceinline__ void block_select(float (&x)[TQ][TM], int tid, int q0, int nq,
                                             int64_t gblk, int64_t g_blocks, int top,
                                             float* __restrict__ v_out,
                                             int* __restrict__ i_out) {
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int64_t b = q0 + qg * TQ + i;
    for (int t = 0; t <= top; ++t) {
      // ">=" keeps the higher lane among equal values, argmax16 likewise
      float v = x[i][0];
      int a = lane0;
#pragma unroll
      for (int r = 1; r < TM; ++r)
        if (x[i][r] >= v) {
          v = x[i][r];
          a = lane0 + r;
        }
      argmax16(v, a);
      if (rg == 0 && b < nq) {
        v_out[((int64_t)t * nq + b) * g_blocks + gblk] = v;
        if (t < top) i_out[((int64_t)t * nq + b) * g_blocks + gblk] = a;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (lane0 + r == a) x[i][r] = -INFINITY;
    }
  }
}

// One 128-row block's raw scores s[query][row] → the per-row upper bounds
// (mask_scores, Bound::kRow: -inf on invalid rows) → the selection.
__device__ __forceinline__ void select_block(const float (&s)[TQ][TM], int64_t gblk, int q0, int nq,
                                             const int* __restrict__ valid,
                                             const float* __restrict__ e_l2,
                                             const float* __restrict__ a_l2,
                                             const float* __restrict__ uq,
                                             const float* __restrict__ vq, int64_t g_blocks,
                                             int top, float* __restrict__ v_out,
                                             int* __restrict__ i_out) {
  const int tid = threadIdx.x;
  float x[TQ][TM];
  mask_scores<Bound::kRow>(s, true, gblk * BLOCK + (tid & 15) * TM, q0, tid >> 4, nq, valid, nullptr,
                           nullptr, nullptr, nullptr, e_l2, a_l2, uq, vq, x);
  block_select(x, tid, q0, nq, gblk, g_blocks, top, v_out, i_out);
}

// K8 (E = bf16) and K9 (E = int8; s_row and tq read, null for bf16).
// ALIGNED: every row starts 16-byte aligned (d a whole number of 16-byte
// vectors of E).
template <typename E, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
scan_select_v1_kernel(const E* __restrict__ q,           // [B, d]
                      const E* __restrict__ m,           // [N, d]
                      const float* __restrict__ s_row,   // [N] row scales (int8) or null
                      const float* __restrict__ tq,      // [B] query scales (int8) or null
                      const float* __restrict__ e_l2,    // [N]
                      const float* __restrict__ a_l2,    // [N]
                      const int* __restrict__ valid,     // [N]
                      const float* __restrict__ uq,      // [B]
                      const float* __restrict__ vq,      // [B]
                      float* __restrict__ v_out,         // [top+1, B, N/128]
                      int* __restrict__ i_out,           // [top, B, N/128]
                      int nq, int d, int g_blocks, int top) {
  using D = mma_dot::Dot<E>;
  constexpr bool INT8 = std::is_same<E, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + SCORE_BYTES;

  const int q0 = blockIdx.x * QB;
  const int64_t blk0 = (int64_t)blockIdx.y * BPB;
  const int n_blk = (int)min((int64_t)BPB, g_blocks - blk0);
  const int a_rows = min(QB, nq - q0);
  const int dp = D::pad(d);
  const int ks = D::slices(d);
  auto q_src = [&](int i) -> int64_t { return i < a_rows ? (int64_t)(q0 + i) * d : -1; };
  typename D::Acc acc;
  D::zero(acc);
  mb::ring_run<NST>(
      n_blk * ks, ring, mb::stage_bytes(true),
      [&](int step, unsigned char* st) {
        const int blk = step / ks, k0 = (step % ks) * D::KD;
        const int nv = min(D::KD, dp - k0) / D::VE;
        const int64_t row0 = (blk0 + blk) * BLOCK;
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
        float s[TQ][TM];
        tile_scores(acc, scores, s);
        D::zero(acc);
        const int64_t gblk = blk0 + blk;
        if constexpr (INT8) {
          scale_int8(s, s_row + gblk * BLOCK + (threadIdx.x & 15) * TM, tq, q0 + (threadIdx.x >> 4) * TQ, nq);
        }
        select_block(s, gblk, q0, nq, valid, e_l2, a_l2, uq, vq, g_blocks, top, v_out, i_out);
      });
}

bool bad_v1_shape(int nq, int d, int n, int top) {
  return nq < 1 || d < 1 || n < BLOCK || n % BLOCK != 0 || top < 1 || top > MAX_TOP ||
         (n / BLOCK + BPB - 1) / BPB > 65535;
}

dim3 grid_of(int nq, int n) {
  return dim3((nq + QB - 1) / QB, (n / BLOCK + BPB - 1) / BPB);
}

template <typename E>
int launch_v1(const void* q, const void* m, const void* s_row, const void* tq, const void* e_l2,
              const void* a_l2, const void* valid, const void* uq, const void* vq, void* v_out,
              void* i_out, int nq, int d, int n, int top, void* stream) {
  auto kernel = rows_aligned<sizeof(E)>(d) ? scan_select_v1_kernel<E, true> : scan_select_v1_kernel<E, false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(nq, n), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(m), static_cast<const float*>(s_row),
      static_cast<const float*>(tq), static_cast<const float*>(e_l2), static_cast<const float*>(a_l2),
      static_cast<const int*>(valid), static_cast<const float*>(uq), static_cast<const float*>(vq),
      static_cast<float*>(v_out), static_cast<int*>(i_out), nq, d, n / BLOCK, top);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: q [nq, d] bf16 (K8) or
// int8 (K9), m [n, d] of the same type, s_row [n] f32 (K9), e_l2/a_l2 [n]
// f32, valid [n] i32, tq [nq] f32 (K9), uq/vq [nq] f32; outputs v_out
// [top+1, nq, n/128] f32 and i_out [top, nq, n/128] i32. Requires n a
// positive multiple of 128, 1 <= top <= 8, any d >= 1 (d*127^2 < 2^24 for
// int8), 16-byte aligned q/m/s_row/e_l2/a_l2/valid. Launch on `stream`,
// allocate nothing, and return cudaGetLastError() (0 on success).
extern "C" int scan_select_v1_launch(const void* q, const void* m, const void* e_l2,
                                     const void* a_l2, const void* valid, const void* uq,
                                     const void* vq, void* v_out, void* i_out, int nq, int d,
                                     int n, int top, void* stream) {
  if (bad_v1_shape(nq, d, n, top)) return (int)cudaErrorInvalidValue;
  return launch_v1<__nv_bfloat16>(q, m, nullptr, nullptr, e_l2, a_l2, valid, uq, vq, v_out, i_out, nq,
                                  d, n, top, stream);
}

extern "C" int scan_select_int8_v1_launch(const void* q, const void* m, const void* s_row,
                                          const void* e_l2, const void* a_l2, const void* valid,
                                          const void* tq, const void* uq, const void* vq,
                                          void* v_out, void* i_out, int nq, int d, int n,
                                          int top, void* stream) {
  if (bad_v1_shape(nq, d, n, top) || (long long)d * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_v1<int8_t>(q, m, s_row, tq, e_l2, a_l2, valid, uq, vq, v_out, i_out, nq, d, n, top,
                           stream);
}
