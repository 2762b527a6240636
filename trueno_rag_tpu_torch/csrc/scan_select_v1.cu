// scan_select and scan_select_int8 for Hopper (sm_90a): the block-kernel
// ("v1") scans of the bf16 and int8 tiers with scan_kernel="block", two
// kernels that share the epilogue, two entry points at the end of this file.
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
// bf16 (K8): K1's program (scan_select_v3.cu). The eight blocks' rows and
// the group's query slices stream through a 2-stage cp.async ring of
// 64-column bf16 slices; each block's 64 x 128 score tile is the tensor-core
// dot of mma_bf16.cuh (ldmatrix + mma.sync m16n8k16, one 16-column slice
// per mma from C = 0, the slices added with __fadd_rn), which then goes
// through shared memory into the thread tiles (tile_scores). Widths round up
// to 16 with zero columns; rows whose width is not a multiple of 8 are
// staged byte by byte (row_load.cuh).
//
// int8 (K9): an exact __dp4a dot on CUDA cores over depth slices of 64 int8
// staged as packed words in shared memory, each thread's 8 x 4 tile in
// registers. (Its move to the tensor cores, with K3 and K10c, is separate.)
//
// What bounds it on the H100. At the smoke's shape (N = 1,048,576,
// d = 384, B = 256) the bf16 scan reads the 0.8 GB replica (0.25 ms at
// 3.35 TB/s) and does 2*B*N*d = 2.06e11 FLOP, 0.21 ms at the bf16
// tensor-core peak: the bytes bound it, and with the dot on the tensor
// cores what is left beside them is the selection epilogue (top+1 argmax
// passes of 4 half-warp shuffles per query and block) and the L2 and
// ldmatrix traffic of the shared tile, as in K1. The int8 scan reads
// 0.40 GB (0.12 ms); its dot runs as __dp4a, whose issue rate, not HBM,
// bounds it.
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

#include "mma_bf16.cuh"
#include "scan_select_common.cuh"

using namespace scan_select;
namespace mb = mma_bf16;

namespace {

constexpr int BPB = 8;        // 128-row blocks per thread block
constexpr int KB = 64;        // int8 depth staged per step
constexpr int KW = KB / 4;    // as 32-bit words of 4 int8 each
constexpr int MAX_TOP = 8;
constexpr int NST = 2;        // bf16 ring stages
static_assert(mb::TILE_A == QB && mb::TILE_B == BLOCK && mb::THREADS == THREADS,
              "the mma tile is one 128-row block of one query group");

// bf16 shared memory: the score tile [QB][SSTR] and the ring (rows and
// queries): 94,208 bytes at any d, two thread blocks per SM.
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

// K8. ALIGNED: d is a multiple of 8, so every row starts 16-byte aligned.
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
scan_select_v1_kernel(const __nv_bfloat16* __restrict__ q,  // [B, d]
                      const __nv_bfloat16* __restrict__ m,  // [N, d]
                      const float* __restrict__ e_l2,       // [N]
                      const float* __restrict__ a_l2,       // [N]
                      const int* __restrict__ valid,        // [N]
                      const float* __restrict__ uq,         // [B]
                      const float* __restrict__ vq,         // [B]
                      float* __restrict__ v_out,            // [top+1, B, N/128]
                      int* __restrict__ i_out,              // [top, B, N/128]
                      int nq, int d, int g_blocks, int top) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + SCORE_BYTES;

  const int q0 = blockIdx.x * QB;
  const int64_t blk0 = (int64_t)blockIdx.y * BPB;
  const int n_blk = (int)min((int64_t)BPB, g_blocks - blk0);
  const int a_rows = min(QB, nq - q0);
  const int dp = mb::pad16(d);
  const int ks = mb::k_slices(d);
  auto q_src = [&](int i) -> int64_t { return i < a_rows ? (int64_t)(q0 + i) * d : -1; };
  mb::Acc acc;
  mb::zero(acc);
  mb::ring_run<NST>(
      n_blk * ks, ring, mb::stage_bytes(true),
      [&](int step, unsigned char* st) {
        const int blk = step / ks, k0 = (step % ks) * mb::KD;
        const int nv = min(mb::KD, dp - k0) / 8;
        const int64_t row0 = (blk0 + blk) * BLOCK;
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
        float s[TQ][TM];
        tile_scores(acc, scores, s);
        mb::zero(acc);
        select_block(s, blk0 + blk, q0, nq, valid, e_l2, a_l2, uq, vq, g_blocks, top, v_out, i_out);
      });
}

// K9's staging: depth-major, so a quarter warp reads 8 consecutive 16-byte
// vectors.
struct StageInt8 {
  int a[KW][BLOCK];
  int q[KW][QB];
};

__device__ __forceinline__ void load8f(const float* __restrict__ p, float (&out)[TM]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// K9. ALIGNED: d is a multiple of 16.
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
scan_select_int8_v1_kernel(const signed char* __restrict__ q_,  // [B, d]
                           const signed char* __restrict__ m_,  // [N, d]
                           const float* __restrict__ s_row,     // [N] row scales
                           const float* __restrict__ e_l2,      // [N]
                           const float* __restrict__ a_l2,      // [N]
                           const int* __restrict__ valid,       // [N]
                           const float* __restrict__ tq,        // [B] query scales
                           const float* __restrict__ uq,        // [B]
                           const float* __restrict__ vq,        // [B]
                           float* __restrict__ v_out,           // [top+1, B, N/128]
                           int* __restrict__ i_out,             // [top, B, N/128]
                           int nq, int d, int g_blocks, int top) {
  __shared__ __align__(16) StageInt8 st;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;

  float qscale[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + qg * TQ + i;
    qscale[i] = qi < nq ? __ldg(tq + qi) : 0.0f;
  }

  for (int blk = 0; blk < BPB; ++blk) {
    const int64_t gblk = (int64_t)blockIdx.y * BPB + blk;
    if (gblk >= g_blocks) break;  // uniform over the thread block
    const int64_t row0 = gblk * BLOCK;
    int acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[i][r] = 0;

    for (int k0 = 0; k0 < d; k0 += KB) {
      // rows: 128 x 4 vectors of 16 bytes; a warp covers 32 rows of one
      // vector column, so the shared stores are conflict-free
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tid & (BLOCK - 1);
        const int part = (tid >> 7) + 2 * j;
        const uint4 w = load_row16<1, ALIGNED>(m_, (row0 + r) * d, k0 + part * 16, d);
        st.a[part * 4 + 0][r] = (int)w.x;
        st.a[part * 4 + 1][r] = (int)w.y;
        st.a[part * 4 + 2][r] = (int)w.z;
        st.a[part * 4 + 3][r] = (int)w.w;
      }
      {
        const int qq = tid & (QB - 1);
        const int part = tid >> 6;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (q0 + qq < nq) w = load_row16<1, ALIGNED>(q_, (int64_t)(q0 + qq) * d, k0 + part * 16, d);
        st.q[part * 4 + 0][qq] = (int)w.x;
        st.q[part * 4 + 1][qq] = (int)w.y;
        st.q[part * 4 + 2][qq] = (int)w.z;
        st.q[part * 4 + 3][qq] = (int)w.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KW; ++kk) {
        const int4 a0 = *reinterpret_cast<const int4*>(&st.a[kk][lane0]);
        const int4 a1 = *reinterpret_cast<const int4*>(&st.a[kk][lane0 + 4]);
        const int4 b4 = *reinterpret_cast<const int4*>(&st.q[kk][qg * TQ]);
        const int a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const int b[TQ] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[i][r] = __dp4a(a[r], b[i], acc[i][r]);
      }
      __syncthreads();
    }

    // the scaled dots, in the Pallas kernel's order, then the bounds
    float sr[TM], s[TQ][TM];
    load8f(s_row + row0 + lane0, sr);
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r) s[i][r] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][r]), sr[r]), qscale[i]);
    select_block(s, gblk, q0, nq, valid, e_l2, a_l2, uq, vq, g_blocks, top, v_out, i_out);
  }
}

bool bad_v1_shape(int nq, int d, int n, int top) {
  return nq < 1 || d < 1 || n < BLOCK || n % BLOCK != 0 || top < 1 || top > MAX_TOP ||
         (n / BLOCK + BPB - 1) / BPB > 65535;
}

dim3 grid_of(int nq, int n) {
  return dim3((nq + QB - 1) / QB, (n / BLOCK + BPB - 1) / BPB);
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
  auto kernel = rows_aligned<2>(d) ? scan_select_v1_kernel<true> : scan_select_v1_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(nq, n), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(m),
      static_cast<const float*>(e_l2), static_cast<const float*>(a_l2), static_cast<const int*>(valid),
      static_cast<const float*>(uq), static_cast<const float*>(vq), static_cast<float*>(v_out),
      static_cast<int*>(i_out), nq, d, n / BLOCK, top);
  return (int)cudaGetLastError();
}

extern "C" int scan_select_int8_v1_launch(const void* q, const void* m, const void* s_row,
                                          const void* e_l2, const void* a_l2, const void* valid,
                                          const void* tq, const void* uq, const void* vq,
                                          void* v_out, void* i_out, int nq, int d, int n,
                                          int top, void* stream) {
  if (bad_v1_shape(nq, d, n, top) || (long long)d * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = rows_aligned<1>(d) ? scan_select_int8_v1_kernel<true> : scan_select_int8_v1_kernel<false>;
  kernel<<<grid_of(nq, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const signed char*>(m),
      static_cast<const float*>(s_row), static_cast<const float*>(e_l2), static_cast<const float*>(a_l2),
      static_cast<const int*>(valid), static_cast<const float*>(tq), static_cast<const float*>(uq),
      static_cast<const float*>(vq), static_cast<float*>(v_out), static_cast<int*>(i_out), nq, d,
      n / BLOCK, top);
  return (int)cudaGetLastError();
}
