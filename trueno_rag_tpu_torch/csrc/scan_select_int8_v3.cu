// scan_select_int8_v3 for Hopper (sm_90a): the certified int8 tile scan,
// and its v2 sibling scan_select_int8_v2 (one template, two entry points
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
// This first port computes the dot with __dp4a (four int8 products and an
// int32 add per instruction) on CUDA cores, in K1's register tiling: one
// thread block per (64-query group, 1024-row tile), each thread an
// 8-row x 4-query tile of int32 sums fed by int4 shared-memory loads (3
// loads per 32 dp4a). dp4a's instruction rate, not HBM, then bounds the
// kernel: if dp4a runs at the integer multiply-add rate (64 per SM per clock),
// 132 SMs x 64 x 8 operations x 1.98 GHz ~ 134 TOP/s gives >= 1.5 ms.
// Integer accumulation is exact, so moving the dot to mma.sync/wgmma s8
// tensor cores needs no re-derived bound (unlike K1).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             at the end of this file on the caller's stream.

#include "scan_select_common.cuh"

using namespace scan_select;

namespace {

constexpr int KB = 64;      // int8 depth staged per step
constexpr int KW = KB / 4;  // as 32-bit words of 4 int8 each

template <bool ALIGNED, Bound BF>
__global__ void __launch_bounds__(THREADS, 2)
scan_select_int8_v3_kernel(const int8_t* __restrict__ q,      // [B, d]
                           const int8_t* __restrict__ m,      // [N, d]
                           const float* __restrict__ s_row,   // [N] row scales
                           const float* __restrict__ eb,      // kBlock: [N/128] block max e_l2; kRow: [N] e_l2
                           const float* __restrict__ ab,      // kBlock: [N/128] block max a_l2; kRow: [N] a_l2
                           const int* __restrict__ valid,     // [N]
                           const float* __restrict__ tq,      // [B] query scales
                           const float* __restrict__ uq,      // [B]
                           const float* __restrict__ vq,      // [B]
                           const int* __restrict__ tag_bits,  // [N] or null: no filter
                           const int* __restrict__ t_all,     // [B]
                           const int* __restrict__ t_any,     // [B]
                           const int* __restrict__ t_none,    // [B]
                           float* __restrict__ v_pack,        // [B, T+1, G]
                           int* __restrict__ r_pack,          // [B, T, G]
                           int nq, int d, int g_tiles, int t_top) {
  __shared__ __align__(16) int As[KW][BLOCK];  // staged rows, depth-major words
  __shared__ __align__(16) int Qs[KW][QB];     // staged queries, depth-major words
  __shared__ SelectSmem sel;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;

  float tqv[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + qg * TQ + i;
    tqv[i] = qi < nq ? __ldg(tq + qi) : 0.0f;
  }

  for (int blk = 0; blk < BPT; ++blk) {
    const int64_t row0 = (int64_t)tile * SEL + blk * BLOCK;
    int acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[i][r] = 0;

    for (int k0 = 0; k0 < d; k0 += KB) {
      // rows: 128 x 4 vectors of 16 int8; a warp covers 32 rows of one
      // vector column, so the shared stores are conflict-free
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tid & (BLOCK - 1);
        const int part = (tid >> 7) + 2 * j;
        const int kk = k0 + part * 16;
        const uint4 w = load_row16<1, ALIGNED>(m, (row0 + r) * d, kk, d);
        As[part * 4 + 0][r] = (int)w.x;
        As[part * 4 + 1][r] = (int)w.y;
        As[part * 4 + 2][r] = (int)w.z;
        As[part * 4 + 3][r] = (int)w.w;
      }
      {
        const int qq = tid & (QB - 1);
        const int part = tid >> 6;
        const int kk = k0 + part * 16;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (q0 + qq < nq) w = load_row16<1, ALIGNED>(q, (int64_t)(q0 + qq) * d, kk, d);
        Qs[part * 4 + 0][qq] = (int)w.x;
        Qs[part * 4 + 1][qq] = (int)w.y;
        Qs[part * 4 + 2][qq] = (int)w.z;
        Qs[part * 4 + 3][qq] = (int)w.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KW; ++kk) {
        const int4 a0 = *reinterpret_cast<const int4*>(&As[kk][lane0]);
        const int4 a1 = *reinterpret_cast<const int4*>(&As[kk][lane0 + 4]);
        const int4 b4 = *reinterpret_cast<const int4*>(&Qs[kk][qg * TQ]);
        const int a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const int b[TQ] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[i][r] = __dp4a(a[r], b[i], acc[i][r]);
      }
      __syncthreads();
    }

    // dequantize in the JAX code's order, then the per-row bounds (kRow)
    // and -inf on invalid rows and on rows failing the query's filter
    const float4 sa = __ldg(reinterpret_cast<const float4*>(s_row + row0 + lane0));
    const float4 sb = __ldg(reinterpret_cast<const float4*>(s_row + row0 + lane0 + 4));
    const float sr[TM] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    float s[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r)
        s[i][r] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][r]), sr[r]), tqv[i]);
    float x[TQ][TM];
    mask_scores<BF>(s, true, row0 + lane0, q0, qg, nq, valid, tag_bits, t_all, t_any, t_none, eb,
                    ab, uq, vq, x);
    block_candidates<BF>(x, tid, q0, nq, row0, blk, tile * BPT + blk, eb, ab, uq, vq, sel);
  }
  __syncthreads();
  tile_tournament(sel, tid, q0, nq, tile, g_tiles, t_top, v_pack, r_pack);
}

template <Bound BF>
int launch(const void* q, const void* m, const void* s_row, const void* eb, const void* ab,
           const void* valid, const void* tq, const void* uq, const void* vq,
           const void* tag_bits, const void* t_all, const void* t_any, const void* t_none,
           void* v_pack, void* r_pack, int nq, int d, int n, int t_top, void* stream) {
  if (bad_shape(nq, d, n, t_top) || (long long)d * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nq + QB - 1) / QB, n / SEL);
  auto kernel = rows_aligned<1>(d) ? scan_select_int8_v3_kernel<true, BF>
                                   : scan_select_int8_v3_kernel<false, BF>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(m),
      static_cast<const float*>(s_row), static_cast<const float*>(eb),
      static_cast<const float*>(ab), static_cast<const int*>(valid),
      static_cast<const float*>(tq), static_cast<const float*>(uq),
      static_cast<const float*>(vq), static_cast<const int*>(tag_bits),
      static_cast<const int*>(t_all), static_cast<const int*>(t_any),
      static_cast<const int*>(t_none), static_cast<float*>(v_pack),
      static_cast<int*>(r_pack), nq, d, n / SEL, t_top);
  return (int)cudaGetLastError();
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
// bit-identical to its plain version. What bounds it is K3's: the __dp4a
// instruction rate on CUDA cores; the per-row bound adds 4*B*N operations and
// N*8 bytes.
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
