// score_blockmax and blockmax_only for Hopper (sm_90a): the exact fp32
// dense scan with per-128-row block maxima, one template, two entry points
// at the end of this file.
//
// Replaces the Pallas TPU kernels
//   trueno_rag_tpu/ops/pallas/dense_score.py::score_blockmax
//     (pallas_call at dense_score.py:75)
//   trueno_rag_tpu/ops/pallas/dense_score.py::blockmax_only
//     (pallas_call at dense_score.py:124)
// Semantics, for queries q [B, d] f32, rows m [N, d] f32 and valid [N]:
//   s[b, i] = q_b . m_i in f32 (-inf where valid[i] is false);
//   bmax[b, g] = max over the rows of 128-row block g of s[b, :]
// score_blockmax writes s [B, N] once and bmax [B, ceil(N/128)];
// blockmax_only writes only bmax (its caller rescores the few selected
// blocks). A ragged last block takes the max over its real rows.
//
// The product is computed here, in f32 on CUDA cores, as the Pallas kernel
// computes it in its own body: no cuBLAS call and no TF32. f32 products
// round once each and every sum is an f32 add in some order, so a score
// differs from any other f32 evaluation by at most ~2(d+1)*2^-24*sum|q m|.
//
// What bounds it on the H100. At the smoke's shape (N = 1,048,576, d = 384,
// B = 256) the scan is 2*B*N*d = 2.06e11 FLOP, 3.1 ms at the 67 TFLOP/s
// fp32 peak, against 1.6 GB of rows read plus, for score_blockmax, 1.07 GB
// of scores written (0.8 ms at 3.35 TB/s): the fp32 operations bound both.
// The design is K1's register tiling (csrc/scan_select_v3.cu) in f32: one
// thread block per (64-query group, eight 128-row blocks), the query group
// the fastest grid axis so a row block comes from HBM once and then from
// L2; each of the 256 threads holds an 8-row x 4-query tile fed by float4
// shared-memory loads (3 loads per 32 FMAs); the block max is a half-warp
// shuffle on that tile, so blockmax_only never writes a score. Scores are
// written as each thread's 8 consecutive rows, 128 consecutive floats per
// query across a half-warp.
//
// Any width d >= 1 (row_load.cuh) and any N >= 1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             score_blockmax_launch and blockmax_only_launch on the
//             caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_load.cuh"

namespace {

constexpr int BLOCK = 128;  // rows per block maximum
constexpr int BPB = 8;      // 128-row blocks per thread block
constexpr int QB = 64;      // queries per thread block
constexpr int THREADS = 256;
constexpr int TM = 8;       // rows per thread
constexpr int TQ = 4;       // queries per thread
constexpr int KC = 32;      // depth staged per step

template <bool SCORES, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
dense_score_kernel(const float* __restrict__ q,             // [B, d]
                   const float* __restrict__ m,             // [N, d]
                   const unsigned char* __restrict__ valid, // [N] bool
                   float* __restrict__ scores,              // [B, N] (SCORES only)
                   float* __restrict__ bmax,                // [B, G]
                   int nq, int d, int n, int g_blocks) {
  __shared__ __align__(16) float As[KC][BLOCK];  // staged rows, depth-major
  __shared__ __align__(16) float Qs[KC][QB];     // staged queries, depth-major

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;

  for (int blk = 0; blk < BPB; ++blk) {
    const int64_t gblk = (int64_t)blockIdx.y * BPB + blk;
    if (gblk >= g_blocks) break;  // uniform over the thread block
    const int64_t row0 = gblk * BLOCK;
    float acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[i][r] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += KC) {
      // rows: 128 x 8 vectors of 4 f32; a warp covers 32 rows of one
      // vector column, so the shared stores are conflict-free
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tid & (BLOCK - 1);
        const int part = (tid >> 7) + 2 * j;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (row0 + r < n) w = load_row16<4, ALIGNED>(m, (row0 + r) * d, k0 + part * 4, d);
        As[part * 4 + 0][r] = __uint_as_float(w.x);
        As[part * 4 + 1][r] = __uint_as_float(w.y);
        As[part * 4 + 2][r] = __uint_as_float(w.z);
        As[part * 4 + 3][r] = __uint_as_float(w.w);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qq = tid & (QB - 1);
        const int part = (tid >> 6) + 4 * j;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (q0 + qq < nq) w = load_row16<4, ALIGNED>(q, (int64_t)(q0 + qq) * d, k0 + part * 4, d);
        Qs[part * 4 + 0][qq] = __uint_as_float(w.x);
        Qs[part * 4 + 1][qq] = __uint_as_float(w.y);
        Qs[part * 4 + 2][qq] = __uint_as_float(w.z);
        Qs[part * 4 + 3][qq] = __uint_as_float(w.w);
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

    bool ok[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t row = row0 + lane0 + r;
      ok[r] = row < n && valid[row] != 0;
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int64_t b = q0 + qg * TQ + i;
      float v = -INFINITY;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float s = ok[r] ? acc[i][r] : -INFINITY;
        v = fmaxf(v, s);
        if (SCORES && b < nq && row0 + lane0 + r < n) scores[b * n + row0 + lane0 + r] = s;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (rg == 0 && b < nq) bmax[b * g_blocks + gblk] = v;
    }
  }
}

template <bool SCORES>
int launch(const void* q, const void* m, const void* valid, void* scores, void* bmax, int nq,
           int d, int n, void* stream) {
  const int g_blocks = (n + BLOCK - 1) / BLOCK;
  if (nq < 1 || d < 1 || n < 1 || (g_blocks + BPB - 1) / BPB > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nq + QB - 1) / QB, (g_blocks + BPB - 1) / BPB);
  auto kernel = rows_aligned<4>(d) ? dense_score_kernel<SCORES, true> : dense_score_kernel<SCORES, false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(m),
      static_cast<const unsigned char*>(valid), static_cast<float*>(scores),
      static_cast<float*>(bmax), nq, d, n, g_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: q [nq, d] f32, m [n, d]
// f32, valid [n] bool; outputs scores [nq, n] f32 (score_blockmax only) and
// bmax [nq, ceil(n/128)] f32. Any nq, d, n >= 1 with ceil(n/1024) <= 65535;
// q and m 16-byte aligned. Launch on `stream`, allocate nothing, and return
// cudaGetLastError() (0 on success).
extern "C" int score_blockmax_launch(const void* q, const void* m, const void* valid,
                                     void* scores, void* bmax, int nq, int d, int n,
                                     void* stream) {
  return launch<true>(q, m, valid, scores, bmax, nq, d, n, stream);
}

extern "C" int blockmax_only_launch(const void* q, const void* m, const void* valid, void* bmax,
                                    int nq, int d, int n, void* stream) {
  return launch<false>(q, m, valid, nullptr, bmax, nq, d, n, stream);
}
