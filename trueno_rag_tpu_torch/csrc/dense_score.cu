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
// Both entry points run one template in one summation order (each score a
// chain of fmaf over the depth, first column first), so blockmax_only's
// maxima are bit-equal to score_blockmax's.
//
// What bounds it on the H100. At the smoke's shape (N = 1,048,576, d = 384,
// B = 256) the scan is 2*B*N*d = 2.06e11 FLOP, 3.1 ms at the 67 TFLOP/s
// fp32 peak, against 1.6 GB of rows read plus, for score_blockmax, 1.07 GB
// of scores written (0.8 ms at 3.35 TB/s): the fp32 operations bound both.
// The design keeps the FMA pipes fed:
//   - one thread block per (128-query tile, 128-row block), the query tile
//     the fastest grid axis, so a row block comes from HBM once and then
//     from L2; each of the 256 threads holds an 8-row x 8-query register
//     tile (rows 4t..4t+3 and 64+4t..64+4t+3, queries likewise), fed by
//     four float4 shared-memory loads per 64 FMAs; the row loads of a
//     quarter-warp are 128 consecutive bytes and the query loads a
//     broadcast, so no bank is read twice;
//   - the depth runs in 16-deep slabs through a 2-buffer shared ring: the
//     next slab's global loads go to registers before this slab's FMAs and
//     are stored transposed, depth-major, into the other buffer after them,
//     one barrier per slab;
//   - scores leave as 16-byte vectors of 4 consecutive rows (a half-warp
//     writes 256 consecutive bytes of one query) when N % 4 == 0, else
//     one float at a time; the 128-row block max of a query is a shuffle
//     over the 16 threads holding its rows, so blockmax_only writes no
//     score at all.
//
// Any width d >= 1 (row_load.cuh) and any N >= 1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             score_blockmax_launch and blockmax_only_launch on the
//             caller's stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "row_load.cuh"

namespace {

constexpr int BLOCK = 128;  // rows per block maximum, and per thread block
constexpr int QT = 128;     // queries per thread block
constexpr int THREADS = 256;
constexpr int KC = 16;      // depth per slab
constexpr int LDS = 132;    // floats per slab row (rows or queries), padded

template <bool SCORES, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
dense_score_kernel(const float* __restrict__ q,             // [B, d]
                   const float* __restrict__ m,             // [N, d]
                   const unsigned char* __restrict__ valid, // [N] bool
                   float* __restrict__ scores,              // [B, N] (SCORES only)
                   float* __restrict__ bmax,                // [B, G]
                   int nq, int d, int n, int g_blocks, int n_qt) {
  __shared__ __align__(16) float As[2][KC][LDS];  // rows, depth-major
  __shared__ __align__(16) float Qs[2][KC][LDS];  // queries, depth-major

  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x % n_qt) * QT;
  const int64_t gblk = blockIdx.x / n_qt;
  const int64_t row0 = gblk * BLOCK;
  // staging: rows (queries) sr and sr + 64, depth columns 4 sp .. 4 sp + 3
  // of the slab; a warp reads 8 whole 64-byte row segments
  const int sr = tid >> 2, sp = tid & 3;
  // compute: rows 4 tr + {0..3} and 64 + 4 tr + {0..3}, queries likewise
  // with tq
  const int tr = tid & 15, tq = tid >> 4;

  uint4 pa[2], pq[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t row = row0 + sr + 64 * j;
      const int qq = q0 + sr + 64 * j;
      pa[j] = row < n ? load_row16<4, ALIGNED>(m, row * d, k0 + sp * 4, d) : make_uint4(0, 0, 0, 0);
      pq[j] = qq < nq ? load_row16<4, ALIGNED>(q, (int64_t)qq * d, k0 + sp * 4, d) : make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = sr + 64 * j;
      As[buf][sp * 4 + 0][c] = __uint_as_float(pa[j].x);
      As[buf][sp * 4 + 1][c] = __uint_as_float(pa[j].y);
      As[buf][sp * 4 + 2][c] = __uint_as_float(pa[j].z);
      As[buf][sp * 4 + 3][c] = __uint_as_float(pa[j].w);
      Qs[buf][sp * 4 + 0][c] = __uint_as_float(pq[j].x);
      Qs[buf][sp * 4 + 1][c] = __uint_as_float(pq[j].y);
      Qs[buf][sp * 4 + 2][c] = __uint_as_float(pq[j].z);
      Qs[buf][sp * 4 + 3][c] = __uint_as_float(pq[j].w);
    }
  };

  float acc[8][8];  // [query][row]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[i][r] = 0.0f;

  const int n_slab = (d + KC - 1) / KC;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int sl = 0; sl < n_slab; ++sl) {
    const int buf = sl & 1;
    if (sl + 1 < n_slab) fetch((sl + 1) * KC);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Qs[buf][kk][tq * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Qs[buf][kk][64 + tq * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[i][r] = fmaf(a[r], b[i], acc[i][r]);
    }
    if (sl + 1 < n_slab) stash(buf ^ 1);  // buf ^ 1 was last read before the previous barrier
    __syncthreads();
  }

  bool ok[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t row = row0 + (r < 4 ? 0 : 64) + tr * 4 + (r & 3);
    ok[r] = row < n && valid[row] != 0;
  }
  const bool vec = (n & 3) == 0;  // a 4-row group starts 16-byte aligned and lies below n or past it
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t b = q0 + (i < 4 ? 0 : 64) + tq * 4 + (i & 3);
    float s[8];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      s[r] = ok[r] ? acc[i][r] : -INFINITY;
      mx = fmaxf(mx, s[r]);
    }
    if (SCORES && b < nq) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + 64 * h + tr * 4;
        float* dst = scores + b * n + row;
        if (vec) {
          if (row < n) *reinterpret_cast<float4*>(dst) = make_float4(s[4 * h], s[4 * h + 1], s[4 * h + 2], s[4 * h + 3]);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (row + r < n) dst[r] = s[4 * h + r];
        }
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (tr == 0 && b < nq) bmax[b * g_blocks + gblk] = mx;
  }
}

template <bool SCORES>
int launch(const void* q, const void* m, const void* valid, void* scores, void* bmax, int nq,
           int d, int n, void* stream) {
  const int g_blocks = (n + BLOCK - 1) / BLOCK;
  const int n_qt = (nq + QT - 1) / QT;
  if (nq < 1 || d < 1 || n < 1 || (int64_t)g_blocks * n_qt > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = rows_aligned<4>(d) ? dense_score_kernel<SCORES, true> : dense_score_kernel<SCORES, false>;
  kernel<<<g_blocks * n_qt, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(m),
      static_cast<const unsigned char*>(valid), static_cast<float*>(scores),
      static_cast<float*>(bmax), nq, d, n, g_blocks, n_qt);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: q [nq, d] f32, m [n, d]
// f32, valid [n] bool; outputs scores [nq, n] f32 (score_blockmax only) and
// bmax [nq, ceil(n/128)] f32. Any nq, d, n >= 1;
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
