// scan_select and scan_select_int8 for Hopper (sm_90a): the block-kernel
// ("v1") scans of the bf16 and int8 tiers with scan_kernel="block", one
// template, two entry points at the end of this file.
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
// What bounds it on the H100. At the smoke's shape (N = 1,048,576,
// d = 384, B = 256) the bf16 scan reads the 0.8 GB replica (0.25 ms at
// 3.35 TB/s) and does 2*B*N*d = 2.06e11 FLOP. It keeps f32 FMA on CUDA
// cores because dense_tiered._bf16_query_bounds budgets acc_eps = d*2^-23
// for IEEE f32 accumulation in any order, which the tensor cores do not
// promise; so its ceiling is ~3.1 ms at the 67 TFLOP/s fp32 peak. The int8
// scan reads 0.40 GB (0.12 ms); its dot is exact in int32 (d*127^2 <
// 2^24, checked) and runs as __dp4a, whose issue rate, not HBM, bounds
// this first port. The design is K1's and K3's (csrc/scan_select_v3.cu,
// scan_select_int8_v3.cu): one thread block per (64-query group, eight
// 128-row blocks), the query group the fastest grid axis so a row block
// comes from HBM once and then from L2; each of the 256 threads holds an
// 8-row x 4-query register tile fed by 16-byte shared-memory loads; the
// tile never leaves registers: the selection runs on it with half-warp
// shuffles (the 16 threads holding one query's 128 rows share a
// half-warp), so the only writes are the (2*top+1)*B*N/128 outputs.
//
// Numbers. bf16: a product of two bf16 values is exact in f32 and fmaf
// rounds once, so the dot is an f32 sum of exact products in some order,
// inside the acc_eps budget; the bound terms are __fmul_rn/__fadd_rn (no
// contraction). int8: the integer dot is exact in any order and the rest
// is written op by op, so the int8 kernel is bit-identical to its plain
// version (ops/kernels/scan_select_v1.py).
//
// Any width d >= 1: rows whose width is not a multiple of the 16-byte
// vector load through row_load.cuh.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             scan_select_v1_launch and scan_select_int8_v1_launch on the
//             caller's stream.

#include <cuda_bf16.h>

#include <type_traits>

#include "scan_select_common.cuh"

using namespace scan_select;

namespace {

constexpr int BPB = 8;        // 128-row blocks per thread block
constexpr int KC = 32;        // bf16 depth staged per step (as f32)
constexpr int KB = 64;        // int8 depth staged per step
constexpr int KW = KB / 4;    // as 32-bit words of 4 int8 each
constexpr int MAX_TOP = 8;

template <bool INT8>
struct Stage {
  // depth-major: a quarter warp reads 8 consecutive 16-byte vectors
  typename std::conditional<INT8, int, float>::type a[INT8 ? KW : KC][BLOCK];
  typename std::conditional<INT8, int, float>::type q[INT8 ? KW : KC][QB];
};

__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void load8f(const float* __restrict__ p, float (&out)[TM]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

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

template <bool INT8, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
scan_select_v1_kernel(const void* __restrict__ q_,        // [B, d] bf16 or int8
                      const void* __restrict__ m_,        // [N, d] bf16 or int8
                      const float* __restrict__ s_row,    // [N] row scales (int8) or null
                      const float* __restrict__ e_l2,     // [N]
                      const float* __restrict__ a_l2,     // [N]
                      const int* __restrict__ valid,      // [N]
                      const float* __restrict__ tq,       // [B] query scales (int8) or null
                      const float* __restrict__ uq,       // [B]
                      const float* __restrict__ vq,       // [B]
                      float* __restrict__ v_out,          // [top+1, B, N/128]
                      int* __restrict__ i_out,            // [top, B, N/128]
                      int nq, int d, int g_blocks, int top) {
  __shared__ __align__(16) Stage<INT8> st;
  constexpr int ES = INT8 ? 1 : 2;  // bytes per element

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;

  float qscale[TQ], uqv[TQ], vqv[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + qg * TQ + i;
    qscale[i] = (INT8 && qi < nq) ? __ldg(tq + qi) : 0.0f;
    uqv[i] = qi < nq ? __ldg(uq + qi) : 0.0f;
    vqv[i] = qi < nq ? __ldg(vq + qi) : 0.0f;
  }

  for (int blk = 0; blk < BPB; ++blk) {
    const int64_t gblk = (int64_t)blockIdx.y * BPB + blk;
    if (gblk >= g_blocks) break;  // uniform over the thread block
    const int64_t row0 = gblk * BLOCK;
    typename std::conditional<INT8, int, float>::type acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[i][r] = 0;

    const int step = INT8 ? KB : KC;
    for (int k0 = 0; k0 < d; k0 += step) {
      // rows: 128 x 4 vectors of 16 bytes; a warp covers 32 rows of one
      // vector column, so the shared stores are conflict-free
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tid & (BLOCK - 1);
        const int part = (tid >> 7) + 2 * j;
        const int kk = k0 + part * (16 / ES);
        const uint4 w = load_row16<ES, ALIGNED>(m_, (row0 + r) * d, kk, d);
        if constexpr (INT8) {
          st.a[part * 4 + 0][r] = (int)w.x;
          st.a[part * 4 + 1][r] = (int)w.y;
          st.a[part * 4 + 2][r] = (int)w.z;
          st.a[part * 4 + 3][r] = (int)w.w;
        } else {
          float f[8];
          unpack8(w, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) st.a[part * 8 + e][r] = f[e];
        }
      }
      {
        const int qq = tid & (QB - 1);
        const int part = tid >> 6;
        const int kk = k0 + part * (16 / ES);
        uint4 w = make_uint4(0, 0, 0, 0);
        if (q0 + qq < nq) w = load_row16<ES, ALIGNED>(q_, (int64_t)(q0 + qq) * d, kk, d);
        if constexpr (INT8) {
          st.q[part * 4 + 0][qq] = (int)w.x;
          st.q[part * 4 + 1][qq] = (int)w.y;
          st.q[part * 4 + 2][qq] = (int)w.z;
          st.q[part * 4 + 3][qq] = (int)w.w;
        } else {
          float f[8];
          unpack8(w, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) st.q[part * 8 + e][qq] = f[e];
        }
      }
      __syncthreads();
      if constexpr (INT8) {
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
      } else {
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&st.a[kk][lane0]);
          const float4 a1 = *reinterpret_cast<const float4*>(&st.a[kk][lane0 + 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&st.q[kk][qg * TQ]);
          const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[TQ] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int r = 0; r < TM; ++r) acc[i][r] = fmaf(a[r], b[i], acc[i][r]);
        }
      }
      __syncthreads();
    }

    // per-row upper bounds, in the Pallas kernels' order; -inf when invalid
    float el[TM], al[TM], sr[TM];
    load8f(e_l2 + row0 + lane0, el);
    load8f(a_l2 + row0 + lane0, al);
    if constexpr (INT8) load8f(s_row + row0 + lane0, sr);
    bool ok[TM];
    int bits[TM];
    load_rows(valid, nullptr, row0 + lane0, ok, bits);
    float x[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        float s;
        if constexpr (INT8) {
          s = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][r]), sr[r]), qscale[i]);
        } else {
          s = acc[i][r];
        }
        const float up = __fadd_rn(__fadd_rn(s, __fmul_rn(el[r], uqv[i])), __fmul_rn(al[r], vqv[i]));
        x[i][r] = ok[r] ? up : -INFINITY;
      }
    }
    block_select(x, tid, q0, nq, gblk, g_blocks, top, v_out, i_out);
  }
}

bool bad_v1_shape(int nq, int d, int n, int top) {
  return nq < 1 || d < 1 || n < BLOCK || n % BLOCK != 0 || top < 1 || top > MAX_TOP ||
         (n / BLOCK + BPB - 1) / BPB > 65535;
}

template <bool INT8>
int launch(const void* q, const void* m, const void* s_row, const void* e_l2, const void* a_l2,
           const void* valid, const void* tq, const void* uq, const void* vq, void* v_out,
           void* i_out, int nq, int d, int n, int top, void* stream) {
  const int g_blocks = n / BLOCK;
  const dim3 grid((nq + QB - 1) / QB, (g_blocks + BPB - 1) / BPB);
  auto kernel = rows_aligned<INT8 ? 1 : 2>(d) ? scan_select_v1_kernel<INT8, true> : scan_select_v1_kernel<INT8, false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, m, static_cast<const float*>(s_row), static_cast<const float*>(e_l2),
      static_cast<const float*>(a_l2), static_cast<const int*>(valid),
      static_cast<const float*>(tq), static_cast<const float*>(uq),
      static_cast<const float*>(vq), static_cast<float*>(v_out), static_cast<int*>(i_out), nq,
      d, g_blocks, top);
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
  return launch<false>(q, m, nullptr, e_l2, a_l2, valid, nullptr, uq, vq, v_out, i_out, nq, d,
                       n, top, stream);
}

extern "C" int scan_select_int8_v1_launch(const void* q, const void* m, const void* s_row,
                                          const void* e_l2, const void* a_l2, const void* valid,
                                          const void* tq, const void* uq, const void* vq,
                                          void* v_out, void* i_out, int nq, int d, int n,
                                          int top, void* stream) {
  if (bad_v1_shape(nq, d, n, top) || (long long)d * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<true>(q, m, s_row, e_l2, a_l2, valid, tq, uq, vq, v_out, i_out, nq, d, n, top,
                      stream);
}
