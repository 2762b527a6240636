// maxsim_scan16_scores, maxsim_scan_int8_scores and the l-major v2 pair
// maxsim_scan16_scores_v2 / maxsim_scan16_scores_self_v2 for Hopper
// (sm_90a): the late-interaction tiers' bound pass, one template, four entry
// points at the end of this file.
//
// Replaces the Pallas TPU kernels
//   trueno_rag_tpu/ops/pallas/maxsim_scan.py::maxsim_scan16_scores
//     (pallas_call at maxsim_scan.py:268)
//   trueno_rag_tpu/ops/pallas/maxsim_scan.py::maxsim_scan_int8_scores
//     (pallas_call at maxsim_scan.py:344)
//   trueno_rag_tpu/ops/pallas/maxsim_scan.py::maxsim_scan16_scores_v2
//     (pallas_call at maxsim_scan.py:512)
//   trueno_rag_tpu/ops/pallas/maxsim_scan.py::maxsim_scan16_scores_self_v2
//     (pallas_call at maxsim_scan.py:564)
// Semantics, for every query b and chunk n:
//   out[b, n] = sum_i best_i,  best_i = max_j <q_i, tok_j>   (bf16)
//   out[b, n] = sum_i t_q[b, i] * best_i,
//               best_i = max_j f32(<q8_i, tok8_j>) * s_tok[n, j]   (int8)
// where j runs over the chunk's valid tokens (t_mask), a best with no valid
// token (an empty chunk) counts 0, and an invalid chunk (valid == 0) scores
// -inf. The query tokens are b-major ([B, Lq, H]); padding query tokens are
// zero, so their best is exactly 0. The Lq-sum runs over i in ascending
// order, one f32 rounding per add (and per multiply in the int8 form), as
// the plain versions in ops/kernels/maxsim_scan.py do.
//
// Layout. One thread block per (128-chunk tile, group of QG whole queries).
// A group holds QG = min(16, max(1, 64 / Lq)) queries, whose QG*Lq query
// tokens run through sub-tiles of 64 rows, so B*Lq*H never has to fit in
// shared memory and any Lq works. For each sub-tile the block walks the
// chunks' Lt token positions; for each position j it stages a depth slice
// of the 128 chunks' token j and of the 64 query rows in shared memory
// (converted to f32, or kept as packed int8 words) and each of the 256
// threads accumulates an 8-chunk x 4-row register tile of dots. After the
// full depth the tile's dots fold into a running max (masked tokens are
// skipped), so the [B*Lq, N*Lt] interaction never leaves registers. The
// bests then pass through shared memory for the ordered Lq-sum. The
// [N, Lt, H] replica is read in place at any N, Lt, B and H: a width H
// that is not a multiple of the 16-byte vector (8 bf16, 16 int8) has no
// aligned rows and a ragged last vector, so those loads go byte by byte
// with the columns past H read as zero (row_load.cuh), which adds exactly
// 0 to every dot; the zero-copy tier keeps reading the stored tokens in
// place at any width. The Pallas
// wrapper's TPU workarounds (the Lt-to-32 pad copy, the ragged-tail split,
// the VMEM-sized tiles and query slabs) have no counterpart here.
//
// Numbers. bf16: products of two bf16 values are exact in f32 and each
// __fmaf_rn rounds once, so a dot is an f32 sum of exact products in some
// order; its error stays inside the certificate's kappa = (H+Lq)*2^-23
// share (ops/maxsim.py::_scan16_fused_widths) for any order. Tensor cores
// (mma/wgmma) do not promise IEEE f32 rounding of their accumulation, so
// they are not used until kappa is re-derived for them. int8: |q8|, |tok8|
// <= 127 and H*127^2 < 2^24 (the wrapper checks H), so the __dp4a integer
// dot is exact in any order and its conversion to f32 is exact; with the
// scale multiplies and adds written as __fmul_rn/__fadd_rn (no contraction)
// the result is bit-identical to the plain version.
//
// The v2 pair (LAYOUT kLMajor and kSelf). The same bf16 dot program, with
// the padding excluded by an additive f32 bias instead of a skip: bias_l
// holds 0 at valid tokens and -2^30 at padding, l-major within each group
// of `group` chunks, so chunk c's position l sits at
//   ((c / group) * Lt + l) * group + c % group.
// kLMajor (K11a) reads the tokens from the l-major pack at that index (Lt
// there is the pack's padded Lt_p, whose pad positions carry the bias);
// kSelf (K11b) reads the primary [N, Lt, H] tokens in place at c*Lt + l,
// as K6 does, and only the bias l-major. Each dot gets its bias added with
// __fadd_rn (never contracted into the dot's last FMA), every position is
// maxed, and a best at or below -2^29 (an empty chunk) resets to 0. Adding
// 0.0 to a dot is exact, and a dot never starts at -0, so on the same bf16
// values and valid tokens the v2 scores equal K6's bit for bit: the same
// dot order, the same max over the valid dots, the same ordered Lq-sum.
// Each chunk computes its own index, so a 128-chunk tile may straddle
// groups and any group >= 1 works; offsets are 64-bit (a 1M x 32 x 128
// pack holds 4.3e9 elements).
//
// What bounds it on the H100. At the JAX package's serving shape (N =
// 1,048,576 chunks x Lt 32 x H 128, B = 8, Lq = 8) the bf16 form is
// 2*B*Lq*N*Lt*H = 5.5e11 FLOP of f32 FMA, 8.2 ms at the 67 TFLOP/s CUDA-core
// peak, against 2.6 ms to stream the 8.6 GB replica: the FMA rate is the
// bound, so the design keeps 32 FMAs per 3 shared-memory vector loads.
// The int8 form at 2,097,152 chunks is 1.1e12 integer operations, 0.56 ms
// at the int8 tensor-core peak, against 2.7 ms of bytes; __dp4a on CUDA
// cores runs far below that peak, so here too the dot's instruction rate,
// not HBM, is what this first port will meet.
//
// The v2 pair does K6's work (the bias read adds 4 bytes per token
// position, a sixteenth of the row), so the same FMA rate bounds it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             maxsim_scan16_launch, maxsim_scan_int8_launch,
//             maxsim_scan16_v2_launch and maxsim_scan16_self_v2_launch on
//             the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_load.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CT = 128;     // chunks per block
constexpr int RT = 64;      // query-token rows per sub-tile
constexpr int QG_MAX = 16;  // whole queries per block
constexpr int TC = 8;       // chunks per thread: cg*4 .. +3 and 64 + cg*4 .. +3
constexpr int TR = 4;       // query rows per thread: rg*4 .. +3
constexpr int KF = 32;      // bf16 depth staged per step (as f32)
constexpr int KW = 16;      // int8 depth staged per step, in words of 4 (64 int8)

static_assert((CT / TC) * (RT / TR) == THREADS, "the thread tiles cover the block tile");

// How a chunk's token rows are found and its padding excluded.
enum Layout {
  kMask = 0,    // K6/K7: tokens [N, Lt, H]; t_mask skips padding
  kLMajor = 1,  // K11a: the l-major pack; bias_l added
  kSelf = 2,    // K11b: tokens [N, Lt, H] in place; bias_l added
};
constexpr float MASK_BIAS = -1073741824.0f;  // -2^30, the pack's padding bias
constexpr float EMPTY_BELOW = -536870912.0f;  // -2^29: a best at or below is an empty chunk's

// Element index of chunk c's position l in an l-major grouped layout.
__device__ __forceinline__ int64_t lmajor_index(int64_t c, int l, int lt, int group) {
  return ((c / group) * lt + l) * (int64_t)group + c % group;
}

// Shared memory: the staging buffers and the bests of a sub-tile are never
// live together, so they share storage.
template <bool INT8>
struct Smem {
  union {
    struct {
      // depth-major: a quarter warp reads 8 consecutive float4 / int4
      typename std::conditional<INT8, int, float>::type tok[INT8 ? KW : KF][CT];
      typename std::conditional<INT8, int, float>::type q[INT8 ? KW : KF][RT];
    } stage;
    float best[RT][CT];  // a sub-tile's bests (0 for an empty chunk)
  } u;
  unsigned char mask[CT];  // t_mask[chunk, j] of the current position (kMask)
  float scale[CT];         // s_tok[chunk, j] (int8 only)
  float bias[CT];          // bias_l at chunk, j (kLMajor, kSelf)
  float sum[QG_MAX][CT];   // running Lq-sums of the block's queries
};

__device__ __forceinline__ void unpack_bf16x8(uint4 raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

template <bool INT8, bool ALIGNED, int LAYOUT>
__global__ void __launch_bounds__(THREADS, 2)
maxsim_scan_kernel(const void* __restrict__ q_,          // [B*Lq, H] bf16 or int8
                   const float* __restrict__ tq,         // [B*Lq] query scales (int8) or null
                   const void* __restrict__ tok_,        // [N*Lt, H] bf16 or int8, or the l-major pack
                   const float* __restrict__ s_tok,      // [N*Lt] token scales (int8) or null
                   const unsigned char* __restrict__ t_mask,  // [N*Lt] bool (kMask) or null
                   const float* __restrict__ bias_l,     // l-major mask bias (kLMajor, kSelf) or null
                   const unsigned char* __restrict__ valid,   // [N] bool
                   float* __restrict__ out,              // [B, N]
                   int nq, int lq, int n, int lt, int h, int qg, int group) {
  static_assert(LAYOUT == kMask || !INT8, "the v2 layouts are bf16 only");
  __shared__ __align__(16) Smem<INT8> sm;
  const int tid = threadIdx.x;
  const int cg = tid & 15;  // chunk group: a quarter warp spans 8 of them
  const int rg = tid >> 4;  // row group
  const int64_t c0 = (int64_t)blockIdx.x * CT;
  const int g = blockIdx.y;
  const int64_t row0 = (int64_t)g * qg * lq;  // the group's first flat query row
  const int rows = qg * lq;                   // the group's query rows
  const int64_t all_rows = (int64_t)nq * lq;
  const int step = INT8 ? 4 * KW : KF;        // depth per staging step
  constexpr int ES = INT8 ? 1 : 2;            // bytes per element

  for (int p = tid; p < QG_MAX * CT; p += THREADS) (&sm.sum[0][0])[p] = 0.0f;

  for (int sub = 0; sub * RT < rows; ++sub) {
    const int sub_rows = min(RT, rows - sub * RT);
    float best[TC][TR];
#pragma unroll
    for (int e = 0; e < TC; ++e)
#pragma unroll
      for (int r = 0; r < TR; ++r) best[e][r] = -INFINITY;

    for (int j = 0; j < lt; ++j) {
      typename std::conditional<INT8, int, float>::type acc[TC][TR];
#pragma unroll
      for (int e = 0; e < TC; ++e)
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[e][r] = 0;

      // this thread stages chunk c0 + (tid & 127) at every depth step; its
      // token row at position j
      const int64_t tok_row = LAYOUT == kLMajor ? lmajor_index(c0 + (tid & (CT - 1)), j, lt, group)
                                                : (c0 + (tid & (CT - 1))) * lt + j;
      for (int k0 = 0; k0 < h; k0 += step) {
        // chunk tokens: 128 chunks x 4 vectors of 16 bytes; a warp covers 32
        // chunks of one vector column, so the shared stores are conflict-free
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int v = tid + THREADS * s;
          const int c = v & (CT - 1);
          const int part = v >> 7;
          const int kk = k0 + part * (INT8 ? 16 : 8);
          uint4 raw = make_uint4(0, 0, 0, 0);
          if (ALIGNED) {  // written out: the shared helper measured 7% slower here
            if (c0 + c < n && kk < h) {
              const int64_t off = tok_row * h + kk;
              raw = __ldg(reinterpret_cast<const uint4*>(static_cast<const char*>(tok_) + off * ES));
            }
          } else if (c0 + c < n) {
            raw = load_row16<ES, false>(tok_, tok_row * h, kk, h);
          }
          if constexpr (INT8) {
            sm.u.stage.tok[part * 4 + 0][c] = (int)raw.x;
            sm.u.stage.tok[part * 4 + 1][c] = (int)raw.y;
            sm.u.stage.tok[part * 4 + 2][c] = (int)raw.z;
            sm.u.stage.tok[part * 4 + 3][c] = (int)raw.w;
          } else {
            float f[8];
            unpack_bf16x8(raw, f);
#pragma unroll
            for (int e = 0; e < 8; ++e) sm.u.stage.tok[part * 8 + e][c] = f[e];
          }
        }
        // query rows: 64 rows x 4 vectors of 16 bytes, one per thread
        {
          const int r = tid & (RT - 1);
          const int part = tid >> 6;
          const int kk = k0 + part * (INT8 ? 16 : 8);
          const int64_t flat = row0 + sub * RT + r;
          uint4 raw = make_uint4(0, 0, 0, 0);
          if (ALIGNED) {
            if (sub * RT + r < rows && flat < all_rows && kk < h) {
              raw = __ldg(reinterpret_cast<const uint4*>(static_cast<const char*>(q_) + (flat * h + kk) * ES));
            }
          } else if (sub * RT + r < rows && flat < all_rows) {
            raw = load_row16<ES, false>(q_, flat * h, kk, h);
          }
          if constexpr (INT8) {
            sm.u.stage.q[part * 4 + 0][r] = (int)raw.x;
            sm.u.stage.q[part * 4 + 1][r] = (int)raw.y;
            sm.u.stage.q[part * 4 + 2][r] = (int)raw.z;
            sm.u.stage.q[part * 4 + 3][r] = (int)raw.w;
          } else {
            float f[8];
            unpack_bf16x8(raw, f);
#pragma unroll
            for (int e = 0; e < 8; ++e) sm.u.stage.q[part * 8 + e][r] = f[e];
          }
        }
        if (k0 == 0 && tid < CT) {
          const int64_t c = c0 + tid;
          if constexpr (LAYOUT == kMask) {
            sm.mask[tid] = c < n ? t_mask[c * lt + j] : 0;
          } else {
            sm.bias[tid] = c < n ? __ldg(bias_l + lmajor_index(c, j, lt, group)) : MASK_BIAS;
          }
          if constexpr (INT8) sm.scale[tid] = c < n ? s_tok[c * lt + j] : 1.0f;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < (INT8 ? KW : KF); ++kk) {
          if constexpr (INT8) {
            const int4 a0 = *reinterpret_cast<const int4*>(&sm.u.stage.tok[kk][cg * 4]);
            const int4 a1 = *reinterpret_cast<const int4*>(&sm.u.stage.tok[kk][64 + cg * 4]);
            const int4 b4 = *reinterpret_cast<const int4*>(&sm.u.stage.q[kk][rg * 4]);
            const int a[TC] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const int b[TR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int e = 0; e < TC; ++e)
#pragma unroll
              for (int r = 0; r < TR; ++r) acc[e][r] = __dp4a(a[e], b[r], acc[e][r]);
          } else {
            const float4 a0 = *reinterpret_cast<const float4*>(&sm.u.stage.tok[kk][cg * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&sm.u.stage.tok[kk][64 + cg * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&sm.u.stage.q[kk][rg * 4]);
            const float a[TC] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[TR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int e = 0; e < TC; ++e)
#pragma unroll
              for (int r = 0; r < TR; ++r) acc[e][r] = __fmaf_rn(a[e], b[r], acc[e][r]);
          }
        }
        if (k0 + step >= h) {  // the full dot of position j: fold into the max
#pragma unroll
          for (int e = 0; e < TC; ++e) {
            const int c = (e < 4 ? 0 : 64) + cg * 4 + (e & 3);
            if constexpr (LAYOUT == kMask) {
              if (!sm.mask[c]) continue;
            }
#pragma unroll
            for (int r = 0; r < TR; ++r) {
              float x;
              if constexpr (INT8) {
                x = __fmul_rn(__int2float_rn(acc[e][r]), sm.scale[c]);
              } else if constexpr (LAYOUT == kMask) {
                x = acc[e][r];
              } else {
                x = __fadd_rn(acc[e][r], sm.bias[c]);
              }
              best[e][r] = fmaxf(best[e][r], x);
            }
          }
        }
        __syncthreads();
      }
    }

    // the sub-tile's bests (an empty chunk's -inf, or with the bias its
    // ~-2^30, counts 0) → shared memory
#pragma unroll
    for (int r = 0; r < TR; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 v;
        float* pv = &v.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = best[half * 4 + e][r];
          if constexpr (LAYOUT == kMask) {
            pv[e] = isfinite(x) ? x : 0.0f;
          } else {
            pv[e] = x > EMPTY_BELOW ? x : 0.0f;
          }
        }
        *reinterpret_cast<float4*>(&sm.u.best[rg * TR + r][half * 64 + cg * 4]) = v;
      }
    }
    __syncthreads();

    // the ordered Lq-sum: each (query, chunk) pair adds its rows of this
    // sub-tile in ascending order
    for (int p = tid; p < qg * CT; p += THREADS) {
      const int qi = p / CT;
      const int c = p % CT;
      const int lo = max(qi * lq, sub * RT);
      const int hi = min((qi + 1) * lq, sub * RT + sub_rows);
      float s = sm.sum[qi][c];
      for (int r = lo; r < hi; ++r) {
        const float x = sm.u.best[r - sub * RT][c];
        if constexpr (INT8) {
          const int64_t flat = row0 + r;
          const float t = flat < all_rows ? __ldg(tq + flat) : 1.0f;
          s = __fadd_rn(s, __fmul_rn(t, x));
        } else {
          s = __fadd_rn(s, x);
        }
      }
      sm.sum[qi][c] = s;
    }
    __syncthreads();
  }

  for (int p = tid; p < qg * CT; p += THREADS) {
    const int qi = p / CT;
    const int64_t b = (int64_t)g * qg + qi;
    const int64_t c = c0 + p % CT;
    if (b < nq && c < n) out[b * n + c] = valid[c] ? sm.sum[qi][p % CT] : -INFINITY;
  }
}

int group_size(int lq) {
  const int qg = RT / lq;
  return qg < 1 ? 1 : (qg > QG_MAX ? QG_MAX : qg);
}

bool bad_shape(int nq, int lq, int n, int lt, int h) {
  return nq < 1 || lq < 1 || n < 1 || lt < 1 || h < 1 ||
         (nq + group_size(lq) - 1) / group_size(lq) > 65535;
}

// K11a (kLMajor) and K11b (kSelf): the bf16 scan with the l-major bias.
template <int LAYOUT>
int launch_v2(const void* q16, const void* tok, const void* bias_l, const void* valid, void* out,
              int nq, int lq, int n, int lt, int h, int group, void* stream) {
  if (bad_shape(nq, lq, n, lt, h) || group < 1) return (int)cudaErrorInvalidValue;
  const int qg = group_size(lq);
  const dim3 grid((n + CT - 1) / CT, (nq + qg - 1) / qg);
  auto kernel = rows_aligned<2>(h) ? maxsim_scan_kernel<false, true, LAYOUT>
                                   : maxsim_scan_kernel<false, false, LAYOUT>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q16, nullptr, tok, nullptr, nullptr, static_cast<const float*>(bias_l),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), nq, lq, n, lt, h, qg, group);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: q [nq, lq, h] (bf16 or
// int8), tq [nq, lq] f32 (int8 only), tok [n, lt, h] (bf16 or int8), s_tok
// [n, lt] f32 (int8 only), t_mask [n, lt] bool, valid [n] bool, out [nq, n]
// f32. Any h >= 1 (h*127^2 < 2^24 for int8); q and tok 16-byte aligned. Launch on `stream`, allocate nothing,
// and return cudaGetLastError() (0 on success).
extern "C" int maxsim_scan16_launch(const void* q16, const void* tok16, const void* t_mask,
                                    const void* valid, void* out, int nq, int lq, int n, int lt,
                                    int h, void* stream) {
  if (bad_shape(nq, lq, n, lt, h)) return (int)cudaErrorInvalidValue;
  const int qg = group_size(lq);
  const dim3 grid((n + CT - 1) / CT, (nq + qg - 1) / qg);
  auto kernel = rows_aligned<2>(h) ? maxsim_scan_kernel<false, true, kMask>
                                   : maxsim_scan_kernel<false, false, kMask>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q16, nullptr, tok16, nullptr, static_cast<const unsigned char*>(t_mask), nullptr,
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), nq, lq, n, lt, h, qg, 1);
  return (int)cudaGetLastError();
}

extern "C" int maxsim_scan_int8_launch(const void* q8, const void* tq, const void* tok8,
                                       const void* s_tok, const void* t_mask, const void* valid,
                                       void* out, int nq, int lq, int n, int lt, int h,
                                       void* stream) {
  if (bad_shape(nq, lq, n, lt, h) || (long long)h * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  const int qg = group_size(lq);
  const dim3 grid((n + CT - 1) / CT, (nq + qg - 1) / qg);
  auto kernel = rows_aligned<1>(h) ? maxsim_scan_kernel<true, true, kMask>
                                   : maxsim_scan_kernel<true, false, kMask>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q8, static_cast<const float*>(tq), tok8, static_cast<const float*>(s_tok),
      static_cast<const unsigned char*>(t_mask), nullptr, static_cast<const unsigned char*>(valid),
      static_cast<float*>(out), nq, lq, n, lt, h, qg, 1);
  return (int)cudaGetLastError();
}

// K11a: tok_l is the l-major pack [Gp*lt*group, h] (lt = its padded Lt_p),
// bias_l [Gp*lt*group] f32 in the same layout, n <= Gp*group chunks scored.
extern "C" int maxsim_scan16_v2_launch(const void* q16, const void* tok_l, const void* bias_l,
                                       const void* valid, void* out, int nq, int lq, int n, int lt,
                                       int h, int group, void* stream) {
  return launch_v2<kLMajor>(q16, tok_l, bias_l, valid, out, nq, lq, n, lt, h, group, stream);
}

// K11b: tokens [n, lt, h] read in place, bias_l [ceil(n/group)*lt*group] f32
// l-major (read only at chunks c < n).
extern "C" int maxsim_scan16_self_v2_launch(const void* q16, const void* tokens, const void* bias_l,
                                            const void* valid, void* out, int nq, int lq, int n,
                                            int lt, int h, int group, void* stream) {
  return launch_v2<kSelf>(q16, tokens, bias_l, valid, out, nq, lq, n, lt, h, group, stream);
}
