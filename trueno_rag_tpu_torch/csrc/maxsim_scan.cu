// maxsim_scan16_scores, maxsim_scan_int8_scores and the l-major v2 pair
// maxsim_scan16_scores_v2 / maxsim_scan16_scores_self_v2 for Hopper
// (sm_90a): the late-interaction tiers' bound pass, one template over the
// element type (bf16, int8) and the token layout, four entry points at the
// end of this file.
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
// Layout. One thread block per (128-chunk tile, group of QG whole queries);
// the group is the fastest-varying part of the block index, so the blocks
// that read one tile's tokens run together and the tokens come from HBM
// once. A group holds QG = min(16, max(1, 64 / Lq)) queries, whose QG*Lq query
// tokens run through sub-tiles of 64 rows, so B*Lq*H never has to fit in
// shared memory and any Lq works. The [N, Lt, H] replica is read in place
// at any N, Lt, B and H: a width H that is not a multiple of the 16-byte
// vector (8 bf16, 16 int8) has no aligned rows and a ragged last vector,
// so those loads go byte by byte with the columns past H read as zero
// (row_load.cuh), which adds exactly 0 to every dot. The Pallas wrapper's
// TPU workarounds (the Lt-to-32 pad copy, the ragged-tail split, the
// VMEM-sized tiles and query slabs) have no counterpart here.
//
// The program. A sub-tile's query rows are staged to shared memory once
// (for H > 512 they stream beside the tokens instead). The chunks' token
// rows stream through a 3-stage cp.async ring of 128-chunk x 128-byte
// slices (64 bf16 or 128 int8 columns), position after position, and the
// 64 x 128 interaction tile S_j = Q . T_j^T of each position j is a
// tensor-core dot fed by ldmatrix: bf16 (K6, K11a, K11b) through
// mma_bf16.cuh (mma.sync m16n8k16, one 16-column slice per mma, f32
// __fadd_rn between slices), int8 (K7) through mma_s8.cuh (mma.sync
// m16n8k32 s8, the s32 sum chained through C across the whole depth). The
// two accumulators share one fragment layout, so the rest is one program:
// the tile stays in the mma's accumulator registers, and after its full
// depth it folds elementwise into a running max (kMask skips a masked
// token; int8 converts the dot and multiplies it by the token's scale,
// f32(dot)*s_tok, first; the v2 layouts add the bias first), so the
// [B*Lq, N*Lt] interaction never leaves registers. What the fold needs of
// a chunk at a position (its mask, scale or bias) is loaded once per warp,
// one position ahead, and passed to the lanes holding its dots by shuffles.
// Warps whose query rows are all past the group skip their mma tiles. The
// bests then pass through shared memory for the ordered Lq-sum (int8: each
// best times its query token's scale t_q first).
//
// Numbers. bf16: mma_bf16.cuh derives the tensor-core dot's worst case,
// (min(H,16) + (ceil(H/16)-1)/2)*2^-23*sum|p|, within the certificate's
// H*2^-23 share of kappa = (H+Lq)*2^-23 (ops/maxsim.py::_scan16_fused_widths)
// for every H, and chip_smoke.py's mma-probe phase holds the card to that
// model. int8: |q8|, |tok8| <= 127 and H*127^2 < 2^24 (the wrapper checks
// H), so the s32 dot is exact in any grouping and its conversion to f32 is
// exact; with the scale multiplies and adds written as __fmul_rn/__fadd_rn
// (no contraction), in the plain version's order, the result is
// bit-identical to the plain version.
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
// __fadd_rn after its full depth, every position is maxed, and a best at
// or below -2^29 (an empty chunk) resets to 0. Adding 0.0 to a dot is
// exact, and a dot never starts at -0 (the sum starts at +0), so on the
// same bf16 values and valid tokens the v2 scores equal K6's bit for bit:
// the same dot program, the same max over the valid dots, the same ordered
// Lq-sum. Each chunk computes its own index, so a 128-chunk tile may
// straddle groups and any group >= 1 works; offsets are 64-bit (a 1M x 32
// x 128 pack holds 4.3e9 elements).
//
// What bounds it on the H100. At the JAX package's serving shape (N =
// 1,048,576 chunks x Lt 32 x H 128, B = 8, Lq = 8) the bf16 form is
// 2*B*Lq*N*Lt*H = 5.5e11 FLOP, 0.56 ms at the bf16 tensor-core peak,
// against 2.6 ms to stream the 8.6 GB replica: the bytes are the bound,
// so the design keeps copies in flight while the mma tiles run (the split
// accumulation's adds and the max fold cost CUDA-core issue slots beside
// them, well inside the byte time). The v2 pair does K6's work (the bias
// read adds 4 bytes per token position, a sixteenth of the row). The int8
// form at 2,097,152 chunks is 1.1e12 integer operations, 0.56 ms at the
// int8 tensor-core peak, against 2.7 ms of bytes (the tokens, their 4-byte
// scales and the mask); at the late-interaction store's launch (262,144 x 32
// x 384, B = 8, Lq = 32) it is 1.65e12 operations, 0.83 ms, against 0.97 ms
// of bytes. Either way the bytes bound it, and the dot, with half the mma
// instructions per byte of the bf16 form and no split adds, stays beside
// the copies.
//
// K6 at an aligned width (H % 8 == 0) runs its Hopper program instead
// (maxsim_wgmma.cuh: TMA, mbarriers, wgmma, the same bits), through its own
// entry point; this file's program serves K6 at the other widths, K7, K11a
// and K11b.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             maxsim_scan16_launch, maxsim_scan16_wgmma_launch,
//             maxsim_scan_int8_launch, maxsim_scan16_v2_launch and
//             maxsim_scan16_self_v2_launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_dot.cuh"
#include "maxsim_wgmma.cuh"
#include "row_load.cuh"

namespace mb = mma_bf16;

namespace {

constexpr int THREADS = 256;
constexpr int CT = 128;     // chunks per block
constexpr int RT = 64;      // query-token rows per sub-tile
constexpr int QG_MAX = 16;  // whole queries per block
constexpr int NST = 3;      // ring stages
constexpr int BSTR = 152;   // bests row stride (f32): float2 stores conflict-free

static_assert(mb::TILE_A == RT && mb::TILE_B == CT && mb::THREADS == THREADS,
              "the mma tile is one sub-tile of query rows by one chunk tile");

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

// The ordered Lq-sum of one sub-tile's bests best[r][c] (row stride bstr):
// each (query, chunk) pair adds its rows of the sub-tile in ascending
// order; tq (int8) scales each best first.
template <bool INT8>
__device__ __forceinline__ void lq_sum(float (*sum)[CT], const float* best, int bstr, int sub,
                                       int sub_rows, int qg, int lq, int64_t row0,
                                       int64_t all_rows, const float* __restrict__ tq) {
  for (int p = threadIdx.x; p < qg * CT; p += THREADS) {
    const int qi = p / CT;
    const int c = p % CT;
    const int lo = max(qi * lq, sub * RT);
    const int hi = min((qi + 1) * lq, sub * RT + sub_rows);
    float s = sum[qi][c];
    for (int r = lo; r < hi; ++r) {
      const float x = best[(r - sub * RT) * bstr + c];
      if constexpr (INT8) {
        const int64_t flat = row0 + r;
        const float t = flat < all_rows ? __ldg(tq + flat) : 1.0f;
        s = __fadd_rn(s, __fmul_rn(t, x));
      } else {
        s = __fadd_rn(s, x);
      }
    }
    sum[qi][c] = s;
  }
}

// The element type's dot (mma_dot.cuh): bf16 for K6, K11a and K11b, int8
// for K7; the ring, the staging, the warp grid and the accumulator's
// fragment layout are the same for both.
using mma_dot::Dot;

// Dynamic shared memory: the resident query rows, the ring (its first
// RT x BSTR floats hold a sub-tile's bests once its positions are done), the
// Lq-sums, and each chunk's l-major base index lmajor_index(c, 0, lt, group)
// (v2 layouts), so that no position divides by the group.
template <typename E>
int scan_smem_bytes(int h) {
  return Dot<E>::resident_bytes(h) + NST * mb::stage_bytes(!Dot<E>::resident(h)) + QG_MAX * CT * 4 + CT * 8;
}

// One template for the four scans: E = bf16 with LAYOUT kMask (K6), kLMajor
// (K11a) or kSelf (K11b); E = int8 with kMask (K7, whose s_tok and tq are
// read; null otherwise).
template <typename E, bool ALIGNED, int LAYOUT>
__global__ void __launch_bounds__(THREADS, 2)
maxsim_scan_kernel(const E* __restrict__ q,                 // [B*Lq, H]
                   const float* __restrict__ tq,            // [B*Lq] query scales (int8) or null
                   const E* __restrict__ tok,               // [N*Lt, H], or the l-major pack
                   const float* __restrict__ s_tok,         // [N*Lt] token scales (int8) or null
                   const unsigned char* __restrict__ t_mask,// [N*Lt] bool (kMask) or null
                   const float* __restrict__ bias_l,        // l-major mask bias (kLMajor, kSelf) or null
                   const unsigned char* __restrict__ valid, // [N] bool
                   float* __restrict__ out,                 // [B, N]
                   int nq, int lq, int n, int lt, int h, int qg, int n_groups, int group) {
  using D = Dot<E>;
  constexpr bool INT8 = std::is_same<E, int8_t>::value;
  constexpr int VE = 16 / sizeof(E);  // elements per staged 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  E* qs = reinterpret_cast<E*>(smem);
  unsigned char* ring = smem + D::resident_bytes(h);
  float* bests = reinterpret_cast<float*>(ring);
  float(*sum)[CT] = reinterpret_cast<float(*)[CT]>(ring + NST * mb::stage_bytes(!D::resident(h)));
  int64_t* lbase = reinterpret_cast<int64_t*>(sum + QG_MAX);
  static_assert(RT * BSTR * 4 <= NST * CT * mb::SROW * 2, "the bests fit in the ring");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x % n_groups;
  const int64_t c0 = (int64_t)(blockIdx.x / n_groups) * CT;
  const int64_t row0 = (int64_t)g * qg * lq;  // the group's first flat query row
  const int rows = qg * lq;                   // the group's query rows
  const int64_t all_rows = (int64_t)nq * lq;
  const bool res = D::resident(h);
  const int hp = D::pad(h);
  const int ks = D::slices(h);
  const int a_stride = res ? hp + D::PAD : D::SROW;

  for (int p = tid; p < QG_MAX * CT; p += THREADS) (&sum[0][0])[p] = 0.0f;
  if (LAYOUT != kMask && tid < CT) lbase[tid] = lmajor_index(c0 + tid, 0, lt, group);
  __syncthreads();
  // chunk c0 + i's position j in the l-major layout
  auto lmajor = [&](int i, int j) -> int64_t { return lbase[i] + (int64_t)j * group; };

  for (int sub = 0; sub * RT < rows; ++sub) {
    const int sub_rows = min(RT, rows - sub * RT);
    auto q_src = [&](int i) -> int64_t {
      const int r = sub * RT + i;
      return r < rows && row0 + r < all_rows ? (row0 + r) * h : -1;
    };
    if (res) mb::stage_rows<ALIGNED>(qs, a_stride, q, q_src, RT, 0, hp / VE, hp / VE, h);

    typename D::Acc acc;
    mb::Acc best;
    D::zero(acc);
#pragma unroll
    for (int mt = 0; mt < mb::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < mb::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) best[mt][nt][e] = -INFINITY;
    // What the fold adds to (bf16) or multiplies by (int8) the dots of chunk
    // (warp & 3)*32 + i of the tile at position j: lane i of each warp loads
    // it one position ahead (kv_next), and the lanes that hold the chunk's
    // dots take it by shuffles. kMask: 0 for a valid token (bf16) or its scale
    // (int8), NaN for a masked one, which fmaxf ignores, as a skip would; the
    // v2 layouts: the l-major bias.
    auto fold_value = [&](int j) -> float {
      const int i = (warp & 3) * 32 + lane;
      const int64_t c = c0 + i;
      if constexpr (LAYOUT == kMask) {
        if (c >= n || !t_mask[c * lt + j]) return NAN;
        return INT8 ? __ldg(s_tok + c * lt + j) : 0.0f;
      } else {
        return c < n ? __ldg(bias_l + lmajor(i, j)) : MASK_BIAS;
      }
    };
    float kv = 0.0f, kv_next = fold_value(0);

    mb::ring_run<NST>(
        lt * ks, ring, mb::stage_bytes(!res),
        [&](int step, unsigned char* st) {
          const int j = step / ks, k0 = (step % ks) * D::KD;
          const int nv = min(D::KD, hp - k0) / VE;
          auto tok_src = [&](int i) -> int64_t {
            const int64_t c = c0 + i;
            if (c >= n) return -1;
            return (LAYOUT == kLMajor ? lmajor(i, j) : c * lt + j) * h;
          };
          auto* t = reinterpret_cast<E*>(st);
          mb::stage_rows<ALIGNED>(t, D::SROW, tok, tok_src, CT, k0, D::KD / VE, nv, h);
          if (!res) mb::stage_rows<ALIGNED>(t + CT * D::SROW, D::SROW, q, q_src, RT, k0, D::KD / VE, nv, h);
        },
        [&](int step, unsigned char* st) {
          const int j = step / ks, kc = step % ks, k0 = kc * D::KD;
          if (kc == 0) {
            kv = kv_next;
            if (j + 1 < lt) kv_next = fold_value(j + 1);
          }
          auto* t = reinterpret_cast<const E*>(st);
          const E* a = res ? qs + k0 : t + CT * D::SROW;
          D::run(acc, a, a_stride, t, min(D::KD, hp - k0) / D::DK, sub_rows);
          if (kc != ks - 1) return;
          // the full dot of position j: fold into the max
          float k[mb::NT][2];
#pragma unroll
          for (int nt = 0; nt < mb::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) k[nt][e] = __shfl_sync(0xffffffffu, kv, nt * 8 + 2 * (lane & 3) + e);
#pragma unroll
          for (int mt = 0; mt < mb::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < mb::NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if constexpr (INT8) {
                  best[mt][nt][e] = fmaxf(best[mt][nt][e], __fmul_rn(__int2float_rn(acc[mt][nt][e]), k[nt][e & 1]));
                } else {
                  best[mt][nt][e] = fmaxf(best[mt][nt][e], __fadd_rn(acc[mt][nt][e], k[nt][e & 1]));
                }
                acc[mt][nt][e] = 0;
              }
        });

    // the sub-tile's bests (an empty chunk's -inf, or with the bias its
    // ~-2^30, counts 0) → shared memory, over the ring
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < mb::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < mb::NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = best[mt][nt][2 * half + e];
            if constexpr (LAYOUT == kMask) {
              v[e] = isfinite(x) ? x : 0.0f;
            } else {
              v[e] = x > EMPTY_BELOW ? x : 0.0f;
            }
          }
          const int r = (warp >> 2) * 32 + mt * 16 + (lane >> 2) + 8 * half;
          const int c = (warp & 3) * 32 + nt * 8 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(&bests[r * BSTR + c]) = make_float2(v[0], v[1]);
        }
    __syncthreads();
    lq_sum<INT8>(sum, bests, BSTR, sub, sub_rows, qg, lq, row0, all_rows, tq);
    __syncthreads();
  }

  for (int p = tid; p < qg * CT; p += THREADS) {
    const int qi = p / CT;
    const int64_t b = (int64_t)g * qg + qi;
    const int64_t c = c0 + p % CT;
    if (b < nq && c < n) out[b * n + c] = valid[c] ? sum[qi][p % CT] : -INFINITY;
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

// K6 and K7 (kMask), K11a (kLMajor), K11b (kSelf).
template <typename E, int LAYOUT>
int launch(const void* q, const void* tq, const void* tok, const void* s_tok, const void* t_mask,
           const void* bias_l, const void* valid, void* out, int nq, int lq, int n, int lt, int h,
           int group, void* stream) {
  const int qg = group_size(lq);
  const int n_groups = (nq + qg - 1) / qg;
  const int64_t blocks = (int64_t)((n + CT - 1) / CT) * n_groups;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // K6's aligned widths run maxsim_wgmma.cuh's program: its aligned form is not built here, and
  // maxsim_scan16_launch reads rows of any width byte by byte
  constexpr bool K6 = std::is_same<E, __nv_bfloat16>::value && LAYOUT == kMask;
  auto kernel = !K6 && rows_aligned<sizeof(E)>(h) ? maxsim_scan_kernel<E, !K6, LAYOUT>
                                                  : maxsim_scan_kernel<E, false, LAYOUT>;
  const int bytes = scan_smem_bytes<E>(h);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const float*>(tq), static_cast<const E*>(tok),
      static_cast<const float*>(s_tok), static_cast<const unsigned char*>(t_mask),
      static_cast<const float*>(bias_l), static_cast<const unsigned char*>(valid), static_cast<float*>(out),
      nq, lq, n, lt, h, qg, n_groups, group);
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
  return launch<__nv_bfloat16, kMask>(q16, nullptr, tok16, nullptr, t_mask, nullptr, valid, out, nq, lq, n,
                                      lt, h, 1, stream);
}

// K6's Hopper program (maxsim_wgmma.cuh), the same arguments; h % 8 == 0.
extern "C" int maxsim_scan16_wgmma_launch(const void* q16, const void* tok16, const void* t_mask,
                                          const void* valid, void* out, int nq, int lq, int n, int lt,
                                          int h, void* stream) {
  return maxsim_wgmma::launch(q16, tok16, t_mask, valid, out, nq, lq, n, lt, h, stream);
}

extern "C" int maxsim_scan_int8_launch(const void* q8, const void* tq, const void* tok8,
                                       const void* s_tok, const void* t_mask, const void* valid,
                                       void* out, int nq, int lq, int n, int lt, int h,
                                       void* stream) {
  if (bad_shape(nq, lq, n, lt, h) || (long long)h * 127 * 127 >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<int8_t, kMask>(q8, tq, tok8, s_tok, t_mask, nullptr, valid, out, nq, lq, n, lt, h, 1,
                               stream);
}

// K11a: tok_l is the l-major pack [Gp*lt*group, h] (lt = its padded Lt_p),
// bias_l [Gp*lt*group] f32 in the same layout, n <= Gp*group chunks scored.
extern "C" int maxsim_scan16_v2_launch(const void* q16, const void* tok_l, const void* bias_l,
                                       const void* valid, void* out, int nq, int lq, int n, int lt,
                                       int h, int group, void* stream) {
  if (bad_shape(nq, lq, n, lt, h) || group < 1) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16, kLMajor>(q16, nullptr, tok_l, nullptr, nullptr, bias_l, valid, out, nq, lq, n,
                                        lt, h, group, stream);
}

// K11b: tokens [n, lt, h] read in place, bias_l [ceil(n/group)*lt*group] f32
// l-major (read only at chunks c < n).
extern "C" int maxsim_scan16_self_v2_launch(const void* q16, const void* tokens, const void* bias_l,
                                            const void* valid, void* out, int nq, int lq, int n,
                                            int lt, int h, int group, void* stream) {
  if (bad_shape(nq, lq, n, lt, h) || group < 1) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16, kSelf>(q16, nullptr, tokens, nullptr, nullptr, bias_l, valid, out, nq, lq, n,
                                      lt, h, group, stream);
}
