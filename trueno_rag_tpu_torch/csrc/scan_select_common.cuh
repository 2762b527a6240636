// Shared by the tile-scan kernels (scan_select_tile.cuh, built into
// scan_select_v3.cu and scan_select_int8_v3.cu) and the block kernels
// (scan_select_v1.cu): the thread layout, the tag predicate, the two bound
// forms, the score tile's way from the tensor-core fragments into the
// thread tiles, the int8 dequantization, and the selection epilogue that turns a
// 128-row block of masked scores into the tile's candidate pool and then
// runs the per-1024-row tournament. The files include this one, so their
// bounds, selection and tie rules cannot drift apart.
//
// Bound forms. Bound::kBlock is the v3 form (K1, K5, K3): selection ranks
// the raw masked scores, and each selected value and each block's third
// value then gets the block's correction max_blk(e_l2)*u_q +
// max_blk(a_l2)*v_q. Bound::kRow is the v2 form (K10a, K10b, K10c): each
// score first gets its own row's terms, upper = (s + e_l2*u_q) + a_l2*v_q,
// so selection ranks the per-row upper bounds and nothing is added after
// it. Both emit rigorous upper bounds; kRow's are tighter by the spread of
// e_l2 and a_l2 within a block. On the TPU the per-row form cost two lane
// relayouts per tile, which is why v3 exists; here a thread keeps its rows'
// norms in registers and the form costs 4 operations per (row, query).
//
// Thread layout: one thread block per (group of QB = 64 queries, 1024-row
// selection tile), walking the tile's eight 128-row blocks in turn. Each of
// the 256 threads owns an 8-row x 4-query register tile of the block: rows
// rg*8 .. rg*8+7 (rg = tid & 15) and queries qg*4 .. qg*4+3 (qg = tid >> 4).
// The 16 threads that hold one query's 128 rows sit in one half-warp, so
// the block top-2 and third value are xor-shuffle reductions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_load.cuh"

namespace scan_select {

constexpr int BLOCK = 128;        // rows per bound block
constexpr int SEL = 1024;         // rows per selection tile
constexpr int BPT = SEL / BLOCK;  // blocks per tile (8)
constexpr int POOL = 2 * BPT;     // tournament slots (16)
constexpr int QB = 64;            // queries per thread block
constexpr int THREADS = 256;
constexpr int TM = 8;  // rows per thread
constexpr int TQ = 4;  // queries per thread

static_assert(BLOCK / TM == 16, "16 row groups: one query's rows span a half-warp");
static_assert((QB / TQ) * (BLOCK / TM) == THREADS, "thread tile covers the block");

// The tile's candidate pool in shared memory (+1 columns: no bank conflicts).
struct SelectSmem {
  float pool_v[QB][POOL + 1];
  int pool_r[QB][POOL + 1];
  float v3s[QB][BPT + 1];
};

enum class Bound { kBlock, kRow };

// Tag predicate of ops/tags.py::tag_pred: all of t_all, at least one of
// t_any (0 = no constraint), none of t_none.
__device__ __forceinline__ bool tag_ok(int bits, int t_all, int t_any, int t_none) {
  return (bits & t_all) == t_all && (t_any == 0 || (bits & t_any) != 0) &&
         (bits & t_none) == 0;
}

// Per-row validity of this thread's 8 rows, and their tag words (0 when
// the call has no filter). row0 + lane0 is a multiple of 8, so both loads
// are 16-byte aligned.
__device__ __forceinline__ void load_rows(const int* __restrict__ valid,
                                          const int* __restrict__ tag_bits,
                                          int64_t row, bool (&ok)[TM], int (&bits)[TM]) {
  const int4 va = __ldg(reinterpret_cast<const int4*>(valid + row));
  const int4 vb = __ldg(reinterpret_cast<const int4*>(valid + row + 4));
  const int v[TM] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
  for (int r = 0; r < TM; ++r) ok[r] = v[r] != 0;
  if (tag_bits != nullptr) {
    const int4 ta = __ldg(reinterpret_cast<const int4*>(tag_bits + row));
    const int4 tb = __ldg(reinterpret_cast<const int4*>(tag_bits + row + 4));
    const int t[TM] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
    for (int r = 0; r < TM; ++r) bits[r] = t[r];
  } else {
#pragma unroll
    for (int r = 0; r < TM; ++r) bits[r] = 0;
  }
}

// Whether row r of this thread passes query q's filter (true without one).
struct QueryFilter {
  bool on;
  int all, any, none;
  __device__ __forceinline__ QueryFilter(const int* __restrict__ tag_bits,
                                         const int* __restrict__ t_all,
                                         const int* __restrict__ t_any,
                                         const int* __restrict__ t_none, int q, int nq)
      : on(tag_bits != nullptr), all(0), any(0), none(0) {
    if (on && q < nq) {
      all = __ldg(t_all + q);
      any = __ldg(t_any + q);
      none = __ldg(t_none + q);
    }
  }
  __device__ __forceinline__ bool pass(int bits) const {
    return !on || tag_ok(bits, all, any, none);
  }
};

// This thread's 8 x 4 scores s[query][row] as the epilogue takes them:
// under Bound::kRow each plus its row's bound (s + e_l2*u_q) + a_l2*v_q,
// each step rounded as the plain version rounds it (no fma contraction);
// then -inf where the block is not live, the row is invalid, or the row
// fails the query's filter. e_row/a_row are the per-row norms (kRow only;
// row is a multiple of 8, so their float4 loads are aligned).
template <Bound BF>
__device__ __forceinline__ void mask_scores(const float (&s)[TQ][TM], bool live, int64_t row,
                                            int q0, int qg, int nq,
                                            const int* __restrict__ valid,
                                            const int* __restrict__ tag_bits,
                                            const int* __restrict__ t_all,
                                            const int* __restrict__ t_any,
                                            const int* __restrict__ t_none,
                                            const float* __restrict__ e_row,
                                            const float* __restrict__ a_row,
                                            const float* __restrict__ uq,
                                            const float* __restrict__ vq, float (&x)[TQ][TM]) {
  bool ok[TM];
  int bits[TM];
  load_rows(valid, tag_bits, row, ok, bits);
  float er[TM], ar[TM];
  if constexpr (BF == Bound::kRow) {
    const float4 e0 = __ldg(reinterpret_cast<const float4*>(e_row + row));
    const float4 e1 = __ldg(reinterpret_cast<const float4*>(e_row + row + 4));
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(a_row + row));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(a_row + row + 4));
    const float ev[TM] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
    const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      er[r] = ev[r];
      ar[r] = av[r];
    }
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + qg * TQ + i;
    const QueryFilter f(tag_bits, t_all, t_any, t_none, qi, nq);
    float u = 0.0f, v = 0.0f;
    if (BF == Bound::kRow && qi < nq) {
      u = __ldg(uq + qi);
      v = __ldg(vq + qi);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float y = s[i][r];
      if constexpr (BF == Bound::kRow) y = __fadd_rn(__fadd_rn(y, __fmul_rn(er[r], u)), __fmul_rn(ar[r], v));
      x[i][r] = (live && ok[r] && f.pass(bits[r])) ? y : -INFINITY;
    }
  }
}

// One 128-row block's 64-query x 128-row score tile as the tensor-core
// dot leaves it (mma_bf16.cuh's f32 fragments, or mma_s8.cuh's s32 ones at
// the same positions: warp w holds acc[mt][nt][e] at query (w >> 2)*32 +
// mt*16 + (lane >> 2) + 8*(e >> 1), row (w & 3)*32 + nt*8 + 2*(lane & 3) +
// (e & 1)) → this thread's 8-row x 4-query tile s[query][row] in f32,
// through `scores` [QB][SSTR] f32 in shared memory. An s32 sum converts
// with __int2float_rn, exact below 2^24 (the int8 launchers check
// d*127^2 < 2^24). Row r sits at column r + 4*(r/32), so the float2 stores
// and the float4 reads are conflict-free. Every thread of the block must
// call it, and the caller keeps the next call's stores behind a
// __syncthreads().
constexpr int SSTR = 152;  // the score tile's row stride (f32)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

template <typename T>
__device__ __forceinline__ void tile_scores(const T (&acc)[2][4][4], float* scores,
                                            float (&s)[TQ][TM]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto col = [](int r) { return r + (r >> 5) * 4; };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (warp >> 2) * 32 + mt * 16 + (lane >> 2) + 8 * half;
        const int r = (warp & 3) * 32 + nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(&scores[q * SSTR + col(r)]) =
            make_float2(to_f32(acc[mt][nt][2 * half]), to_f32(acc[mt][nt][2 * half + 1]));
      }
  __syncthreads();
  const int lane0 = (tid & 15) * TM, qg = tid >> 4;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const float* p = &scores[(qg * TQ + i) * SSTR + col(lane0)];
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    s[i][0] = lo.x; s[i][1] = lo.y; s[i][2] = lo.z; s[i][3] = lo.w;
    s[i][4] = hi.x; s[i][5] = hi.y; s[i][6] = hi.z; s[i][7] = hi.w;
  }
}

// The int8 scans' dequantization of this thread's 8 x 4 exact dots
// s[query][row] (f32, from tile_scores): (s * s_row[row]) * t_q[query], each
// product rounded once, in the JAX code's order (scan_select_v2.py:706,
// scan_select_int8.py:64). s_row points at the thread's first row (a
// multiple of 8: the float4 loads are aligned); padding queries (>= nq)
// scale by 0.
__device__ __forceinline__ void scale_int8(float (&s)[TQ][TM], const float* __restrict__ s_row,
                                           const float* __restrict__ tq, int q, int nq) {
  const float4 sa = __ldg(reinterpret_cast<const float4*>(s_row));
  const float4 sb = __ldg(reinterpret_cast<const float4*>(s_row + 4));
  const float sr[TM] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const float t = q + i < nq ? __ldg(tq + q + i) : 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) s[i][r] = __fmul_rn(__fmul_rn(s[i][r], sr[r]), t);
  }
}

// (value, lane) order of the JAX code: larger value, then higher lane.
__device__ __forceinline__ bool beats(float av, int al, float bv, int bl) {
  return av > bv || (av == bv && al > bl);
}

// Max by (value, lane) over the 16 lanes of this half-warp.
__device__ __forceinline__ void argmax16(float& v, int& l) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int ol = __shfl_xor_sync(0xffffffffu, l, off);
    if (beats(ov, ol, v, l)) {
      v = ov;
      l = ol;
    }
  }
}

// One 128-row block of masked scores x[query][row] (-inf where masked):
// per query, the top-2 scores with their rows (ties -> highest lane, a
// taken lane is replaced by -inf, exactly as the JAX code does) and the
// third value v3 into the tile's pool slots blk and BPT + blk. Under
// Bound::kBlock each gets the block's bound correction
// corr = eb[gblk]*u_q + ab[gblk]*v_q (eb/ab: per-128-row maxes); under
// Bound::kRow x already holds the per-row upper bounds and eb/ab are not
// read. Every thread of the block must call it (shuffles).
template <Bound BF>
__device__ __forceinline__ void block_candidates(const float (&x)[TQ][TM], int tid, int q0, int nq,
                                                 int64_t row0, int blk, int gblk,
                                                 const float* __restrict__ eb,
                                                 const float* __restrict__ ab,
                                                 const float* __restrict__ uq,
                                                 const float* __restrict__ vq, SelectSmem& sel) {
  const int rg = tid & 15;
  const int qg = tid >> 4;
  const int lane0 = rg * TM;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    // pass 1: (v1, a1); ">=" keeps the higher lane on ties
    float v1 = x[i][0];
    int a1 = lane0;
#pragma unroll
    for (int r = 1; r < TM; ++r)
      if (x[i][r] >= v1) {
        v1 = x[i][r];
        a1 = lane0 + r;
      }
    argmax16(v1, a1);
    // pass 2: lane a1 replaced by -inf
    float v2 = -INFINITY;
    int a2 = -1;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float y = (lane0 + r == a1) ? -INFINITY : x[i][r];
      if (y >= v2) {
        v2 = y;
        a2 = lane0 + r;
      }
    }
    argmax16(v2, a2);
    // pass 3: lanes a1 and a2 replaced by -inf; value only
    float v3 = -INFINITY;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int l = lane0 + r;
      v3 = fmaxf(v3, (l == a1 || l == a2) ? -INFINITY : x[i][r]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v3 = fmaxf(v3, __shfl_xor_sync(0xffffffffu, v3, off));

    const int ql = qg * TQ + i;
    if (rg == 0 && q0 + ql < nq) {
      if constexpr (BF == Bound::kBlock) {
        // no contraction into fma: the plain version rounds each product
        const float corr =
            __fadd_rn(__fmul_rn(eb[gblk], uq[q0 + ql]), __fmul_rn(ab[gblk], vq[q0 + ql]));
        v1 += corr;
        v2 += corr;
        v3 += corr;
      }
      sel.pool_v[ql][blk] = v1;
      sel.pool_r[ql][blk] = (int)(row0 + a1);
      sel.pool_v[ql][BPT + blk] = v2;
      sel.pool_r[ql][BPT + blk] = (int)(row0 + a2);
      sel.v3s[ql][blk] = v3;
    }
  }
}

// The tournament over the tile's 16 pool slots, one thread per query:
// slot order [first candidates of blocks 0..7, second candidates of blocks
// 0..7], ties -> highest slot, emitting the top t_top (value, row) pairs and
// channel t_top = max(the pool's (t_top+1)-th value, max_blocks v3).
// Call after a __syncthreads() that follows the last block_candidates.
__device__ __forceinline__ void tile_tournament(SelectSmem& sel, int tid, int q0, int nq, int tile,
                                                int g_tiles, int t_top,
                                                float* __restrict__ v_pack,
                                                int* __restrict__ r_pack) {
  if (tid >= QB || q0 + tid >= nq) return;
  const int64_t b = q0 + tid;
  float* pv = sel.pool_v[tid];
  const int* pr = sel.pool_r[tid];
  for (int t = 0; t < t_top; ++t) {
    float bv = pv[0];
    int bs = 0;
    for (int s = 1; s < POOL; ++s)
      if (pv[s] >= bv) {
        bv = pv[s];
        bs = s;
      }
    v_pack[(b * (t_top + 1) + t) * g_tiles + tile] = bv;
    r_pack[(b * t_top + t) * g_tiles + tile] = pr[bs];
    pv[bs] = -INFINITY;
  }
  float thr = -INFINITY;
  for (int s = 0; s < POOL; ++s) thr = fmaxf(thr, pv[s]);
  for (int k = 0; k < BPT; ++k) thr = fmaxf(thr, sel.v3s[tid][k]);
  v_pack[(b * (t_top + 1) + t_top) * g_tiles + tile] = thr;
}

// Shape checks shared by the C entry points.
inline bool bad_shape(int nq, int d, int n, int t_top) {
  return nq < 1 || d < 1 || n < SEL || n % SEL != 0 || t_top < 1 || t_top > POOL ||
         n / SEL > 65535;
}

}  // namespace scan_select
