// block_attention for Hopper (sm_90a): masked, optionally causal attention
// with an fp32 softmax over bf16 q, k, v.
//
// Replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/attention.py::_attn_kernel
// (pallas_call at attention.py:70, wrapper block_attention). Semantics per
// (batch-head bh, query row i) over the T keys of the head:
//   s_j = f32(q_i . k_j) * scale              (scale = f32(1/sqrt(hd)), a product)
//   s_j = -1e9 where key_mask[bh / heads][j] is false or (causal and j > i)
//   p   = bf16(exp(s - max s) / sum exp(s - max s))     (fp32 softmax)
//   out = bf16(sum_j p_j v_j, accumulated in f32)
// A masked or causal-future key has the logit -1e9, so a row with no kept
// key at or before its position (an all-PAD row, a left-padded row) comes
// out as the plain mean of V over all T keys, as in the JAX package, never
// NaN. Keys past T in the ragged last key tile are excluded outright
// (p = 0), so any T >= 1 is taken.
//
// What bounds it on the H100. The bound is the causal half of one pass,
// 2*BH*T^2*hd operations at 989 TFLOP/s bf16 (8k context, BH = 32,
// hd = 128: 0.556 ms); the bytes (q, k, v, out: 8*BH*T*hd) are far fewer.
// The design:
//   - Two passes, as the JAX recipe: pass 1 walks the key tiles for each
//     row's max m and sum l in fp32; pass 2 recomputes S, forms
//     p = expf(s - m) / l, ROUNDS p TO bf16 and accumulates p V in f32. A
//     one-pass online softmax would round the unnormalised p and drift
//     from the reference. The cost: three products, not two. The quotient
//     is IEEE division's: 1 / l once per row, then two FMA corrections by
//     the exact remainder (div_by) instead of a full division per element.
//   - The causal future is skipped. A block of 128 query rows visits the
//     64-key tiles up to its last row. A row with a kept key at or before
//     its position has m > -1e9 + 128, so exp(-1e9 - m) is 0 in f32 and a
//     skipped key changes neither m, l nor the product. A row without one
//     (m is still -1e9 after those tiles) must average V over all T keys:
//     the block votes, and only then walks the remaining tiles. By the same
//     argument a warp skips a tile that holds no kept key at or before its
//     last row once all its rows have m > -1e9 + 128 (the PAD tails, and
//     the tiles past each warp's rows). A tile it must walk that holds no
//     kept key has every logit -1e9 whatever Q K^T is: no product for S.
//   - S and O stay in registers, on the tensor cores: 4 warps of 32 query
//     rows (two 16-row tiles, so each K or V fragment read from shared
//     memory feeds two products); mma.sync m16n8k16 (bf16 operands, f32
//     accumulation) fed by ldmatrix (.trans for V), Q fragments re-read
//     from shared memory per tile. Row max and sum are quad shuffles on
//     the accumulator layout, and P is rounded straight into A fragments
//     (the S accumulator layout is the P V A layout), so no score or
//     probability tile is in shared memory; pass 2 takes a tile in two
//     32-key halves to hold fewer live registers. No certificate rests on
//     the tensor core's summation order.
//   - K/V tiles come through a 2-stage cp.async ring: the next tile's
//     copies are in flight while this one's products run, one barrier per
//     tile. Rows are padded by 16 bytes, an odd number
//     of 16-byte chunks, so ldmatrix reads no bank twice. Two blocks share
//     an SM (104 KB of shared memory each at hd = 128). Query tiles are
//     launched longest first.
// TMA-fed wgmma tiles are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry point
//             block_attention_launch on the caller's stream.

#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int MT = 2;  // 16-row tiles per warp: each K or V fragment feeds MT products
constexpr int WR = 16 * MT;  // query rows per warp
constexpr int WARPS = BQ / WR;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e9f;  // the JAX package's logit for a masked key
// A row max above this came from a kept key: exp(MASKED - m) is then 0 in
// f32 (e^-104 is below half the least denormal), and so is exp(-inf - m).
constexpr float KEPT = MASKED + 128.0f;

// Shared memory for head dim HD: the Q tile, then 2 stages of (K, V).
// Rows are HD + 8 bf16: an odd number of 16-byte chunks, so the 8 rows an
// ldmatrix phase reads fall in 8 distinct bank groups.
template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;
  static constexpr int TILE = BK * LD;  // elements of one K or V tile
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int BYTES = (Q_ELEMS + 4 * TILE) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), f32 accumulation
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e / l rounded to nearest, from r = 1 / l rounded to nearest: two
// corrections by the exact remainder (Markstein). The first makes the
// quotient faithful, the second rounds it correctly, as IEEE division does,
// whenever e / l and the remainders are normal numbers (e >= 2^-100 here).
__device__ __forceinline__ float div_by(float e, float l, float r) {
  float q = __fmul_rn(e, r);
  q = fmaf(fmaf(-q, l, e), r, q);
  return fmaf(fmaf(-q, l, e), r, q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows row0 .. row0 + n - 1 of a [t, HD] bf16 matrix into dst [n][LD] by
// cp.async; rows past t are zero
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, int row0, int n, int t) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < n * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool in = row0 + r < t;
    cp_async16(dst + r * Layout<HD>::LD + cc * 8, src + (size_t)(in ? row0 + r : 0) * HD + cc * 8, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    block_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const uint8_t* __restrict__ key_mask,
                           bf16* __restrict__ out, int bh, int t, int heads, int causal, float scale) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int KS = HD / 16;  // 16-deep steps of Q K^T; pairs of 8-wide output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + L::Q_ELEMS;  // stage s: K at ring + 2 s TILE, V right after

  const int n_qt = (t + BQ - 1) / BQ;
  const int head = blockIdx.x % bh;
  const int q0 = (n_qt - 1 - blockIdx.x / bh) * BQ;  // the longest query tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)head * t * HD;
  const uint8_t* mrow = key_mask + (size_t)(head / heads) * t;
  const int row_lo = q0 + warp * WR;  // the warp's first query row
  const int i0 = row_lo + (lane >> 2);  // this lane's rows: i0 + 16 mt + 8 h
  const bool live = row_lo < t;  // the warp has a query row below t
  const int n_kt = (t + BK - 1) / BK;
  const bf16* qw = qs + (warp * WR + (lane & 15)) * LD + (lane >> 4) * 8;  // this lane's Q ldmatrix row

  // the Q tile; each warp reads only its own WR rows of it
  copy_rows<HD>(qs, q + base, q0, BQ, t);
  cp_async_commit();

  // rows i0 + 16 mt + 8 h: running max, then this lane's share of the sum
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m_run[mt][0] = m_run[mt][1] = -INFINITY, l_run[mt][0] = l_run[mt][1] = 0.0f;
  auto all_kept = [&]() {
    bool kept = true;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) kept = kept && m_run[mt][0] > KEPT && m_run[mt][1] > KEPT;
    return __all_sync(0xffffffffu, kept);
  };

  // bit c: key k0 + c is below t and kept
  auto tile_bits = [&](int k0) -> uint64_t {
    const int j0 = k0 + lane, j1 = k0 + 32 + lane;
    const bool b0 = j0 < t && __ldg(mrow + j0) != 0;
    const bool b1 = j1 < t && __ldg(mrow + j1) != 0;
    return (uint64_t)__ballot_sync(0xffffffffu, b0) | ((uint64_t)__ballot_sync(0xffffffffu, b1) << 32);
  };
  // the tile adds exactly 0 to every row of the warp: no kept key at or
  // before the warp's last row, and every row already has a kept key
  auto skip = [&](uint64_t bits, int k0) -> bool {
    if (!live) return true;
    const bool none = bits == 0 || (causal && k0 + __ffsll((long long)bits) - 1 > row_lo + WR - 1);
    return none && all_kept();
  };
  // s = the warp's WR x (8 NN) logits of keys k0 + 8 n0 .. of the tile at ks
  auto logits = [&](auto& s, int n0, const bf16* ks, uint64_t bits, int k0) {
    constexpr int NN = sizeof(s[0]) / sizeof(s[0][0]);
    const int cl = 2 * (lane & 3);  // this lane's first column in an 8-key tile
    if (bits == 0) {  // no kept key: every logit is MASKED (or -inf past t) whatever Q K^T is
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[mt][n][x] = k0 + 8 * (n0 + n) + cl + (x & 1) < t ? MASKED : -INFINITY;
      return;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NN; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(qa[mt], qw + mt * 16 * LD + kk * 16);
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {  // key tiles n0 + 2 np and n0 + 2 np + 1
        uint32_t b[4];
        ldsm_x4(b, ks + (n0 * 8 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * np], qa[mt], b[0], b[1]);
          mma16816(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
        }
      }
    }
    const bool clean = bits == ~0ull && (!causal || k0 + BK - 1 <= row_lo);
    if (clean) {  // every key kept, below t, at or before every row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[mt][n][x] *= scale;
    } else {
      const uint64_t sh = bits >> cl;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 8 * (n0 + n) + (x & 1);  // column minus cl
            const int j = k0 + c + cl, i = i0 + 16 * mt + 8 * (x >> 1);
            float y = s[mt][n][x] * scale;
            if (!((sh >> c) & 1) || (causal && j > i)) y = MASKED;
            if (j >= t) y = -INFINITY;
            s[mt][n][x] = y;
          }
    }
  };

  // pass 1 over one tile: running max and sum of exp(s - max)
  auto pass1 = [&](int kt, const bf16* ks) {
    const int k0 = kt * BK;
    const uint64_t bits = tile_bits(k0);
    if (skip(bits, k0)) return;
    float s[MT][8][4];
    logits(s, 0, ks, bits, k0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[mt][n][2 * h], s[mt][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][h], mx);  // key k0 < t: m_new >= MASKED
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n) sum += expf(s[mt][n][2 * h] - m_new) + expf(s[mt][n][2 * h + 1] - m_new);
        l_run[mt][h] = l_run[mt][h] * expf(m_run[mt][h] - m_new) + sum;
        m_run[mt][h] = m_new;
      }
  };

  float r_run[MT][2];  // 1 / l, rounded to nearest
  float o[MT][2 * KS][4];  // the warp's WR x HD output, 8 columns per tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;

  // pass 2 over one tile: p = bf16(exp(s - m) / l) into A fragments, o += p V
  auto pass2 = [&](int kt, const bf16* ks) {
    const int k0 = kt * BK;
    const uint64_t bits = tile_bits(k0);
    if (skip(bits, k0)) return;
    const bf16* vs = ks + L::TILE;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // keys 32 half .. 32 half + 31
      float s[MT][4][4];
      logits(s, 4 * half, ks, bits, k0);
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {  // keys 16 kk .. 16 kk + 15 of the tile
        const int kk = 2 * half + k2;
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float* sx = s[mt][2 * k2 + (x >> 1)] + 2 * (x & 1);
            const int h = x & 1;
            const float m = m_run[mt][h], l = l_run[mt][h], r = r_run[mt][h];
            pa[mt][x] = pack_bf16(div_by(expf(sx[0] - m), l, r), div_by(expf(sx[1] - m), l, r));
          }
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {  // output tiles 2 dp and 2 dp + 1
          uint32_t b[4];
          ldsm_x4_trans(b, vs + (kk * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(o[mt][2 * dp], pa[mt], b[0], b[1]);
            mma16816(o[mt][2 * dp + 1], pa[mt], b[2], b[3]);
          }
        }
      }
    }
  };

  // key tiles kb .. ke - 1 through the 2-stage ring: tile kt + 1's copies
  // fly while tile kt is computed
  auto sweep = [&](int kb, int ke, bool with_v, auto&& body) {
    auto issue = [&](int kt) {
      bf16* ks = ring + 2 * ((kt - kb) & 1) * L::TILE;
      copy_rows<HD>(ks, k + base, kt * BK, BK, t);
      if (with_v) copy_rows<HD>(ks + L::TILE, v + base, kt * BK, BK, t);
      cp_async_commit();
    };
    __syncthreads();  // the stages' previous contents are consumed
    issue(kb);  // (the first wait also covers the Q tile's group)
    for (int kt = kb; kt < ke; ++kt) {
      cp_async_wait_all();
      __syncthreads();  // tile kt has landed; tile kt - 1's stage is free
      if (kt + 1 < ke) issue(kt + 1);
      body(kt, ring + 2 * ((kt - kb) & 1) * L::TILE);
    }
  };

  const int n_vis = causal ? (min(q0 + BQ, t) - 1) / BK + 1 : n_kt;  // up to the block's last row
  sweep(0, n_vis, false, pass1);
  // a row with no kept key at or before its position has seen only MASKED
  // logits: it averages V over all T keys, so the block walks the rest
  bool bare = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bare = bare || (i0 + 16 * mt + 8 * h < t && m_run[mt][h] <= KEPT);
  const int n_all = __syncthreads_or(bare) ? n_kt : n_vis;
  if (n_all > n_vis) sweep(n_vis, n_all, false, pass1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[mt][h] += __shfl_xor_sync(0xffffffffu, l_run[mt][h], 1);
      l_run[mt][h] += __shfl_xor_sync(0xffffffffu, l_run[mt][h], 2);
      r_run[mt][h] = 1.0f / l_run[mt][h];
    }
  sweep(0, n_all, true, pass2);

  // epilogue: the warp's WR rows through its own rows of the Q tile, then
  // 16-byte stores
  __syncwarp();  // the warp's last reads of its Q rows are done
  bf16* os = qs + warp * WR * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(os + (16 * mt + (lane >> 2) + 8 * h) * LD + 8 * n + 2 * (lane & 3)) =
            pack_bf16(o[mt][n][2 * h], o[mt][n][2 * h + 1]);
  __syncwarp();
  constexpr int CH = HD / 8;
  for (int c = lane; c < WR * CH; c += 32) {
    const int r = c / CH, cc = c % CH;
    if (row_lo + r < t)
      *reinterpret_cast<uint4*>(out + base + (size_t)(row_lo + r) * HD + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + cc * 8);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* key_mask, void* out, int bh, int t,
           int heads, int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = Layout<HD>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(block_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh * ((t + BQ - 1) / BQ);
  block_attention_kernel<HD><<<blocks, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<bf16*>(out), bh, t, heads, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: q, k, v, out [bh, t, hd]
// bf16, contiguous and 16-byte aligned; key_mask [bh / heads, t] bytes (0 =
// masked key), so head h of batch row b reads mask row b when bh = B * heads.
// hd is a multiple of 16 in [16, 128]. Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 on success).
extern "C" int block_attention_launch(const void* q, const void* k, const void* v, const void* key_mask,
                                      void* out, int bh, int t, int hd, int heads, int causal, float scale,
                                      void* stream) {
  if (bh < 1 || t < 1 || heads < 1 || bh % heads != 0 || (int64_t)bh * ((t + BQ - 1) / BQ) > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 32: return launch<32>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 48: return launch<48>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 64: return launch<64>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 80: return launch<80>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 96: return launch<96>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 112: return launch<112>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    case 128: return launch<128>(q, k, v, key_mask, out, bh, t, heads, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
