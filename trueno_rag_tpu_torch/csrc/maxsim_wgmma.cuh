// K6's Hopper program: maxsim_scan16_scores (maxsim_scan.cu's bf16 MaxSim
// with the t_mask fold) at every width whose rows are 16-byte aligned
// (H % 8 == 0, which TMA needs), on TMA, mbarriers and wgmma. Odd widths keep
// maxsim_scan.cu's cp.async program. The wrapper (ops/kernels/maxsim_scan.py,
// _k6_program) chooses the entry point by the width alone.
//
// Replaces the Pallas TPU kernel
//   trueno_rag_tpu/ops/pallas/maxsim_scan.py::maxsim_scan16_scores
//     (pallas_call at maxsim_scan.py:268)
// with the semantics maxsim_scan.cu states: out[b, n] = sum_i best_i,
// best_i = max_j <q_i, tok_j> over the chunk's valid tokens, an empty chunk's
// best 0, an invalid chunk -inf, the Lq-sum over i in ascending order.
//
// What bounds it on the H100. At the late-interaction store's launch
// (N = 262,144 chunks x Lt 32 x H 384, B = 32, Lq = 16, ~320 real query
// tokens) the real work is 2*Q*N*Lt*H = 2.06 TFLOP, 2.09 ms at the bf16
// peak, against 6.44 GB of tokens, 1.92 ms at 3.35 TB/s: the operations
// bound it, and on the 512 padded query rows the tensor cores see 3.3 TFLOP.
// At the smoke's serving shape (1,048,576 x 32 x 128, B = 8, Lq = 8) the
// bytes bound it: 8.6 GB, 2.585 ms, against 0.55 TFLOP.
//
// The program. One block per (128-chunk tile, group of whole queries), the
// group the fastest-varying part of the block index so that the blocks of
// one tile run together and its tokens cross from HBM once. A block holds
// RT = 64*R query rows: R = 2 (128 rows, 8 queries at Lq = 16) where B*Lq
// and a group fill more than 64, else R = 1; so each token tile crosses from
// L2 once per 128 query rows, half as often as the cp.async program's 64. A
// producer warpgroup (one thread) keeps TMA loads of the [N, Lt, H] replica
// in flight through an mbarrier ring: a 3-D tensor map over (H, Lt, N), a
// box of 64 columns x 1 position x 128 chunks (16 KB, 128-byte swizzle).
// The block's query rows stay resident in shared memory (a 2-D map over
// [B*Lq, H], one box per 64 columns of the width), or, where they do not fit
// beside the ring, stream beside each token box. Two consumer warpgroups
// (setmaxnreg 232 against the producer's 40) run wgmma m64n64k16 on each
// box: at R = 2 each takes 64 query rows against the 128 chunks in two
// wgmmas per k16 slice, at R = 1 each the 64 rows against 64 of the chunks.
// Columns past H, chunks past N and query rows past B*Lq arrive as TMA's
// zero fill. Each warpgroup keeps the dots of one position in registers, up
// to three wgmmas in flight into rotating result buffers while it adds the
// oldest; after a position's last box it folds the dots into the running
// maxes, which live in shared memory so that the registers hold the
// pipeline, and those maxes feed the ordered Lq-sum.
//
// What holds it above its bound: the split accumulation costs one FADD per
// dot per k16 slice, as many instruction slots as the slice costs the tensor
// cores, and the adds overlap the wgmmas only in part (PERF.md §6).
//
// Numbers: the same bits as the cp.async program. mma_bf16.cuh's split
// accumulation is kept: each k16 slice is one wgmma with scale-d = 0, so it
// sums that slice's <= 16 products and nothing else (as an mma.sync with
// C = 0 does), and its result is added into the f32 dot with __fadd_rn, the
// slices in ascending column order from +0. So the certificate's budget
// (kappa = (H+Lq)*2^-23), ops/kernels/mma_model.py's allowance and
// chip_smoke.py's mma-probe hold unchanged, and the card tests hold K11a and
// K11b (the cp.async program) equal to K6 bit for bit. The fold takes
// max(best, dot) at a valid token and skips a masked one: the cp.async
// program's fmaxf(best, dot + 0 or NaN) differs only in the sign of a zero
// best, which the Lq-sum (started at +0) cannot show.
//
// Built with maxsim_scan.cu (nvcc -gencode arch=compute_90a,code=sm_90a);
// the tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so nothing
// links against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace maxsim_wgmma {

constexpr int CT = 128;                    // chunks per block tile
constexpr int KB = 64;                     // columns per box: one 128-byte swizzle row
constexpr int BOX_ROW = KB * 2;            // bytes of a box row
constexpr int TOK_BOX = CT * BOX_ROW;      // bytes of one token box
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
constexpr int QG_MAX = 16;                 // whole queries per block
constexpr int BSTR = 136;                  // bests row stride (f32): float2 stores conflict-free
constexpr int NST_MAX = 8;                 // ring stages at most
constexpr int SMEM_MAX = 232448;           // dynamic shared memory a block may use
constexpr int ALIGN = 1024;                // the 128-byte swizzle's period: boxes start on it
constexpr int FIXED = ALIGN + QG_MAX * CT * 4 + (2 * NST_MAX + 1) * 8;  // slack, Lq-sums, barriers

__host__ __device__ constexpr int pad16(int w) { return (w + 15) & ~15; }
// 64-column boxes across a row of width w
__host__ __device__ constexpr int boxes(int w) { return (pad16(w) + KB - 1) / KB; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// A wgmma operand in shared memory: K-major rows of 128 bytes under the
// 128-byte swizzle, 8-row groups 1,024 bytes apart; a k16 slice starts
// 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The registers a wgmma wrote are read only after this point.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A(64 x 16) . B(64 x 16)^T, one k16 slice with scale-d = 0: the slice's
// products summed and nothing else. Thread t of the warpgroup holds d[i] at
// row 16*(t/32) + (t%32)/4 + 8*((i/2)%2), column 8*(i/4) + 2*(t%4) + i%2.
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, 0, 1, 1, 0, 0;\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b));
}

// The wgmma.wait_group of a count known once the loop around it unrolls.
__device__ __forceinline__ void wg_wait_le(int n) {
  switch (n) {
    case 0: wg_wait<0>(); break;
    case 1: wg_wait<1>(); break;
    case 2: wg_wait<2>(); break;
    default: wg_wait<3>(); break;
  }
}

// A consumer warpgroup w's tile: at R = 2 rows 64*w.. against all 128
// chunks, at R = 1 the 64 rows against chunks 64*w..; each k16 slice is NH
// wgmmas of 64 chunks, and NB result buffers keep up to NB - 1 of them in
// flight while the adds of another run.
template <int R, int NB>
struct Tile {
  static constexpr int NW = 64 * R;        // chunks of the warpgroup's tile
  static constexpr int NH = R;             // wgmmas per k16 slice
  static constexpr int NACC = NW / 2;      // f32 of the tile per thread
  static constexpr int ND = 32;            // f32 of one wgmma per thread
  static constexpr int NQW = NW / 32;      // 32-chunk mask words
  static constexpr int OPS = NH * KB / 16; // wgmmas per full box
  static_assert(NB >= NH && NB - 1 <= OPS && NB <= 4, "the buffers cover a slice and wg_wait_le's range");
};

template <int R, int NB>
__global__ void __launch_bounds__(THREADS, 1)
maxsim_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,    // [B*Lq, H] bf16, box (64, 64*R)
                         const __grid_constant__ CUtensorMap tm_tok,  // [N, Lt, H] bf16, box (64, 1, 128)
                         const unsigned char* __restrict__ t_mask,    // [N*Lt] bool
                         const unsigned char* __restrict__ valid,     // [N] bool
                         float* __restrict__ out,                     // [B, N]
                         int nq, int lq, int n, int lt, int h, int qg, int n_groups, int nst, int res) {
  using C = Tile<R, NB>;
  constexpr int RT = 64 * R;  // query rows per sub-tile
  const int q_box = RT * BOX_ROW;
  const int kbn = boxes(h);
  const int hp = pad16(h);
  const int stage_bytes = TOK_BOX + (res ? 0 : q_box);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  unsigned char* ring = qs + (res ? kbn * q_box : 0);
  float* bests = reinterpret_cast<float*>(ring + nst * stage_bytes);  // [RT][BSTR] running maxes
  float(*sum)[CT] = reinterpret_cast<float(*)[CT]>(bests + RT * BSTR);
  uint64_t* full = reinterpret_cast<uint64_t*>(sum + QG_MAX);
  uint64_t* empty = full + NST_MAX;
  uint64_t* qbar = empty + NST_MAX;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x % n_groups;
  const int c0 = (blockIdx.x / n_groups) * CT;
  const int64_t row0 = (int64_t)g * qg * lq;  // the group's first flat query row
  const int rows = qg * lq;                   // the group's query rows
  const int steps = lt * kbn;                 // ring steps per sub-tile: positions x boxes

  for (int p = tid; p < QG_MAX * CT; p += THREADS) (&sum[0][0])[p] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS / 32);
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each role keeps to its own branch to the end (setmaxnreg needs it); they
  // meet at named barrier 2 once per sub-tile, after its Lq-sum.
  if (warp >= CONSUMERS / 32) {
    // the producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int s = 0, ph = 0;  // the ring's stage and phase, carried across sub-tiles
    for (int sub = 0; sub * RT < rows; ++sub) {
      const int qrow = (int)(row0 + sub * RT);
      if (tid == CONSUMERS) {
        if (res) {
          bar_expect(qbar, kbn * q_box);
          for (int kb = 0; kb < kbn; ++kb) tma_2d(qs + kb * q_box, &tm_q, qbar, kb * KB, qrow);
        }
        for (int t = 0, j = 0, kb = 0; t < steps; ++t) {
          bar_wait(&empty[s], ph ^ 1);
          unsigned char* st = ring + s * stage_bytes;
          bar_expect(&full[s], stage_bytes);
          tma_3d(st, &tm_tok, &full[s], kb * KB, j, c0);
          if (!res) tma_2d(st + TOK_BOX, &tm_q, &full[s], kb * KB, qrow);
          if (++kb == kbn) kb = 0, ++j;
          if (++s == nst) s = 0, ph ^= 1;
        }
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = warp >> 2, w4 = warp & 3;
    const int row_off = R == 2 ? 64 * w : 0;
    const int col_off = R == 2 ? 0 : 64 * w;
    // this thread's running maxes: element i of its tile (row 16*w4 + lane/4
    // + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2) at bp[off(i)]
    float* bp = bests + (row_off + 16 * w4 + (lane >> 2)) * BSTR + col_off + 2 * (lane & 3);
    auto off = [](int i) { return 8 * ((i >> 1) & 1) * BSTR + 8 * (i >> 2); };
    int s = 0, ph = 0;
    for (int sub = 0; sub * RT < rows; ++sub) {
      const int sub_rows = min(RT, rows - sub * RT);
      const bool live = row_off < sub_rows;  // warpgroup-uniform
      float acc[C::NACC], d[NB][C::ND];
      if (live) {
#pragma unroll
        for (int i = 0; i < C::NACC; i += 2)
          *reinterpret_cast<float2*>(bp + off(i)) = make_float2(-INFINITY, -INFINITY);
      }
      // the mask bytes of the warpgroup's chunks col_off + lane + 32*q at the
      // next position, loaded a position ahead; their ballots at this one
      uint32_t mraw[C::NQW], mw[C::NQW];
      auto load_mask = [&](int j) {
#pragma unroll
        for (int q = 0; q < C::NQW; ++q) {
          const int c = c0 + col_off + lane + 32 * q;
          mraw[q] = c < n ? t_mask[(int64_t)c * lt + j] : 0u;
        }
      };
      // acc += the k16 slice of chunks 64*hh.. that buffer b holds (acc
      // starts each position at +0, as mma_bf16.cuh's sum does)
      auto add = [&](int b, int hh) {
        reg_fence(d[b]);
#pragma unroll
        for (int i = 0; i < C::ND; ++i) acc[hh * C::ND + i] = __fadd_rn(acc[hh * C::ND + i], d[b][i]);
      };
#pragma unroll
      for (int i = 0; i < C::NACC; ++i) acc[i] = 0.0f;
      load_mask(0);
      if (res) bar_wait(qbar, sub & 1);
      for (int t = 0, j = 0, kb = 0; t < steps; ++t) {
        if (kb == 0) {
#pragma unroll
          for (int q = 0; q < C::NQW; ++q) mw[q] = __ballot_sync(0xffffffffu, mraw[q] != 0u);
          if (j + 1 < lt) load_mask(j + 1);
        }
        bar_wait(&full[s], ph);
        if (live) {
          const unsigned char* st = ring + s * stage_bytes;
          const uint32_t a0 = smem_u32(res ? qs + kb * q_box : st + TOK_BOX) + row_off * BOX_ROW;
          const uint32_t b0 = smem_u32(st) + col_off * BOX_ROW;
          const int nsl = min(KB, hp - kb * KB) / 16;
          // wgmma o: slice o / NH (32 bytes further along the rows: 2 in the
          // descriptor's address field), chunks (o % NH) * 64.., into buffer b
          const uint64_t da = desc(a0), db = desc(b0);
          auto mma = [&](int o, int b) {
            wg_fence();
            mma_m64n64k16(d[b], da + 2 * (o / C::NH), db + (o % C::NH) * (64 * BOX_ROW / 16) + 2 * (o / C::NH));
            wg_commit();
          };
          if (nsl == KB / 16) {
            // a full box in straight-line code: NB - 1 wgmmas in flight while
            // the adds of the oldest run
#pragma unroll
            for (int o = 0; o < NB - 1; ++o) mma(o, o % NB);
#pragma unroll
            for (int o = 0; o < C::OPS; ++o) {
              if (o + NB - 1 < C::OPS) mma(o + NB - 1, (o + NB - 1) % NB);
              wg_wait_le(min(NB - 1, C::OPS - 1 - o));
              add(o % NB, o % C::NH);
            }
          } else {
            for (int k = 0; k < nsl; ++k) {
#pragma unroll
              for (int hh = 0; hh < C::NH; ++hh) mma(k * C::NH + hh, hh);
              wg_wait<0>();
#pragma unroll
              for (int hh = 0; hh < C::NH; ++hh) add(hh, hh);
            }
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);
        if (++s == nst) s = 0, ph ^= 1;
        if (live && kb == kbn - 1) {
          // the position's full dots: fold into the running maxes, skipping
          // masked tokens
          uint32_t all = mw[0];
#pragma unroll
          for (int q = 1; q < C::NQW; ++q) all &= mw[q];
          if (all == 0xffffffffu) {
#pragma unroll
            for (int i = 0; i < C::NACC; i += 2) {
              float2* p = reinterpret_cast<float2*>(bp + off(i));
              const float2 b = *p;
              *p = make_float2(fmaxf(b.x, acc[i]), fmaxf(b.y, acc[i + 1]));
            }
          } else {
            uint32_t sw[C::NQW];
#pragma unroll
            for (int q = 0; q < C::NQW; ++q) sw[q] = mw[q] >> (2 * (lane & 3));
#pragma unroll
            for (int i = 0; i < C::NACC; i += 2) {
              const uint32_t m = sw[i >> 4] >> (8 * ((i >> 2) & 3));  // bit e: column 8*(i/4) + 2*(lane%4) + e
              float2* p = reinterpret_cast<float2*>(bp + off(i));
              float2 b = *p;
              if (m & 1u) b.x = fmaxf(b.x, acc[i]);
              if (m & 2u) b.y = fmaxf(b.y, acc[i + 1]);
              *p = b;
            }
          }
#pragma unroll
          for (int i = 0; i < C::NACC; ++i) acc[i] = 0.0f;
        }
        if (++kb == kbn) kb = 0, ++j;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      // the ordered Lq-sum: each (query, chunk) pair adds its rows of the
      // sub-tile in ascending order, an empty chunk's -inf best counting 0
      for (int p = tid; p < qg * CT; p += CONSUMERS) {
        const int qi = p / CT, c = p % CT;
        const int lo = max(qi * lq, sub * RT);
        const int hi = min((qi + 1) * lq, sub * RT + sub_rows);
        float v = sum[qi][c];
        for (int r = lo; r < hi; ++r) {
          const float x = bests[(r - sub * RT) * BSTR + c];
          v = __fadd_rn(v, isfinite(x) ? x : 0.0f);
        }
        sum[qi][c] = v;
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
    }
    for (int p = tid; p < qg * CT; p += CONSUMERS) {
      const int qi = p / CT;
      const int64_t b = (int64_t)g * qg + qi;
      const int64_t c = c0 + p % CT;
      if (b < nq && c < n) out[b * n + c] = valid[c] ? sum[qi][p % CT] : -INFINITY;
    }
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first) under the 128-byte
// swizzle, zero fill past every edge.
inline bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapL2promotion promo) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promo,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whole queries per block at RT query rows.
inline int group_size(int rt, int lq) {
  const int qg = rt / lq;
  return qg < 1 ? 1 : (qg > QG_MAX ? QG_MAX : qg);
}

// 128 query rows a block where the batch and a group fill more than 64.
inline int row_tiles(int nq, int lq) {
  return (int64_t)nq * lq > 64 && group_size(128, lq) * lq > 64 ? 2 : 1;
}

template <int R, int NB>
int launch_r(const void* q16, const void* tok16, const void* t_mask, const void* valid, void* out, int nq, int lq,
             int n, int lt, int h, void* stream) {
  constexpr int RT = 64 * R;
  const int qg = group_size(RT, lq);
  const int n_groups = (nq + qg - 1) / qg;
  const int64_t blocks = (int64_t)((n + CT - 1) / CT) * n_groups;
  if (n_groups > 65535 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int q_box = RT * BOX_ROW;
  const int bests = RT * BSTR * 4;
  const int res_bytes = boxes(h) * q_box;
  // resident query rows where three ring stages still fit beside them
  const int res = res_bytes + bests + 3 * TOK_BOX + FIXED <= SMEM_MAX;
  const int stage = TOK_BOX + (res ? 0 : q_box);
  int nst = (SMEM_MAX - FIXED - bests - (res ? res_bytes : 0)) / stage;
  nst = nst > NST_MAX ? NST_MAX : nst;
  if (nst < 2) return (int)cudaErrorInvalidValue;
  const int bytes = FIXED + bests + (res ? res_bytes : 0) + nst * stage;

  CUtensorMap tm_q, tm_tok;
  const cuuint64_t q_dims[2] = {(cuuint64_t)h, (cuuint64_t)nq * lq};
  const cuuint64_t q_strides[1] = {(cuuint64_t)h * 2};
  const cuuint32_t q_boxdim[2] = {KB, RT};
  const cuuint64_t t_dims[3] = {(cuuint64_t)h, (cuuint64_t)lt, (cuuint64_t)n};
  const cuuint64_t t_strides[2] = {(cuuint64_t)h * 2, (cuuint64_t)lt * h * 2};
  const cuuint32_t t_boxdim[3] = {KB, 1, CT};
  if (!encode(&tm_q, q16, 2, q_dims, q_strides, q_boxdim, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&tm_tok, tok16, 3, t_dims, t_strides, t_boxdim, CU_TENSOR_MAP_L2_PROMOTION_L2_256B)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = maxsim_scan_wgmma_kernel<R, NB>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_tok, static_cast<const unsigned char*>(t_mask), static_cast<const unsigned char*>(valid),
      static_cast<float*>(out), nq, lq, n, lt, h, qg, n_groups, nst, res);
  return (int)cudaGetLastError();
}

// K6 at an aligned width (h % 8 == 0): q16 [nq, lq, h] and tok16 [n, lt, h]
// bf16, 16-byte aligned; t_mask [n, lt] and valid [n] bool; out [nq, n] f32.
inline int launch(const void* q16, const void* tok16, const void* t_mask, const void* valid, void* out, int nq,
                  int lq, int n, int lt, int h, void* stream) {
  if (nq < 1 || lq < 1 || n < 1 || lt < 1 || h < 1 || h % 8 != 0) return (int)cudaErrorInvalidValue;
  return row_tiles(nq, lq) == 2
             ? launch_r<2, 4>(q16, tok16, t_mask, valid, out, nq, lq, n, lt, h, stream)
             : launch_r<1, 3>(q16, tok16, t_mask, valid, out, nq, lq, n, lt, h, stream);
}

}  // namespace maxsim_wgmma
