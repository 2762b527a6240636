// fetch_contribs and fetch_contribs8 for Hopper (sm_90a): the BM25 posting
// fetch with the masked Okapi contribution, one template, two entry points
// at the end of this file.
//
// Replaces the Pallas TPU kernels
//   trueno_rag_tpu/ops/pallas/bm25_fetch.py::fetch_contribs
//     (pallas_call at bm25_fetch.py:89)
//   trueno_rag_tpu/ops/pallas/bm25_fetch.py::fetch_contribs8
//     (pallas_call at bm25_fetch.py:152)
// Semantics, for packed postings [P + 256, 4] f32 (per row: the row id's
// int32 bits, tf, doc length, idf) and slots s = 0..n_slots-1, each given
// as (first[s], lo[s], hi[s]):
//   row j of slot s is packed[first[s] * scale + j], j = 0..255;
//   rows_out[s, j]    = its row bits as int32, INT32_MAX outside [lo, hi);
//   contrib_out[s, j] = its Okapi contribution, 0 outside [lo, hi).
// scale = 256 gives the JAX kernels' aligned block ids; scale = 1 takes a
// posting offset, the (start, len) segment plan (lo = 0, hi = len). A
// posting row is 16 bytes, so an unaligned start still reads aligned
// float4s, and the segment plan needs no aligned re-plan on this card.
//
// The contribution is the JAX package's expression in its own operation
// order, every step rounded once in IEEE f32 (explicit _rn intrinsics, so
// nvcc cannot contract a multiply and an add into an fma):
//   t = (1 - b) + (b * dl) / av,  av = max(avgdl, 1e-9)
//   denom = tf + k1 * t
//   contrib = ((idf * tf) * (k1 + 1)) / max(denom, 1e-9)
// (1 - b), (k1 + 1) and av come from the host as f32, as JAX folds its
// Python-float constants; the plain PyTorch version
// (ops/bm25.py::okapi_contrib) rounds op by op, so the two agree bit for bit.
//
// What bounds it on the H100: bytes. Per slot it reads at most one 4 KB
// slab and writes 2 KB (1 KB of rows, 1 KB of contributions), with a
// dozen flops per posting. The design: one thread per lane, so a warp
// reads 512 contiguous bytes as float4s and writes 128 contiguous bytes of
// each output; only lanes in [lo, hi) read, so the sentinel slots that pad
// a query's slot list up to its bucket (hi <= lo) cost only their writes.
// SLOTS = 1 (fetch_contribs) gives one slot per 256-thread block; SLOTS = 8
// (fetch_contribs8) walks 8 consecutive slots per block with all eight
// loads issued before any arithmetic, the counterpart of the Pallas
// kernel's 8 slab DMAs in flight per grid step.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry points
//             fetch_contribs_launch and fetch_contribs8_launch on the
//             caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 256;  // postings per slot (SEGMENT_LEN), one thread each
constexpr int ROW_PAD = 0x7fffffff;

struct Okapi {
  float one_minus_b, b, k1, k1p1, av;
};

__device__ __forceinline__ float contribution(float tf, float dl, float idf, const Okapi& c) {
  const float t = __fadd_rn(c.one_minus_b, __fdiv_rn(__fmul_rn(c.b, dl), c.av));
  const float denom = __fadd_rn(tf, __fmul_rn(c.k1, t));
  return __fdiv_rn(__fmul_rn(__fmul_rn(idf, tf), c.k1p1), fmaxf(denom, 1e-9f));
}

template <int SLOTS>
__global__ void __launch_bounds__(SEG) fetch_kernel(
    const int* __restrict__ first, const int* __restrict__ lo, const int* __restrict__ hi,
    const float4* __restrict__ packed, int* __restrict__ rows_out, float* __restrict__ contrib_out,
    int n_slots, int scale, Okapi c) {
  const int lane = threadIdx.x;
  const int s0 = blockIdx.x * SLOTS;
  float4 g[SLOTS];
  bool live[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int s = s0 + i;
    live[i] = false;
    g[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < n_slots) {
      const int l = lo ? __ldg(lo + s) : 0;
      live[i] = lane >= l && lane < __ldg(hi + s);
      if (live[i]) g[i] = __ldg(packed + (static_cast<int64_t>(__ldg(first + s)) * scale + lane));
    }
  }
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int s = s0 + i;
    if (s >= n_slots) break;
    const int64_t o = static_cast<int64_t>(s) * SEG + lane;
    rows_out[o] = live[i] ? __float_as_int(g[i].x) : ROW_PAD;
    contrib_out[o] = live[i] ? contribution(g[i].y, g[i].z, g[i].w, c) : 0.0f;
  }
}

template <int SLOTS>
int launch(const void* first, const void* lo, const void* hi, const void* packed, void* rows_out,
           void* contrib_out, int n_slots, int scale, float one_minus_b, float b, float k1,
           float k1p1, float av, void* stream) {
  if (n_slots < 0 || scale < 1) return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return (int)cudaSuccess;
  const Okapi c{one_minus_b, b, k1, k1p1, av};
  const unsigned grid = static_cast<unsigned>((n_slots + SLOTS - 1) / SLOTS);
  fetch_kernel<SLOTS><<<grid, SEG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(first), static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const float4*>(packed), static_cast<int*>(rows_out),
      static_cast<float*>(contrib_out), n_slots, scale, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: first, hi [n_slots]
// int32, lo [n_slots] int32 or null (every lo 0), packed [P + 256, 4] f32,
// 16-byte aligned, with first[s] * scale + 256 <= P + 256 for every slot;
// outputs rows_out [n_slots, 256] int32 and contrib_out [n_slots, 256] f32.
// Launch on `stream`, allocate nothing, and return cudaGetLastError()
// (0 on success).
extern "C" int fetch_contribs_launch(const void* first, const void* lo, const void* hi,
                                     const void* packed, void* rows_out, void* contrib_out,
                                     int n_slots, int scale, float one_minus_b, float b,
                                     float k1, float k1p1, float av, void* stream) {
  return launch<1>(first, lo, hi, packed, rows_out, contrib_out, n_slots, scale, one_minus_b, b,
                   k1, k1p1, av, stream);
}

extern "C" int fetch_contribs8_launch(const void* first, const void* lo, const void* hi,
                                      const void* packed, void* rows_out, void* contrib_out,
                                      int n_slots, int scale, float one_minus_b, float b,
                                      float k1, float k1p1, float av, void* stream) {
  return launch<8>(first, lo, hi, packed, rows_out, contrib_out, n_slots, scale, one_minus_b, b,
                   k1, k1p1, av, stream);
}
