// moe_combine for Hopper (sm_90a): the tail of a DeepSeekMoE layer in one
// pass. Each token's k routed expert outputs are gathered from expert-sorted
// order, weighted by their gates and summed in f32 in gate order; the sum is
// rounded to bf16, the shared experts' output and the residual are added,
// and the new residual is written once.
//
// Replaces no TPU kernel: the JAX package has no expert layer. It takes the
// place of the PyTorch expression in models/deepseek_v2.py::moe_mlp (kept
// as ops/kernels/moe_combine.py::moe_combine_reference), which moved each
// layer's pairs through device memory some ten times.
//
// Semantics, for positions q = 0..P-1 of the residual x [P, H] and the
// shared experts' output shared [P, H] (both bf16), the second grouped
// product's rows out [n*k, H] bf16 in expert-sorted order, src [n*k] int32
// (pair p = token*k + rank lies in row src[p] of out), the gates
// weight [n, k] f32 and slot [P] int32 (q's real-token index, or -1):
//   t = slot[q]; for t >= 0
//     acc = out[src[t*k]] * weight[t, 0], then for r = 1..k-1
//     acc = acc + out[src[t*k + r]] * weight[t, r]        (f32)
//     routed = bf16(acc);                 for t < 0, routed = 0
//   s = bf16(routed + shared[q]);  y[q] = bf16(x[q] + s)
// Every product and sum is rounded once in IEEE f32 (explicit _rn
// intrinsics, so nvcc cannot contract them into an fma) and every bf16
// rounding is to nearest even, as PyTorch's elementwise kernels do it, so
// the result equals the plain version bit for bit.
//
// What bounds it on the H100: bytes. At DeepSeek-V2-Lite's cell (36,804
// pairs of 2,048 lanes, 8,192 positions) it reads 150.7 MB of expert rows
// and 67 MB of residual and shared output and writes 33.5 MB: ~0.075 ms at
// 3.35 TB/s, with one multiply and one add per lane and pair. The design:
// one block per position, one thread per 8 lanes (a 16-byte load of each
// row), so a warp reads 512 contiguous bytes of a row; a thread issues the
// loads of up to GATHER expert rows, the residual and the shared row before
// it adds, and intermediates stay in registers. Padding positions read no
// expert row. A width that is not a multiple of 8, or a pointer that is not
// 16-byte aligned, takes the same program one lane per thread.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry point
//             moe_combine_launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GATHER = 8;  // expert rows whose loads a thread issues together

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ uint32_t round_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// VEC lanes of a bf16 row: 8 as one 16-byte load, or 1.
template <int VEC>
struct Lanes;

template <>
struct Lanes<8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const uint16_t* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ float lane(const Raw& r, int j) {
    const uint32_t w = (&r.x)[j >> 1];
    return bf16_bits_to_float((j & 1) ? (w >> 16) : (w & 0xffffu));
  }
  static __device__ __forceinline__ void store(uint16_t* p, const uint32_t (&b)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(b[0] | (b[1] << 16), b[2] | (b[3] << 16), b[4] | (b[5] << 16), b[6] | (b[7] << 16));
  }
};

template <>
struct Lanes<1> {
  using Raw = uint16_t;
  static __device__ __forceinline__ Raw load(const uint16_t* p) { return __ldg(p); }
  static __device__ __forceinline__ float lane(const Raw& r, int) { return bf16_bits_to_float(r); }
  static __device__ __forceinline__ void store(uint16_t* p, const uint32_t (&b)[1]) {
    *p = static_cast<uint16_t>(b[0]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(THREADS) moe_combine_kernel(
    const uint16_t* __restrict__ out, const int* __restrict__ src, const float* __restrict__ weight,
    const int* __restrict__ slot, const uint16_t* __restrict__ x, const uint16_t* __restrict__ shared,
    uint16_t* __restrict__ y, int k, int h) {
  using L = Lanes<VEC>;
  const int q = blockIdx.x;
  const int t = __ldg(slot + q);
  const int* s = src + static_cast<int64_t>(t) * k;
  const float* w = weight + static_cast<int64_t>(t) * k;
  const int64_t row = static_cast<int64_t>(q) * h;
  for (int col = threadIdx.x * VEC; col < h; col += THREADS * VEC) {
    const typename L::Raw xr = L::load(x + row + col), sr = L::load(shared + row + col);
    float acc[VEC] = {};
    if (t >= 0) {
      for (int r0 = 0; r0 < k; r0 += GATHER) {
        typename L::Raw g[GATHER];
        float wr[GATHER];
#pragma unroll
        for (int i = 0; i < GATHER; ++i) {
          if (r0 + i < k) {
            wr[i] = __ldg(w + r0 + i);
            g[i] = L::load(out + static_cast<int64_t>(__ldg(s + r0 + i)) * h + col);
          }
        }
#pragma unroll
        for (int i = 0; i < GATHER; ++i) {
          if (r0 + i < k) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float p = __fmul_rn(L::lane(g[i], j), wr[i]);
              acc[j] = r0 + i == 0 ? p : __fadd_rn(acc[j], p);
            }
          }
        }
      }
    }
    uint32_t b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float routed = t >= 0 ? bf16_bits_to_float(round_bf16(acc[j])) : 0.0f;
      const float sum = bf16_bits_to_float(round_bf16(__fadd_rn(routed, L::lane(sr, j))));
      b[j] = round_bf16(__fadd_rn(L::lane(xr, j), sum));
    }
    L::store(y + row + col, b);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: out [n*k, h] bf16,
// src [n*k] int32 (each in [0, n*k)), weight [n, k] f32, slot [positions]
// int32 (each -1 or in [0, n)), x, shared and y [positions, h] bf16, all
// contiguous; y may not alias an input. Lanes go 8 to a thread when h % 8
// == 0 and out, x, shared and y are 16-byte aligned, else 1. Launch on
// `stream`, allocate nothing, and return cudaGetLastError() (0 on success).
extern "C" int moe_combine_launch(const void* out, const void* src, const void* weight, const void* slot,
                                  const void* x, const void* shared, void* y, int positions, int k, int h,
                                  void* stream) {
  if (positions < 0 || k < 1 || h < 1) return (int)cudaErrorInvalidValue;
  if (positions == 0) return (int)cudaSuccess;
  const auto* o = static_cast<const uint16_t*>(out);
  const auto* xs = static_cast<const uint16_t*>(x);
  const auto* sh = static_cast<const uint16_t*>(shared);
  auto* ys = static_cast<uint16_t*>(y);
  const auto* s = static_cast<const int*>(src);
  const auto* w = static_cast<const float*>(weight);
  const auto* sl = static_cast<const int*>(slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h % 8 == 0 && aligned16(out) && aligned16(x) && aligned16(shared) && aligned16(y)) {
    moe_combine_kernel<8><<<positions, THREADS, 0, st>>>(o, s, w, sl, xs, sh, ys, k, h);
  } else {
    moe_combine_kernel<1><<<positions, THREADS, 0, st>>>(o, s, w, sl, xs, sh, ys, k, h);
  }
  return (int)cudaGetLastError();
}
