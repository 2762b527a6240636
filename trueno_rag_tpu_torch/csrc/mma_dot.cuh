// The two tensor-core dots behind one interface, for the kernels whose
// program is the same at either element type: bf16 (mma_bf16.cuh's split
// f32 dot, 64 columns per ring stage, widths padded to 16) and int8
// (mma_s8.cuh's chained s32 dot, 128 columns per stage, widths padded to
// 32). Both stage 128 bytes of a row per stage (eight 16-byte vectors) at
// the same 144-byte stride, so a ring stage has the same bytes at either
// type, and both accumulators share one fragment layout. Used by the
// MaxSim template (maxsim_scan.cu: K6, K7, K11a, K11b), the tile scans
// (scan_select_tile.cuh: K1, K5, K10a, K10b, K3, K10c) and the block scans
// (scan_select_v1.cu: K8, K9).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_s8.cuh"

namespace mma_dot {

template <typename E>
struct Dot;

template <>
struct Dot<__nv_bfloat16> {
  using Acc = mma_bf16::Acc;
  static constexpr int KD = mma_bf16::KD, DK = 16, PAD = mma_bf16::PAD, SROW = mma_bf16::SROW, VE = 8;
  __host__ __device__ static constexpr int pad(int h) { return mma_bf16::pad16(h); }
  __host__ __device__ static constexpr bool resident(int h) { return mma_bf16::a_resident(h); }
  __host__ __device__ static constexpr int slices(int h) { return mma_bf16::k_slices(h); }
  __host__ __device__ static constexpr int resident_bytes(int h) { return mma_bf16::resident_bytes(h); }
  __device__ __forceinline__ static void zero(Acc& acc) { mma_bf16::zero(acc); }
  __device__ __forceinline__ static void run(Acc& acc, const __nv_bfloat16* a, int a_stride,
                                             const __nv_bfloat16* b, int nk, int a_rows) {
    mma_bf16::dot_slices(acc, a, a_stride, b, nk, a_rows);
  }
};

template <>
struct Dot<int8_t> {
  using Acc = mma_s8::Acc;
  static constexpr int KD = mma_s8::KD, DK = 32, PAD = mma_s8::PAD, SROW = mma_s8::SROW, VE = 16;
  __host__ __device__ static constexpr int pad(int h) { return mma_s8::pad32(h); }
  __host__ __device__ static constexpr bool resident(int h) { return mma_s8::a_resident(h); }
  __host__ __device__ static constexpr int slices(int h) { return mma_s8::k_slices(h); }
  __host__ __device__ static constexpr int resident_bytes(int h) { return mma_s8::resident_bytes(h); }
  __device__ __forceinline__ static void zero(Acc& acc) { mma_s8::zero(acc); }
  __device__ __forceinline__ static void run(Acc& acc, const int8_t* a, int a_stride, const int8_t* b,
                                             int nk, int a_rows) {
    mma_s8::dot_slices(acc, a, a_stride, b, nk, a_rows);
  }
};

}  // namespace mma_dot
