// Shared by every scan kernel: the 16-byte load of a row segment that lets
// the kernels take any feature width. A kernel stages its operands as
// 16-byte vectors (8 bf16, 16 int8 or 4 f32 values). When the width is a
// multiple of that count (ALIGNED), every row starts 16-byte aligned and a
// segment is one vector load, zero past the row's end. Otherwise rows are
// not aligned and the last vector of a row runs past its end, so the
// segment is read byte by byte with the columns at or past the width read
// as zero. Zero columns add exactly 0 to every dot, so the result is the
// dot over the row's own columns whatever the path. Each kernel is built
// for both and its launcher picks by the width, so an aligned width runs
// the plain vector loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The 16 bytes of ES-byte elements [col, col + 16/ES) of the row of a
// row-major [rows, width] array whose first element is element `row_off`
// of `base` (16-byte aligned); elements at col >= width read as 0 and
// nothing past the row is read. `col` is a multiple of 16/ES.
template <int ES, bool ALIGNED>
__device__ __forceinline__ uint4 load_row16(const void* base, int64_t row_off, int col, int width) {
  const unsigned char* p = static_cast<const unsigned char*>(base) + (row_off + col) * ES;
  if (ALIGNED) {  // width * ES % 16 == 0
    return col < width ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (col + i / ES < width) w[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Whether rows of `width` ES-byte elements take the vector path.
template <int ES>
inline bool rows_aligned(int width) {
  return (width * ES) % 16 == 0;
}
