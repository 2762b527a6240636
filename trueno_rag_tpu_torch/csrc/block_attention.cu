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
// A masked or causal-future key gets the logit -1e9 and is not skipped, so a
// row with no kept key (an all-PAD row) comes out as the plain mean of V over
// its T keys, as in the JAX package, never NaN. Keys past T in the ragged
// last key tile are excluded outright (p = 0), so any T >= 1 is taken.
//
// What bounds it on the H100. The work is three products of 2*BH*T^2*hd
// FLOPs (see the two passes below); the kernel's bound is the causal half
// of one pass, 2*BH*T^2*hd operations at 989 TFLOP/s bf16 (8k context,
// BH = 32, hd = 128: 0.556 ms), since the bytes (q, k, v, out: 8*BH*T*hd)
// are far smaller. This first design is simple and right, not fast:
//   - one block of 4 warps per (bh, 64-row query tile); each warp owns 16
//     query rows, keeps its Q fragments in registers and its output in
//     WMMA accumulators (bf16 m16n16k16 products, f32 accumulation, on the
//     tensor cores; no certificate here rests on IEEE f32 summation order,
//     as the TPU's matrix unit has none either);
//   - pass 1 walks the 64-key tiles computing S = Q K^T and a running row
//     max and sum in fp32; pass 2 recomputes S, forms p = exp(s - m) / l,
//     ROUNDS p TO bf16 and accumulates p V in f32. The two passes keep the
//     JAX recipe (softmax in f32, then .astype(bf16), then an f32-accumulated
//     product). A one-pass online softmax would round the unnormalised p
//     instead and drift from the reference. The cost: 1.5x the FLOPs of one
//     pass (three products instead of two);
//   - every key tile is visited, the causal future included (its logits are
//     -1e9); tiles are loaded synchronously into shared memory.
// Skipping the causal future, a one-pass wgmma design and T-aware tiles are
// later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through the plain C entry point
//             block_attention_launch on the caller's stream.

#include <cuda_bf16.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;  // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e9f;  // the JAX package's logit for a masked key
static_assert(BQ == BK, "load_tile moves 64-row tiles of q, k and v alike");

// Shared-memory layout for head dim HD. Rows are padded (8 bf16 / 4 f32)
// against bank conflicts; every region starts on a 128-byte boundary and
// every WMMA fragment pointer on a 32-byte one.
template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;  // bf16 row stride of the q, k, v tiles
  static constexpr int SLD = BK + 4;  // f32 row stride of the score tile
  static constexpr int PLD = BK + 8;  // bf16 row stride of the probability tile
  static constexpr int OLD = HD + 4;  // f32 row stride of the output staging
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * LD * 2;
  static constexpr int V_OFF = K_OFF + BK * LD * 2;
  static constexpr int S_OFF = V_OFF + BK * LD * 2;
  static constexpr int P_OFF = S_OFF + BQ * SLD * 4;
  static constexpr int M_OFF = P_OFF + BQ * PLD * 2;
  static constexpr int BYTES = M_OFF + BK * 4;
  static_assert(BQ * OLD * 4 <= 2 * BK * LD * 2, "output staging must fit the k and v tiles");
};

using QFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows row0 .. row0+63 of a [t, HD] bf16 matrix into dst [64][LD]; rows past
// t are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0, int t) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int LD = Layout<HD>::LD;
  for (int c = threadIdx.x; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + cc * 8) = val;
  }
}

// key flags of tile k0: 1 kept, 0 masked, -1 past T
__device__ __forceinline__ void load_keep(int* keep, const uint8_t* __restrict__ mrow, int k0, int t) {
  if (threadIdx.x < BK) {
    const int j = k0 + threadIdx.x;
    keep[threadIdx.x] = j < t ? (mrow[j] ? 1 : 0) : -1;
  }
}

// the warp's 16 x 64 raw dots Q_w K^T into its rows of the score tile
template <int HD>
__device__ __forceinline__ void scores(const QFrag (&qa)[HD / 16], const bf16* ks, float* ss, int warp) {
  constexpr int LD = Layout<HD>::LD, SLD = Layout<HD>::SLD;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // B = K^T: element (d, key) at ks[key * LD + d], a column-major view
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, ks + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(ss + warp * 16 * SLD + n * 16, acc, SLD, wmma::mem_row_major);
  }
}

__device__ __forceinline__ float logit(float dot, int keep, int kj, int qi, int causal, float scale) {
  if (keep < 0) return -INFINITY;  // no key: excluded from the softmax
  if (keep == 0 || (causal && kj > qi)) return MASKED;
  return dot * scale;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    block_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const uint8_t* __restrict__ key_mask,
                           bf16* __restrict__ out, int t, int heads, int causal, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  int* keep = reinterpret_cast<int*>(smem + L::M_OFF);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* mrow = key_mask + (size_t)(bh / heads) * t;

  load_tile<HD>(qs, q + base, q0, t);
  __syncthreads();
  QFrag qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wmma::load_matrix_sync(qa[kk], qs + warp * 16 * L::LD + kk * 16, L::LD);

  // each lane pair owns one score row: this lane takes 32 of its 64 keys
  const int row = warp * 16 + (lane >> 1);  // row within the block
  const int qi = q0 + row;  // its query position
  const int c0 = (lane & 1) * 32;
  const float* srow = ss + row * L::SLD;
  const int n_kt = (t + BK - 1) / BK;

  // pass 1: row max m and sum l of exp(s - m), in fp32
  float m_run = -INFINITY, l_run = 0.0f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    load_tile<HD>(ks, k + base, k0, t);
    load_keep(keep, mrow, k0, t);
    __syncthreads();
    scores<HD>(qa, ks, ss, warp);
    __syncwarp();
    float mx = -INFINITY;
    for (int c = c0; c < c0 + 32; ++c) mx = fmaxf(mx, logit(srow[c], keep[c], k0 + c, qi, causal, scale));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    // key k0 < t, so mx >= -1e9 and m_new is finite
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.0f;
    for (int c = c0; c < c0 + 32; ++c) sum += expf(logit(srow[c], keep[c], k0 + c, qi, causal, scale) - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }

  // pass 2: p = bf16(exp(s - m) / l), out += p V in f32
  Acc o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  bf16* prow = ps + row * L::PLD;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<HD>(ks, k + base, k0, t);
    load_tile<HD>(vs, v + base, k0, t);
    load_keep(keep, mrow, k0, t);
    __syncthreads();
    scores<HD>(qa, ks, ss, warp);
    __syncwarp();
    for (int c = c0; c < c0 + 32; ++c) {
      const float s = logit(srow[c], keep[c], k0 + c, qi, causal, scale);
      prow[c] = __float2bfloat16(expf(s - m_run) / l_run);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      QFrag pa;
      wmma::load_matrix_sync(pa, ps + warp * 16 * L::PLD + kk * 16, L::PLD);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kk * 16 * L::LD + j * 16, L::LD);
        wmma::mma_sync(o[j], pa, vb, o[j]);
      }
    }
  }

  // epilogue: stage the f32 output in the (now free) k and v tiles, write bf16
  __syncthreads();
  float* os = reinterpret_cast<float*>(smem + L::K_OFF);
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(os + warp * 16 * L::OLD + j * 16, o[j], L::OLD, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * (HD / 2); e += 32) {
    const int rr = warp * 16 + e / (HD / 2), cc = (e % (HD / 2)) * 2;
    const int gi = q0 + rr;
    if (gi < t) {
      const float* src = os + rr * L::OLD + cc;
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)gi * HD + cc) = __floats2bfloat162_rn(src[0], src[1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* key_mask, void* out, int bh, int t,
           int heads, int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = Layout<HD>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(block_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  block_attention_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<bf16*>(out), t, heads, causal, scale);
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
  if (bh < 1 || t < 1 || heads < 1 || bh % heads != 0 || (t + BQ - 1) / BQ > 65535) {
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
