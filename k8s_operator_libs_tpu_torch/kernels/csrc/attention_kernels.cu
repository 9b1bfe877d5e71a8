// Hand-written Hopper kernel of ring attention's block step.
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, bound with ctypes in k8s_operator_libs_tpu_torch/kernels).
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// K3 block_attention: one (q block x kv block) attention contribution
//   with unnormalised online-softmax outputs.
//   Replaces _block_attention of
//   k8s_operator_libs_tpu/workloads/ring_attention.py:55-79 (the body of
//   every ring step of ring_attention_sharded, 94-143, and of
//   full_attention_reference, 146-157).
//   Inputs q [B, Sq, H, D], k and v [B, Sk, H, D], fp32, contiguous (the
//   JAX layout).  With s = (sum_d bf16(q) bf16(k) in fp32) * scale, s =
//   -1e30 where causal hides key j from query i (q_offset + i <
//   k_offset + j), m = rowmax(s) pinned to 0 where m <= -5e29,
//   p = exp(s - m):
//     num [B, Sq, H, D] = sum_j bf16(p) bf16(v), accumulated in fp32;
//     m   [B, Sq, H];
//     l   [B, Sq, H]    = sum_j p over the unrounded p.
//   Bound: device memory at the main path's shapes.  At the canary's
//   attention shape (B 32, H 16, S 512, D 64, causal) the fp32 inputs and
//   outputs are about 270 MB, 0.081 ms at 3.35 TB/s, against about
//   17 GFLOP of visible products, 0.018 ms at 989 TFLOP/s in bf16; at the
//   deep probe's shard (1, 128, 4, 64) a launch costs more than either.
//   Design: one block of four warps per (b, h, 64-row q tile); q, k and v
//   are rounded to bf16 (round to nearest even, as XLA's convert) into
//   shared memory, with D padded to a multiple of 16 by zeros; each warp
//   owns 16 query rows and forms its scores and its share of num with
//   WMMA bf16 16x16x16 products accumulated in fp32.  Two passes over the
//   kv tiles of 64 keys, as the JAX function: the first takes each row's
//   max over the whole kv block, the second forms p, l and num, so p's
//   bf16 rounding sees the same max as the plain version.  A kv tile that
//   causality hides from every row of the q tile is skipped in both
//   passes (its exact result is m 0, l 0, num 0); ragged Sq and Sk edges
//   are masked.  Each block reads its k tiles twice and its v tiles once,
//   in fp32; the blocks of one (b, h) are launched side by side, so the
//   repeated reads can come from L2.  The second pass and the fp32 loads
//   are what a one-pass online-softmax kernel would save.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"

namespace {

using namespace nvcuda;

constexpr int kRows = 64;                // query rows per block
constexpr int kKeys = 64;                // keys per kv tile
constexpr int kWarps = kRows / 16;       // each warp owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kLdS = kKeys + 4;          // fp32 score row stride
constexpr int kLdP = kKeys + 8;          // bf16 probability row stride
constexpr float kNegInf = -1e30f;        // ring_attention.py NEG_INF

struct Dims {
  int Sq, Sk, H, D;
  long long q_offset, k_offset;
  int causal;
  float scale;
};

// Rounds rows [row0, row0 + 64) of a [rows, H, D] slab (row stride H*D
// floats) into a bf16 tile with row stride ldh, zero past the last row
// and past column D.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int rows, int D,
                                          size_t row_stride) {
  constexpr int ldh = DP + 8;
  constexpr int kVecs = DP / 4;
  for (int e = threadIdx.x; e < kRows * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int col = (e % kVecs) * 4;
    const int gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows && col < D) {
      x = *reinterpret_cast<const float4*>(src + gr * row_stride + col);
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned int*>(&lo);
    packed.y = *reinterpret_cast<unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(dst + r * ldh + col) = packed;
  }
}

// This warp's 16 x 64 raw scores q . k (fp32) into its rows of sS.
template <int DP>
__device__ __forceinline__ void warp_scores(const __nv_bfloat16* sQ,
                                            const __nv_bfloat16* sK,
                                            float* sS, int warp) {
  constexpr int ldh = DP + 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kKeys / 16];
#pragma unroll
  for (int n = 0; n < kKeys / 16; ++n) wmma::fill_fragment(c[n], 0.0f);
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, sQ + warp * 16 * ldh + kd * 16, ldh);
#pragma unroll
    for (int n = 0; n < kKeys / 16; ++n) {
      // k stored [key][d] is the (d x key) operand in column-major order.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b;
      wmma::load_matrix_sync(b, sK + n * 16 * ldh + kd * 16, ldh);
      wmma::mma_sync(c[n], a, b, c[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kKeys / 16; ++n) {
    wmma::store_matrix_sync(sS + warp * 16 * kLdS + n * 16, c[n], kLdS,
                            wmma::mem_row_major);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    block_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ num, float* __restrict__ m_out,
                           float* __restrict__ l_out, Dims d) {
  constexpr int ldh = DP + 8;
  constexpr int kFrags = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kRows * ldh;
  __nv_bfloat16* sV = sK + kKeys * ldh;
  float* sS = reinterpret_cast<float*>(sV + kKeys * ldh);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + kRows * kLdS);

  const int i0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_stride = static_cast<size_t>(d.H) * d.D;
  const float* qb = q + static_cast<size_t>(b) * d.Sq * row_stride +
                    static_cast<size_t>(h) * d.D;
  const float* kb = k + static_cast<size_t>(b) * d.Sk * row_stride +
                    static_cast<size_t>(h) * d.D;
  const float* vb = v + static_cast<size_t>(b) * d.Sk * row_stride +
                    static_cast<size_t>(h) * d.D;

  load_tile<DP>(sQ, qb, i0, d.Sq, d.D, row_stride);

  // kv tiles [0, t_end) hold a key that some row of this q tile sees.
  const int n_tiles = (d.Sk + kKeys - 1) / kKeys;
  int t_end = n_tiles;
  if (d.causal) {
    const int i_last = min(i0 + kRows, d.Sq) - 1;
    const long long lim = d.q_offset + i_last - d.k_offset;
    t_end = lim < 0 ? 0
                    : static_cast<int>(
                          min(static_cast<long long>(n_tiles), lim / kKeys + 1));
  }

  // Two lanes per row: lane owns row warp*16 + lane/2 and the 32 columns
  // starting at (lane & 1) * 32 of each tile.
  const int row = warp * 16 + (lane >> 1);
  const int col0 = (lane & 1) * 32;
  const long long qpos = d.q_offset + i0 + row;
  float* s_row = sS + row * kLdS;

  // Pass 1: each row's max over the whole kv block.
  float row_max = kNegInf;
  for (int t = 0; t < t_end; ++t) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DP>(sK, kb, t * kKeys, d.Sk, d.D, row_stride);
    __syncthreads();
    warp_scores<DP>(sQ, sK, sS, warp);
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const int col = col0 + c;
      const long long j = static_cast<long long>(t) * kKeys + col;
      if (j < d.Sk && (!d.causal || qpos >= d.k_offset + j)) {
        row_max = fmaxf(row_max, s_row[col] * d.scale);
      }
    }
  }
  row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
  // Rows with no visible key: pin the max so their p is exp(-1e30) = 0.
  if (row_max <= kNegInf / 2) row_max = 0.0f;

  // Pass 2: p, l and num.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
  for (int n = 0; n < kFrags; ++n) wmma::fill_fragment(acc[n], 0.0f);
  float row_sum = 0.0f;
  __nv_bfloat16* p_row = sP + row * kLdP;
  for (int t = 0; t < t_end; ++t) {
    __syncthreads();
    load_tile<DP>(sK, kb, t * kKeys, d.Sk, d.D, row_stride);
    load_tile<DP>(sV, vb, t * kKeys, d.Sk, d.D, row_stride);
    __syncthreads();
    warp_scores<DP>(sQ, sK, sS, warp);
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const int col = col0 + c;
      const long long j = static_cast<long long>(t) * kKeys + col;
      float p = 0.0f;
      if (j < d.Sk && (!d.causal || qpos >= d.k_offset + j)) {
        p = expf(s_row[col] * d.scale - row_max);
      }
      row_sum += p;
      p_row[col] = __float2bfloat16_rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, sP + warp * 16 * kLdP + kk * 16, kLdP);
#pragma unroll
      for (int n = 0; n < kFrags; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bv;
        wmma::load_matrix_sync(bv, sV + kk * 16 * ldh + n * 16, ldh);
        wmma::mma_sync(acc[n], a, bv, acc[n]);
      }
    }
  }
  row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);

  const int i = i0 + row;
  if ((lane & 1) == 0 && i < d.Sq) {
    const size_t idx = (static_cast<size_t>(b) * d.Sq + i) * d.H + h;
    m_out[idx] = row_max;
    l_out[idx] = row_sum;
  }
  // num leaves through this warp's rows of sS, 16 columns at a time, so
  // ragged rows and the zero-padded columns are never written.
  float* stage = sS + warp * 16 * kLdS;
  float* nb = num + static_cast<size_t>(b) * d.Sq * row_stride +
              static_cast<size_t>(h) * d.D;
#pragma unroll
  for (int n = 0; n < kFrags; ++n) {
    __syncwarp();
    wmma::store_matrix_sync(stage, acc[n], kLdS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e >> 4;
      const int col = n * 16 + (e & 15);
      const int ii = i0 + warp * 16 + rr;
      if (ii < d.Sq && col < d.D) {
        nb[ii * row_stride + col] = stage[rr * kLdS + (e & 15)];
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* num,
           float* m, float* l, int B, const Dims& d, int device,
           cudaStream_t stream) {
  constexpr int ldh = DP + 8;
  const size_t smem = 3 * kRows * ldh * sizeof(__nv_bfloat16) +
                      kRows * kLdS * sizeof(float) +
                      kRows * kLdP * sizeof(__nv_bfloat16);
  // The shared-memory limit is raised once per device for each instance.
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(raised.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        block_attention_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  const dim3 grid((d.Sq + kRows - 1) / kRows, d.H, B);
  block_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(q, k, v, num,
                                                               m, l, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int attention_block_f32(const float* q, const float* k, const float* v,
                        float* num, float* m, float* l, int B, int Sq, int Sk,
                        int H, int D, long long q_offset, long long k_offset,
                        int causal, float scale, int device, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 ||
      D < 8 || D > 128 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Dims d{Sq, Sk, H, D, q_offset, k_offset, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, num, m, l, B, d, device, s);
    case 2: return launch<32>(q, k, v, num, m, l, B, d, device, s);
    case 3: return launch<48>(q, k, v, num, m, l, B, d, device, s);
    case 4: return launch<64>(q, k, v, num, m, l, B, d, device, s);
    case 5: return launch<80>(q, k, v, num, m, l, B, d, device, s);
    case 6: return launch<96>(q, k, v, num, m, l, B, d, device, s);
    case 7: return launch<112>(q, k, v, num, m, l, B, d, device, s);
    default: return launch<128>(q, k, v, num, m, l, B, d, device, s);
  }
}

}  // extern "C"
