// Hand-written Hopper kernels of the node health battery.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface and bound with ctypes (k8s_operator_libs_tpu_torch/kernels).
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// K1 stream_increment: x += 1 over a contiguous fp32 array.
//   Replaces the XLA stream pass `x + 1.0` of
//   k8s_operator_libs_tpu/health/probes.py:517-519 (hbm_bandwidth_probe)
//   and the HBM chain of health/fused.py:200-203.
//   Bound: device memory.  One pass reads and writes every byte once
//   (2 x 1 GiB at the production size, about 0.64 ms at 3.35 TB/s); the
//   arithmetic is one add per 8 bytes.
//   Design: one tile of kThreads x kStreamVecs 16-byte vectors a block
//   and a grid that covers the array (262,144 blocks of 4 KiB at 1 GiB),
//   so blocks retire and start all through the pass and the card keeps
//   its memory queues full to the end.  Tried on the card and slower: a
//   persistent grid of 8 blocks an SM (each block on a contiguous
//   share, or the blocks taking equal tiles in turn) and tiles of 2, 4
//   or 8 vectors a thread issued before their stores (chip_smoke.py
//   times the persistent grid beside the kernel's).  Loads and stores
//   carry the streaming hint (ld.global.cs / st.global.cs, evict-first):
//   the buffer is 20x the 50 MB L2 and no byte is read twice.  size_t
//   index math (1 GiB is 2^30 bytes); a scalar head for a pointer that
//   is not 16-byte aligned and a scalar tail for a length that is not a
//   multiple of 4, each fewer than 4 elements.  One launch is one pass:
//   the chained passes are never folded into one launch, because the
//   probe exists to move the bytes once per pass.
//   The update is in place, where XLA's `x + 1` is out of place: the
//   bytes moved per pass and the final value are the same.
//
// K1 stream_increment_verify: one K1 pass that also returns K2's
//   (min, max, max|x - center|) of the updated x (the same fold, the same
//   NaN rules), so the fused battery's check of the stream costs no
//   second read of the 1 GiB buffer (the JAX package's health/fused.py
//   :204-205 reduce x after the chain).  Its tiles are kVerifyVecs
//   vectors a thread (their loads issued before their stores), so it
//   leaves a quarter as many per-block partials; two more launches merge
//   them, kThreads partials a block and then one block, each in a fixed
//   order, so the result does not depend on block scheduling (no float
//   atomics).
//
// K2 verify_stats: (min(x), max(x), max|x - center|) over a contiguous
//   fp32 or bf16 array.
//   Replaces the XLA verification reduction of health/fused.py:194-196
//   (max|C - 0.5| of the chained matmul) and the host-side full-matrix
//   check of probes.py:451-458 (the stream's check, 204-205, is K1's
//   verifying pass).
//   Bound: device memory, one read of the input (32 MiB for C, which
//   fits the 50 MB L2, and 1 GiB for x); three compares and a subtract
//   per element.
//   Design: two passes and no float atomics, so the result does not
//   depend on block scheduling: pass 1 writes one (min, max, dev)
//   triple per block into scratch, pass 2 merges them in one block.
//   128-bit loads (4 fp32 or 8 bf16) with the same head/tail handling
//   as K1.  NaN propagates explicitly: fminf/fmaxf return the non-NaN
//   operand, which would let a corrupted chip pass, whereas the JAX
//   reductions (jnp.min/jnp.max) propagate NaN and fail the check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

struct Stats {
  float mn;
  float mx;
  float dev;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ Stats stats_identity() {
  Stats s;
  s.mn = INFINITY;
  s.mx = -INFINITY;
  s.dev = 0.0f;
  return s;
}

__device__ __forceinline__ void fold(Stats& s, float v, float center) {
  s.mn = min_nan(s.mn, v);
  s.mx = max_nan(s.mx, v);
  s.dev = max_nan(s.dev, fabsf(v - center));
}

__device__ __forceinline__ void merge(Stats& s, const Stats& o) {
  s.mn = min_nan(s.mn, o.mn);
  s.mx = max_nan(s.mx, o.mx);
  s.dev = max_nan(s.dev, o.dev);
}

__device__ __forceinline__ Stats warp_reduce(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.mn = __shfl_down_sync(0xffffffffu, s.mn, off);
    o.mx = __shfl_down_sync(0xffffffffu, s.mx, off);
    o.dev = __shfl_down_sync(0xffffffffu, s.dev, off);
    merge(s, o);
  }
  return s;
}

// Reduces one Stats per thread of a kThreads-wide block; the result is
// valid in thread 0.  Every thread of the block must call it.
__device__ __forceinline__ Stats block_reduce(Stats s) {
  __shared__ Stats warp_stats[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s = warp_reduce(s);
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_stats[lane] : stats_identity();
    s = warp_reduce(s);
  }
  return s;
}

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Folds one 16-byte chunk: 4 fp32 values, or 8 bf16 values (a bf16 is
// the top half of an fp32, so widening is a shift and exact; the lower
// address holds the lower half of each 32-bit word).
template <typename T>
__device__ __forceinline__ void fold_chunk(Stats& s, uint4 raw, float center);

template <>
__device__ __forceinline__ void fold_chunk<float>(Stats& s, uint4 raw,
                                                  float center) {
  fold(s, __uint_as_float(raw.x), center);
  fold(s, __uint_as_float(raw.y), center);
  fold(s, __uint_as_float(raw.z), center);
  fold(s, __uint_as_float(raw.w), center);
}

template <>
__device__ __forceinline__ void fold_chunk<__nv_bfloat16>(Stats& s, uint4 raw,
                                                          float center) {
  const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    fold(s, __uint_as_float(words[k] << 16), center);
    fold(s, __uint_as_float(words[k] & 0xffff0000u), center);
  }
}

// Elements before the first 16-byte boundary, at most n.
template <typename T>
size_t head_elems(const T* x, size_t n) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const size_t head = ((16 - (addr & 15)) & 15) / sizeof(T);
  return head < n ? head : n;
}

// K1's tile: kThreads x kStreamVecs 16-byte vectors a block, one tile a
// block (the grid covers the array; the kernel also strides over tiles
// when given fewer blocks).  The verifying pass takes kVerifyVecs a
// thread, so it leaves fewer partials to merge.  A thread issues its
// loads before its stores.  kernels/battery.py sizes both grids with the
// same numbers.
constexpr int kStreamVecs = 1;
constexpr int kVerifyVecs = 4;

// Blocks of the verifying pass's middle merge: one for every kThreads
// partials of its grid.
int merge_blocks(int partials) { return (partials + kThreads - 1) / kThreads; }

// Adds 1 to x[i] and, for the verifying pass, folds the new value.
template <bool kVerify>
__device__ __forceinline__ void bump(float* x, size_t i, Stats& s,
                                     float center) {
  const float v = __ldcs(x + i) + 1.0f;
  __stcs(x + i, v);
  if (kVerify) fold(s, v, center);
}

template <int kVecs, bool kVerify>
__global__ void __launch_bounds__(kThreads)
    stream_increment_kernel(float* __restrict__ x, size_t n, size_t head,
                            size_t nvec, float center,
                            Stats* __restrict__ partials) {
  constexpr size_t kTile = static_cast<size_t>(kThreads) * kVecs;
  Stats s = stats_identity();
  const size_t tid = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
  const size_t rest = head + 4 * nvec;  // the tail, fewer than 4
  if (tid < head) bump<kVerify>(x, tid, s, center);
  if (rest + tid < n) bump<kVerify>(x, rest + tid, s, center);
  float4* __restrict__ body = reinterpret_cast<float4*>(x + head);
  for (size_t base = blockIdx.x * kTile + threadIdx.x; base < nvec;
       base += gridDim.x * kTile) {
    float4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const size_t i = base + u * kThreads;
      if (i < nvec) v[u] = __ldcs(body + i);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const size_t i = base + u * kThreads;
      if (i < nvec) {
        v[u].x += 1.0f;
        v[u].y += 1.0f;
        v[u].z += 1.0f;
        v[u].w += 1.0f;
        __stcs(body + i, v[u]);
        if (kVerify) {
          fold(s, v[u].x, center);
          fold(s, v[u].y, center);
          fold(s, v[u].z, center);
          fold(s, v[u].w, center);
        }
      }
    }
  }
  if (kVerify) {
    s = block_reduce(s);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    verify_partials_kernel(const T* __restrict__ x, size_t n, size_t head,
                           size_t nvec, float center,
                           Stats* __restrict__ partials) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t tid = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  Stats s = stats_identity();
  if (tid < head) fold(s, to_float(x[tid]), center);
  const uint4* __restrict__ body = reinterpret_cast<const uint4*>(x + head);
  for (size_t i = tid; i < nvec; i += stride) {
    fold_chunk<T>(s, body[i], center);
  }
  for (size_t i = head + kVec * nvec + tid; i < n; i += stride) {
    fold(s, to_float(x[i]), center);
  }
  s = block_reduce(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Block b merges partials [b * count / gridDim.x, (b + 1) * count /
// gridDim.x) of `in` into out[b], in a fixed order.  With one block, out
// is the result: a Stats is the three floats (min, max, dev).
__global__ void __launch_bounds__(kThreads)
    merge_partials_kernel(const Stats* __restrict__ in, int count,
                          Stats* __restrict__ out) {
  const int begin = static_cast<int>(
      static_cast<long long>(count) * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(
      static_cast<long long>(count) * (blockIdx.x + 1) / gridDim.x);
  Stats s = stats_identity();
  for (int i = begin + threadIdx.x; i < end; i += kThreads) merge(s, in[i]);
  s = block_reduce(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T>
int launch_verify(const T* x, size_t n, float center, float* partials,
                  float* out, int device, int blocks, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  constexpr int kVec = 16 / sizeof(T);
  const size_t head = head_elems(x, n);
  const size_t nvec = (n - head) / kVec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  verify_partials_kernel<T><<<blocks, kThreads, 0, s>>>(
      x, n, head, nvec, center, reinterpret_cast<Stats*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_partials_kernel<<<1, kThreads, 0, s>>>(
      reinterpret_cast<const Stats*>(partials), blocks,
      reinterpret_cast<Stats*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVerify>
int launch_stream(float* x, size_t n, float center, float* partials,
                  float* out, int device, int blocks, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const size_t head = head_elems(x, n);
  const size_t nvec = (n - head) / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVecs = kVerify ? kVerifyVecs : kStreamVecs;
  stream_increment_kernel<kVecs, kVerify><<<blocks, kThreads, 0, s>>>(
      x, n, head, nvec, center, reinterpret_cast<Stats*>(partials));
  cudaError_t err = cudaGetLastError();
  if (!kVerify || err != cudaSuccess) return static_cast<int>(err);
  // The grid's partials, then kThreads of them a block, then one block:
  // the second level lands after the first in the scratch.
  Stats* first = reinterpret_cast<Stats*>(partials);
  const int mid = merge_blocks(blocks);
  merge_partials_kernel<<<mid, kThreads, 0, s>>>(first, blocks,
                                                 first + blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_partials_kernel<<<1, kThreads, 0, s>>>(
      first + blocks, mid, reinterpret_cast<Stats*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int battery_threads_per_block() { return kThreads; }

// Scratch floats the verifying pass needs for a grid of `blocks`.
int battery_verify_scratch_floats(int blocks) {
  return 3 * (blocks + merge_blocks(blocks));
}

int battery_stream_increment(float* x, size_t n, int device, int blocks,
                             void* stream) {
  return launch_stream<false>(x, n, 0.0f, nullptr, nullptr, device, blocks,
                              stream);
}

// One K1 pass, then (min, max, max|x - center|) of the updated x into
// out[0:3]; partials holds battery_verify_scratch_floats(blocks) floats.
int battery_stream_increment_verify_f32(float* x, size_t n, float center,
                                        float* partials, float* out,
                                        int device, int blocks,
                                        void* stream) {
  return launch_stream<true>(x, n, center, partials, out, device, blocks,
                             stream);
}

int battery_verify_stats_f32(const float* x, size_t n, float center,
                             float* partials, float* out, int device,
                             int blocks, void* stream) {
  return launch_verify(x, n, center, partials, out, device, blocks, stream);
}

int battery_verify_stats_bf16(const void* x, size_t n, float center,
                              float* partials, float* out, int device,
                              int blocks, void* stream) {
  return launch_verify(static_cast<const __nv_bfloat16*>(x), n, center,
                       partials, out, device, blocks, stream);
}

const char* battery_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
