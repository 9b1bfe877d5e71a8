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
//   Design: 128-bit float4 loads and stores, a grid-stride loop over a
//   grid sized to the SM count, size_t index math (1 GiB is 2^30 bytes),
//   and scalar head/tail loops for a pointer that is not 16-byte aligned
//   or a length that is not a multiple of 4.  One launch is one pass:
//   the chained passes are never folded into one launch, because the
//   probe exists to move the bytes once per pass.
//   The update is in place, where XLA's `x + 1` is out of place: the
//   bytes moved per pass and the final value are the same.
//
// K2 verify_stats: (min(x), max(x), max|x - center|) over a contiguous
//   fp32 or bf16 array.
//   Replaces the XLA verification reductions of health/fused.py:194-196
//   (max|C - 0.5| of the chained matmul) and 204-205 (min and max of the
//   stream), and the host-side full-matrix check of probes.py:451-458.
//   Bound: device memory, one read of the input (32 MiB for C, which
//   fits the 50 MB L2, and 1 GiB for x); three compares and a subtract
//   per element.
//   Design: two passes and no float atomics, so the result does not
//   depend on block scheduling: pass 1 writes one (min, max, dev)
//   triple per block into scratch, pass 2 reduces them in one block.
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

__global__ void __launch_bounds__(kThreads)
    stream_increment_kernel(float* __restrict__ x, size_t n, size_t head,
                            size_t nvec) {
  const size_t tid = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  if (tid < head) x[tid] += 1.0f;
  float4* __restrict__ body = reinterpret_cast<float4*>(x + head);
  for (size_t i = tid; i < nvec; i += stride) {
    float4 v = body[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    body[i] = v;
  }
  for (size_t i = head + 4 * nvec + tid; i < n; i += stride) x[i] += 1.0f;
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

__global__ void __launch_bounds__(kThreads)
    verify_final_kernel(const Stats* __restrict__ partials, int count,
                        float* __restrict__ out) {
  Stats s = stats_identity();
  for (int i = threadIdx.x; i < count; i += blockDim.x) merge(s, partials[i]);
  s = block_reduce(s);
  if (threadIdx.x == 0) {
    out[0] = s.mn;
    out[1] = s.mx;
    out[2] = s.dev;
  }
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
  verify_final_kernel<<<1, kThreads, 0, s>>>(
      reinterpret_cast<const Stats*>(partials), blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int battery_threads_per_block() { return kThreads; }

int battery_stream_increment(float* x, size_t n, int device, int blocks,
                             void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const size_t head = head_elems(x, n);
  const size_t nvec = (n - head) / 4;
  stream_increment_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, n, head,
                                                                 nvec);
  return static_cast<int>(cudaGetLastError());
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
