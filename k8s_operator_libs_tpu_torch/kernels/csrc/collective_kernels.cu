// Hand-written Hopper kernel of the host's collectives.
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, bound with ctypes in k8s_operator_libs_tpu_torch/kernels).
// The launch entry point launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// K4 peer_reduce: on the launching device,
//     dst[0:len] = (src_0[off:off+len] + ... + src_{k-1}[off:off+len])
//                  / divisor
//   in fp32, summed in index order 0..k-1 and divided with a correctly
//   rounded IEEE division (__fdiv_rn; the library is never built with
//   --use_fast_math), so the plain version in kernels/collectives.py is
//   bit-identical on any input, NaN included.  Each source may lie on any
//   device of the host: under unified addressing, with peer access
//   enabled (collective_peer_enable), a load from another card's buffer
//   goes over NVLink.  k is at most kMaxSources (8, the cards of an HGX
//   board); the source pointers travel by value in a fixed-size
//   parameter struct.
//   Replaces the XLA collectives of the JAX package's health battery:
//   the psum of ici_allreduce_probe (k8s_operator_libs_tpu/health/
//   probes.py:617-618), the +1 ppermute of ici_ring_probe (701-702) and
//   the chained psum rounds and ppermute ring of the fused battery
//   (health/fused.py:212-220).  kernels/collectives.py builds the
//   all-reduce (a reduce-scatter, one launch at k = n per member, then an
//   all-gather, launches at k = 1) and the ring shift (one launch at
//   k = 1 per member) from it.
//   Bound: memory (device memory, or the NVLink that carries a peer's
//   bytes).  A launch reads k * len * 4 bytes and writes len * 4, against
//   k - 1 adds and one division per element.
//   Design: a grid-stride loop over 16-byte float4 chunks, one template
//   instance per k so the k loads of a chunk are issued together and
//   summed in registers; size_t index math.  When every (src_s + off)
//   and dst share one alignment modulo 16 bytes, a scalar head brings
//   them to a 16-byte boundary and a scalar tail finishes the length;
//   otherwise every element takes the scalar path.  Loads are plain
//   global loads (no read-only cache hint), which are valid on a peer's
//   memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
// The cap on k; kernels/collectives.py holds the same number
// (MAX_SOURCES) and a test compares the two.
constexpr int kMaxSources = 8;
// Blocks per SM for the grid-stride loop: 8 x 256 threads fill an SM.
constexpr int kBlocksPerSM = 8;

struct Sources {
  const float* p[kMaxSources];
};

template <int K>
__device__ __forceinline__ float sum_at(const Sources& src, size_t i) {
  float v[K];
#pragma unroll
  for (int s = 0; s < K; ++s) v[s] = src.p[s][i];
  float acc = v[0];
#pragma unroll
  for (int s = 1; s < K; ++s) acc = __fadd_rn(acc, v[s]);
  return acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    peer_reduce_kernel(Sources src, float* dst, size_t len, size_t head,
                       size_t nvec, float divisor) {
  const size_t tid = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  if (tid < head) dst[tid] = __fdiv_rn(sum_at<K>(src, tid), divisor);
  float4* body = reinterpret_cast<float4*>(dst + head);
  for (size_t i = tid; i < nvec; i += stride) {
    float4 v[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      v[s] = reinterpret_cast<const float4*>(src.p[s] + head)[i];
    }
    float4 acc = v[0];
#pragma unroll
    for (int s = 1; s < K; ++s) {
      acc.x = __fadd_rn(acc.x, v[s].x);
      acc.y = __fadd_rn(acc.y, v[s].y);
      acc.z = __fadd_rn(acc.z, v[s].z);
      acc.w = __fadd_rn(acc.w, v[s].w);
    }
    acc.x = __fdiv_rn(acc.x, divisor);
    acc.y = __fdiv_rn(acc.y, divisor);
    acc.z = __fdiv_rn(acc.z, divisor);
    acc.w = __fdiv_rn(acc.w, divisor);
    body[i] = acc;
  }
  for (size_t i = head + 4 * nvec + tid; i < len; i += stride) {
    dst[i] = __fdiv_rn(sum_at<K>(src, i), divisor);
  }
}

template <int K>
cudaError_t launch(const Sources& src, float* dst, size_t len, size_t head,
                   size_t nvec, float divisor, int blocks, cudaStream_t s) {
  peer_reduce_kernel<K>
      <<<blocks, kThreads, 0, s>>>(src, dst, len, head, nvec, divisor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lets `device` read `peer`'s memory.  0 on success, including when the
// access was already on (PyTorch may have enabled the pair for its own
// copies): that case leaves cudaErrorPeerAccessAlreadyEnabled in the
// error state, which is read off here so the next launch check does not
// see it.  -1 when the pair has no peer access; the same device is a
// no-op.
int collective_peer_enable(int device, int peer) {
  if (device == peer) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -1;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(err);
}

int collective_peer_reduce(const void* const* srcs, int k, size_t off,
                           size_t len, float* dst, float divisor, int device,
                           void* stream) {
  if (k < 1 || k > kMaxSources || len == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sources src = {};
  // Every pointer's distance past a 16-byte boundary: one shared value
  // lets a scalar head align them all for the float4 body.
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) & 15;
  bool aligned = true;
  for (int s = 0; s < k; ++s) {
    src.p[s] = static_cast<const float*>(srcs[s]) + off;
    aligned = aligned && (reinterpret_cast<uintptr_t>(src.p[s]) & 15) == mis;
  }
  // Without a shared alignment, head and nvec stay 0 and the kernel's
  // grid-stride tail loop covers every element.
  size_t head = 0;
  size_t nvec = 0;
  if (aligned) {
    head = ((16 - mis) & 15) / sizeof(float);
    if (head > len) head = len;
    nvec = (len - head) / 4;
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  // The grid is sized here, not by the Python wrapper as K1's is: an
  // all-reduce round makes 64 launches from the host, and the host's
  // time per launch bounds the round.
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t items = nvec > len - 4 * nvec ? nvec : len - 4 * nvec;
  size_t want = (items + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSM;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  const int blocks = static_cast<int>(want);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: err = launch<1>(src, dst, len, head, nvec, divisor, blocks, s); break;
    case 2: err = launch<2>(src, dst, len, head, nvec, divisor, blocks, s); break;
    case 3: err = launch<3>(src, dst, len, head, nvec, divisor, blocks, s); break;
    case 4: err = launch<4>(src, dst, len, head, nvec, divisor, blocks, s); break;
    case 5: err = launch<5>(src, dst, len, head, nvec, divisor, blocks, s); break;
    case 6: err = launch<6>(src, dst, len, head, nvec, divisor, blocks, s); break;
    case 7: err = launch<7>(src, dst, len, head, nvec, divisor, blocks, s); break;
    default: err = launch<8>(src, dst, len, head, nvec, divisor, blocks, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
