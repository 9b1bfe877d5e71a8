// Hand-written Hopper kernels of the host's collectives, and the round
// plans that enqueue a whole collective with one host call.
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, bound with ctypes in k8s_operator_libs_tpu_torch/kernels).
// The launch entry points launch on the caller's stream, allocate no
// device memory, do not synchronise, and return a CUDA error code (0 on
// success) so the Python wrapper can raise on a refused launch.
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
//   Replaces the XLA collectives of the JAX package (PERF.md's D1, D4,
//   D5, D8): the psum of ici_allreduce_probe (k8s_operator_libs_tpu/
//   health/probes.py:617-618), the +1 ppermute of ici_ring_probe
//   (701-702), the chained psum rounds and ppermute ring of the fused
//   battery (health/fused.py:212-220) and the psums of the sharded canary
//   step (workloads/canary.py:127-267).  The all-reduce plan runs it as
//   its reduce-scatter, one node at k = n a member; the ring-shift plan
//   as one node at k = 1 a member.
//   Bound: memory.  A launch reads k * len * 4 bytes (device memory, the
//   L2 when a round's inputs were just written, or the NVLink that
//   carries a peer's bytes) and writes len * 4, against k - 1 adds and
//   one division an element.  At the probe's reduce-scatter node (k 8 x
//   2^17, 4.5 MiB) and the ring shift (k 1, one element on the main
//   path) a launch is a single round trip to memory: its time is the
//   ramp of the grid plus one latency.  At the canary's tp all-reduce
//   nodes (k 4 x 2^21, k 2 x 2^22), its dp round's (k 2 x half a
//   member's gradients) and the large rows (k 8 x 2^22) it streams device
//   memory (PERF.md gives its share of the bound at each shape).
//   Design: a grid-stride loop over 16-byte float4 chunks, one template
//   instance per k, so a thread issues the k loads of a chunk together
//   and sums them in registers in order 0..k-1; blocks of 256 threads,
//   enough for one chunk a thread, at most kBlocksPerSM an SM; size_t
//   index math.  The grid comes from k, len and the alignment class
//   alone, never from pointer values, so a repointed graph node keeps a
//   valid grid.  When every (src_s + off) and dst share one alignment
//   modulo 16 bytes, a scalar head brings them to a 16-byte boundary and
//   a scalar tail finishes the length; otherwise every element takes the
//   scalar path.  Loads are global loads without the read-only path,
//   valid on a peer's memory; stores keep the default policy (the
//   all-gather node reads the reduce-scatter's output next).  No cache
//   hint: each variant below was timed against this body at every shape
//   of the main path, on the card and in turns, and none was faster at
//   all of them (PERF.md has the figures):
//   - loads under an L2 evict-first policy, or with no L1 allocation:
//     faster at some large shapes, slower with the sources in the L2 (up
//     to 1.5x at k 8 x 2^20) and at the dp node;
//   - four 16-byte loads a thread before the first add at k < 4,
//     unrolled over vectors: slower at the ring shift's k 1 x 2^17;
//   - a block on every SM at the small shapes, warps numbered across the
//     grid: faster at k 4 x 2^21 with the L2 warm, slower at every k 8
//     shape;
//   - bulk copies into a ring of shared-memory stages (one producer
//     thread, cp.async.bulk on an mbarrier, eight consumer warps): slower
//     or no faster at every shape.
//
// K5 peer_gather: on the launching device, for each source s < k and
//   each row r < rows,
//     dst[off_s + r * pitch : + len_s] = src_s[r * len_s : + len_s]   (bytes)
//   with up to kMaxSources sources, each on any device of the host (peer
//   access as K4), their destination ranges disjoint.  With rows = 1 a
//   piece lands whole at off_s; with rows > 1 each contiguous piece is a
//   matrix of rows x len_s bytes whose rows land pitch bytes apart, which
//   is how an all-gather along an inner dimension interleaves the
//   members' pieces into the gathered tensor in one pass.  A byte copy,
//   so it serves every dtype with one code path and is exact by
//   construction.
//   Replaces XLA's all-gathers: the all-gather phase of the psum rounds
//   above (one launch per member copies every other member's reduced
//   chunk) and the all-gathers of the sharded canary step
//   (k8s_operator_libs_tpu/workloads/canary.py:211-267, the embedding's
//   and the logits' gathers XLA inserts from P(None, "tp"), along the last
//   dimension).
//   Bound: memory (or the NVLink that carries a peer's bytes); it reads
//   and writes rows * sum(len_s) bytes and computes nothing.
//   Design: the grid is split over the pieces.  The host gives piece s a
//   run of blocks in proportion to its bytes (first[s] .. first[s+1],
//   from the plan's shape alone: lengths and rows, never pointers, so a
//   graph node keeps a valid grid when it is repointed); a block finds
//   its piece with k - 1 compares, and no thread walks every piece.
//   Within a piece, the piece's threads walk the rows x vectors of its
//   copy as one flat range: each thread divides its first index into
//   (row, column) once (none for one row), and steps by the piece's
//   thread count with an add and a compare, so no division happens per
//   vector.  Each thread issues kGatherInFlight loads before their
//   stores; the stores carry the evict-first hint (st.global.cs), so the
//   output does not push the pieces out of the L2.  A piece takes the
//   vector path when it and its destination sit at one offset past a
//   16-byte boundary and, with several rows, len_s and pitch are
//   multiples of 16 (so every row shares that offset); the bytes before
//   the boundary and after the last vector of each row are copied as
//   bytes, in the same way.  Otherwise the piece is copied byte by byte.
//   One row and several rows take two instances of the kernel (chosen
//   by the shape), so a one-row copy keeps the registers of its simpler
//   loop and 8 blocks an SM.  Loads are plain global loads (no read-only
//   cache hint), which are valid on a peer's memory.
//
// The round plan (collective_plan_*): one shape of collective (its
// members' devices and ranges) as a CUDA graph of K4 and K5 nodes, so a
// round costs the host one cudaGraphLaunch and the events that order it
// against the members' streams, not 2n launches and three barriers.
//   all-reduce: node RS_j (K4 at k = n, member j's chunk) on device j for
//     every non-empty chunk, then node AG_j (K5 over every other member's
//     chunk) on device j, each AG after every RS (graph edges, no host
//     event; an empty join node between the phases measured slower, both
//     in the launch and on the device).  all-gather: node AG_j alone (K5
//     over every member's piece, rows interleaved as above).  ring shift:
//     node RS_j alone, K4 at k = 1 on device j, reading member j-1's
//     whole shard (mod n) into member j's output; the n nodes are
//     independent.
//   Launch: the first member's stream waits for every other member's
//   stream (their inputs' producers), the graph runs on the first
//   member's stream, and every other member's stream waits for it: after
//   the call, later work on any member's stream follows every read of
//   every input and output.  Members that share a stream need no event.
//   Pointers: a plan keeps two instantiated graphs, each with the
//   pointers and divisor its nodes hold.  A round that matches one
//   replays it; otherwise the graph not used last is given the new ones
//   (cudaGraphExecKernelNodeSetParams, which affects later launches
//   only).  Two, because repeated rounds alternate between two sets of
//   buffers (a probe's outputs, a chained round's input and output: the
//   caching allocator hands back the block the round before last freed)
//   and repointing 16 nodes costs the host about as much again as the
//   Python around a round.  Outputs are the caller's fresh tensors, so a
//   replay never writes a buffer that an earlier round handed out.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <new>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
// The cap on k and on a round's members; kernels/collectives.py holds
// the same number (MAX_SOURCES) and a test compares the two.
constexpr int kMaxSources = 8;
// Blocks per SM for the grid-stride loops: 8 x 256 threads fill an SM.
constexpr int kBlocksPerSM = 8;
// 16-byte vectors (or bytes) each K5 thread loads before storing them.
constexpr int kGatherInFlight = 4;
// Instantiated graphs a round plan keeps (see the plan's notes above).
constexpr int kGraphs = 2;
// Devices whose SM count the library caches.
constexpr int kMaxDevices = 64;

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

struct Pieces {
  const unsigned char* src[kMaxSources];
  size_t off[kMaxSources];  // destination offset of the first row, bytes
  size_t len[kMaxSources];  // bytes a row
  // Piece s runs on blocks [first[s], first[s + 1]).
  int first[kMaxSources + 1];
};

// Copies rows x cols units of T, row r from src + r * spitch to dst + r *
// dpitch (bytes), with thread lt of nt; kGatherInFlight loads a thread
// are issued before their stores.  kRows false: one row.
template <typename T, bool kRows>
__device__ __forceinline__ void copy_rows(const unsigned char* src,
                                          size_t spitch, unsigned char* dst,
                                          size_t dpitch, size_t rows,
                                          size_t cols, size_t lt, size_t nt) {
  if (cols == 0) return;
  if (!kRows) {  // one row: no division at all
    for (size_t c = lt; c < cols; c += kGatherInFlight * nt) {
      T v[kGatherInFlight];
#pragma unroll
      for (int u = 0; u < kGatherInFlight; ++u) {
        if (c + u * nt < cols) {
          v[u] = reinterpret_cast<const T*>(src)[c + u * nt];
        }
      }
#pragma unroll
      for (int u = 0; u < kGatherInFlight; ++u) {
        if (c + u * nt < cols) {
          __stcs(reinterpret_cast<T*>(dst) + c + u * nt, v[u]);
        }
      }
    }
    return;
  }
  // The thread's (row, column), and the step of nt units as (dr, dc):
  // divided once, in 32 bits where the numbers fit.
  size_t r, c, dr, dc;
  if (cols <= UINT32_MAX && nt <= UINT32_MAX) {
    const uint32_t l32 = static_cast<uint32_t>(lt);
    const uint32_t n32 = static_cast<uint32_t>(nt);
    const uint32_t c32 = static_cast<uint32_t>(cols);
    r = l32 / c32;
    c = l32 - static_cast<uint32_t>(r) * c32;
    dr = n32 / c32;
    dc = n32 - static_cast<uint32_t>(dr) * c32;
  } else {
    r = lt / cols;
    c = lt - r * cols;
    dr = nt / cols;
    dc = nt - dr * cols;
  }
  while (r < rows) {
    T v[kGatherInFlight];
    size_t at_src[kGatherInFlight];
    size_t at_dst[kGatherInFlight];
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < kGatherInFlight; ++u) {
      if (r < rows) {
        live |= 1u << u;
        at_src[u] = r * spitch + c * sizeof(T);
        at_dst[u] = r * dpitch + c * sizeof(T);
        v[u] = *reinterpret_cast<const T*>(src + at_src[u]);
      }
      c += dc;
      r += dr;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherInFlight; ++u) {
      if (live >> u & 1u) __stcs(reinterpret_cast<T*>(dst + at_dst[u]), v[u]);
    }
  }
}

// kRows: rows > 1.  One row takes an instance of its own, whose fewer
// registers keep 8 blocks on an SM.
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    peer_gather_kernel(Pieces p, int k, size_t rows, size_t pitch,
                       unsigned char* dst) {
  int s = 0;
#pragma unroll
  for (int t = 1; t < kMaxSources; ++t) {
    s += t < k && static_cast<int>(blockIdx.x) >= p.first[t];
  }
  const size_t lt =
      static_cast<size_t>(blockIdx.x - p.first[s]) * kThreads + threadIdx.x;
  const size_t nt =
      static_cast<size_t>(p.first[s + 1] - p.first[s]) * kThreads;
  const unsigned char* src = p.src[s];
  unsigned char* out = dst + p.off[s];
  const size_t len = p.len[s];
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != mis ||
      (kRows && (len % 16 != 0 || pitch % 16 != 0))) {
    copy_rows<unsigned char, kRows>(src, len, out, pitch, rows, len, lt, nt);
    return;
  }
  size_t head = (16 - mis) & 15;
  if (head > len) head = len;
  const size_t nvec = (len - head) / 16;
  const size_t body = head + 16 * nvec;
  copy_rows<uint4, kRows>(src + head, len, out + head, pitch, rows, nvec,
                          lt, nt);
  copy_rows<unsigned char, kRows>(src, len, out, pitch, rows, head, lt, nt);
  copy_rows<unsigned char, kRows>(src + body, len, out + body, pitch, rows,
                                  len - body, lt, nt);
}

// The grid of a launch: enough blocks for `items` threads, at most
// kBlocksPerSM a multiprocessor, at least one.
int grid_for(size_t items, int sms) {
  size_t want = (items + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSM;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  return static_cast<int>(want);
}

// Device `device`'s SM count, asked once.
int device_sms(int device, cudaError_t* err) {
  static std::atomic<int> cached[kMaxDevices];
  *err = cudaSuccess;
  if (device < 0 || device >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  int sms = cached[device].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  // Two first callers both ask; they store the same number.
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess) cached[device].store(sms, std::memory_order_relaxed);
  return sms;
}

// One K4 launch's arguments, as a kernel launch or a graph node takes
// them.
struct ReduceArgs {
  Sources src;
  float* dst;
  size_t len;
  size_t head;
  size_t nvec;
  float divisor;
  int k;
  int blocks;
  void* params[6];

  void* func() const {
    switch (k) {
      case 1: return reinterpret_cast<void*>(&peer_reduce_kernel<1>);
      case 2: return reinterpret_cast<void*>(&peer_reduce_kernel<2>);
      case 3: return reinterpret_cast<void*>(&peer_reduce_kernel<3>);
      case 4: return reinterpret_cast<void*>(&peer_reduce_kernel<4>);
      case 5: return reinterpret_cast<void*>(&peer_reduce_kernel<5>);
      case 6: return reinterpret_cast<void*>(&peer_reduce_kernel<6>);
      case 7: return reinterpret_cast<void*>(&peer_reduce_kernel<7>);
      default: return reinterpret_cast<void*>(&peer_reduce_kernel<8>);
    }
  }

  cudaKernelNodeParams node() {
    params[0] = &src;
    params[1] = &dst;
    params[2] = &len;
    params[3] = &head;
    params[4] = &nvec;
    params[5] = &divisor;
    cudaKernelNodeParams np = {};
    np.func = func();
    np.gridDim = dim3(blocks);
    np.blockDim = dim3(kThreads);
    np.kernelParams = params;
    return np;
  }
};

// srcs[s] + off for s < k, summed into dst[0:len] / divisor.
ReduceArgs reduce_args(const void* const* srcs, int k, size_t off,
                       size_t len, float* dst, float divisor, int sms) {
  ReduceArgs a = {};
  a.k = k;
  a.dst = dst;
  a.len = len;
  a.divisor = divisor;
  // Every pointer's distance past a 16-byte boundary: one shared value
  // lets a scalar head align them all for the float4 body.
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) & 15;
  bool aligned = true;
  for (int s = 0; s < k; ++s) {
    a.src.p[s] = static_cast<const float*>(srcs[s]) + off;
    aligned = aligned && (reinterpret_cast<uintptr_t>(a.src.p[s]) & 15) == mis;
  }
  // Without a shared alignment, head and nvec stay 0 and the kernel's
  // grid-stride tail loop covers every element.
  if (aligned) {
    a.head = ((16 - mis) & 15) / sizeof(float);
    if (a.head > len) a.head = len;
    a.nvec = (len - a.head) / 4;
  }
  const size_t rest = len - 4 * a.nvec;
  a.blocks = grid_for(a.nvec > rest ? a.nvec : rest, sms);
  return a;
}

struct GatherArgs {
  Pieces p;
  int k;
  size_t rows;
  size_t pitch;
  unsigned char* dst;
  int blocks;
  void* params[5];

  cudaKernelNodeParams node() {
    params[0] = &p;
    params[1] = &k;
    params[2] = &rows;
    params[3] = &pitch;
    params[4] = &dst;
    cudaKernelNodeParams np = {};
    np.func = rows > 1 ? reinterpret_cast<void*>(&peer_gather_kernel<true>)
                       : reinterpret_cast<void*>(&peer_gather_kernel<false>);
    np.gridDim = dim3(blocks);
    np.blockDim = dim3(kThreads);
    np.kernelParams = params;
    return np;
  }
};

// The launch of pieces s < k: srcs[s] lands at byte offs[s] of dst, in
// rows of lens[s] bytes pitch apart.  The grid depends on k, lens and
// rows alone: a block for every kThreads 16-byte vectors of a piece,
// scaled down to kBlocksPerSM a multiprocessor in proportion.
GatherArgs gather_args(const void* const* srcs, const size_t* offs,
                       const size_t* lens, int k, size_t rows, size_t pitch,
                       void* dst, int sms) {
  GatherArgs a = {};
  a.k = k;
  a.rows = rows;
  a.pitch = pitch;
  a.dst = static_cast<unsigned char*>(dst);
  size_t want[kMaxSources];
  size_t total = 0;
  for (int s = 0; s < k; ++s) {
    a.p.src[s] = static_cast<const unsigned char*>(srcs[s]);
    a.p.off[s] = offs[s];
    a.p.len[s] = lens[s];
    want[s] = (rows * ((lens[s] + 15) / 16) + kThreads - 1) / kThreads;
    if (want[s] < 1) want[s] = 1;
    total += want[s];
  }
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSM;
  for (int s = 0; s < k; ++s) {
    size_t b = want[s];
    if (total > cap) b = b * cap / total;
    if (b < 1) b = 1;
    a.p.first[s + 1] = a.p.first[s] + static_cast<int>(b);
  }
  a.blocks = a.p.first[k];
  return a;
}

// -- the round plan ---------------------------------------------------------

// ALL_REDUCE, ALL_GATHER and RING_SHIFT in kernels/collectives.py.
enum Kind { kAllReduce = 0, kAllGather = 1, kRingShift = 2 };

// One instantiated graph of a plan, and the pointers and divisor its
// nodes hold (when `current`).
struct Graph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t rs[kMaxSources] = {};
  cudaGraphNode_t ag[kMaxSources] = {};
  uint64_t in[kMaxSources] = {};
  uint64_t out[kMaxSources] = {};
  float divisor = 0.0f;
  bool current = false;
};

struct Plan {
  int kind;
  int n;
  int devices[kMaxSources];
  int sms[kMaxSources];
  // all-reduce: member i's chunk [begin, end) in elements; all-gather:
  // member i's piece lands at bytes [begin, end) of each of `rows` rows
  // of every output, the rows `pitch` bytes apart; ring shift: member
  // i's whole shard, [0, elements).
  size_t begin[kMaxSources];
  size_t end[kMaxSources];
  size_t rows;
  size_t pitch;
  cudaEvent_t ready[kMaxSources];  // recorded on member i's stream
  Graph graphs[kGraphs];
  int last = 0;  // the graph the last round ran
  std::mutex mu;
};

// Member j's nodes for the pointers of one round.  The all-reduce's
// node reduces chunk j of every member's input into member j's output;
// the ring shift's copies member j-1's input (mod n) into it.
ReduceArgs rs_args(const Plan& p, const uint64_t* in, const uint64_t* out,
                   float divisor, int j) {
  const size_t len = p.end[j] - p.begin[j];
  float* dst = reinterpret_cast<float*>(out[j]) + p.begin[j];
  if (p.kind == kRingShift) {
    const void* src = reinterpret_cast<const void*>(in[(j + p.n - 1) % p.n]);
    return reduce_args(&src, 1, 0, len, dst, 1.0f, p.sms[j]);
  }
  const void* srcs[kMaxSources];
  for (int i = 0; i < p.n; ++i) srcs[i] = reinterpret_cast<const void*>(in[i]);
  return reduce_args(srcs, p.n, p.begin[j], len, dst, divisor, p.sms[j]);
}

GatherArgs ag_args(const Plan& p, const uint64_t* in, const uint64_t* out,
                   int j) {
  const void* srcs[kMaxSources];
  size_t offs[kMaxSources];
  size_t lens[kMaxSources];
  int k = 0;
  for (int i = 0; i < p.n; ++i) {
    if (p.end[i] == p.begin[i]) continue;
    if (p.kind == kAllReduce) {
      if (i == j) continue;  // member j reduced its own chunk in place
      srcs[k] = reinterpret_cast<const float*>(out[i]) + p.begin[i];
      offs[k] = p.begin[i] * sizeof(float);
      lens[k] = (p.end[i] - p.begin[i]) * sizeof(float);
    } else {
      srcs[k] = reinterpret_cast<const void*>(in[i]);
      offs[k] = p.begin[i];
      lens[k] = p.end[i] - p.begin[i];
    }
    ++k;
  }
  return gather_args(srcs, offs, lens, k, p.rows, p.pitch,
                     reinterpret_cast<void*>(out[j]), p.sms[j]);
}

bool has_rs(const Plan& p, int j) {
  return p.kind != kAllGather && p.end[j] > p.begin[j];
}

bool has_ag(const Plan& p, int j) {
  if (p.kind == kRingShift) return false;
  // An all-reduce member with every other chunk empty copies nothing.
  int k = 0;
  for (int i = 0; i < p.n; ++i) {
    if (p.end[i] > p.begin[i] && !(p.kind == kAllReduce && i == j)) ++k;
  }
  return k > 0;
}

cudaError_t add_nodes(const Plan& p, Graph& g, const uint64_t* in,
                      const uint64_t* out, float divisor) {
  cudaError_t err = cudaGraphCreate(&g.graph, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t reduced[kMaxSources];
  int nreduced = 0;
  for (int j = 0; j < p.n; ++j) {
    if (!has_rs(p, j)) continue;
    const DeviceGuard guard(p.devices[j]);  // the node runs on device j
    if (guard.err != cudaSuccess) return guard.err;
    ReduceArgs a = rs_args(p, in, out, divisor, j);
    cudaKernelNodeParams np = a.node();
    err = cudaGraphAddKernelNode(&g.rs[j], g.graph, nullptr, 0, &np);
    if (err != cudaSuccess) return err;
    reduced[nreduced++] = g.rs[j];
  }
  for (int j = 0; j < p.n; ++j) {
    if (!has_ag(p, j)) continue;
    const DeviceGuard guard(p.devices[j]);
    if (guard.err != cudaSuccess) return guard.err;
    GatherArgs a = ag_args(p, in, out, j);
    cudaKernelNodeParams np = a.node();
    err = cudaGraphAddKernelNode(&g.ag[j], g.graph, reduced, nreduced, &np);
    if (err != cudaSuccess) return err;
  }
  const DeviceGuard guard(p.devices[0]);
  if (guard.err != cudaSuccess) return guard.err;
  return cudaGraphInstantiate(&g.exec, g.graph, 0);
}

cudaError_t build_graph(const Plan& p, Graph& g, const uint64_t* in,
                        const uint64_t* out, float divisor) {
  const cudaError_t err = add_nodes(p, g, in, out, divisor);
  if (err != cudaSuccess) {
    if (g.graph) cudaGraphDestroy(g.graph);
    g.graph = nullptr;
    g.exec = nullptr;
  }
  return err;
}

cudaError_t repoint_graph(const Plan& p, Graph& g, const uint64_t* in,
                          const uint64_t* out, float divisor) {
  for (int j = 0; j < p.n; ++j) {
    // A node's new parameters are taken in the current device's context:
    // set from another device, they would move the node (invalid value).
    const DeviceGuard guard(p.devices[j]);
    if (guard.err != cudaSuccess) return guard.err;
    if (has_rs(p, j)) {
      ReduceArgs a = rs_args(p, in, out, divisor, j);
      cudaKernelNodeParams np = a.node();
      cudaError_t err = cudaGraphExecKernelNodeSetParams(g.exec, g.rs[j], &np);
      if (err != cudaSuccess) return err;
    }
    if (has_ag(p, j)) {
      GatherArgs a = ag_args(p, in, out, j);
      cudaKernelNodeParams np = a.node();
      cudaError_t err = cudaGraphExecKernelNodeSetParams(g.exec, g.ag[j], &np);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

bool holds(const Plan& p, const Graph& g, const uint64_t* in,
           const uint64_t* out, float divisor) {
  if (!g.current || g.divisor != divisor) return false;
  for (int i = 0; i < p.n; ++i) {
    if (g.in[i] != in[i] || g.out[i] != out[i]) return false;
  }
  return true;
}

// The graph for this round's pointers: one that holds them, or the one
// not used last, made or repointed.
cudaError_t graph_for(Plan& p, const uint64_t* in, const uint64_t* out,
                      float divisor, cudaGraphExec_t* exec) {
  int pick = -1;
  for (int k = 0; k < kGraphs && pick < 0; ++k) {
    if (holds(p, p.graphs[k], in, out, divisor)) pick = k;
  }
  if (pick < 0) {
    pick = (p.last + 1) % kGraphs;
    Graph& g = p.graphs[pick];
    // A failed repoint leaves the nodes' pointers unknown: a later round
    // repoints them all again.
    g.current = false;
    const cudaError_t err = g.exec ? repoint_graph(p, g, in, out, divisor)
                                   : build_graph(p, g, in, out, divisor);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < p.n; ++i) {
      g.in[i] = in[i];
      g.out[i] = out[i];
    }
    g.divisor = divisor;
    g.current = true;
  }
  p.last = pick;
  *exec = p.graphs[pick].exec;
  return cudaSuccess;
}

void destroy_plan(Plan* p) {
  for (Graph& g : p->graphs) {
    if (g.exec) cudaGraphExecDestroy(g.exec);
    if (g.graph) cudaGraphDestroy(g.graph);
  }
  for (int i = 0; i < p->n; ++i) {
    if (p->ready[i]) cudaEventDestroy(p->ready[i]);
  }
  delete p;
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

// srcs holds the k source pointers as uint64.
int collective_peer_reduce(const uint64_t* srcs, int k, size_t off,
                           size_t len, float* dst, float divisor, int device,
                           void* stream) {
  if (k < 1 || k > kMaxSources || len == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const int sms = device_sms(device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const void* ptrs[kMaxSources];
  for (int s = 0; s < k; ++s) ptrs[s] = reinterpret_cast<const void*>(srcs[s]);
  ReduceArgs a = reduce_args(ptrs, k, off, len, dst, divisor, sms);
  cudaKernelNodeParams np = a.node();
  err = cudaLaunchKernel(np.func, np.gridDim, np.blockDim, np.kernelParams,
                         0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// ptrs holds src[k], off[k] and len[k] as uint64 (pointers, then byte
// offsets into dst, then bytes a row).
int collective_peer_gather(const uint64_t* ptrs, int k, size_t rows,
                           size_t pitch, void* dst, int device,
                           void* stream) {
  if (k < 1 || k > kMaxSources || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const int sms = device_sms(device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const void* srcs[kMaxSources];
  size_t offs[kMaxSources];
  size_t lens[kMaxSources];
  for (int s = 0; s < k; ++s) {
    srcs[s] = reinterpret_cast<const void*>(ptrs[s]);
    offs[s] = ptrs[k + s];
    lens[s] = ptrs[2 * k + s];
  }
  GatherArgs a = gather_args(srcs, offs, lens, k, rows, pitch, dst, sms);
  cudaKernelNodeParams np = a.node();
  err = cudaLaunchKernel(np.func, np.gridDim, np.blockDim, np.kernelParams,
                         0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// A round plan for n members on devices[]: kind 0 all-reduce (member i's
// chunk is elements [begin[i], end[i]) of an fp32 shard; rows 1), kind 1
// all-gather (member i's piece is `rows` rows that land at bytes
// [begin[i], end[i]) of each row of every output, the rows `pitch` bytes
// apart), kind 2 ring shift (member i's fp32 shard is elements [begin[i],
// end[i]) = [0, elements); rows 1).  Writes the handle to *plan;
// returns a CUDA error code.
int collective_plan_create(int kind, int n, const int* devices,
                           const size_t* begin, const size_t* end,
                           size_t rows, size_t pitch, void** plan) {
  if (n < 1 || n > kMaxSources || rows < 1 || kind < kAllReduce ||
      kind > kRingShift || (kind != kAllGather && rows != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan* p = new (std::nothrow) Plan();
  if (!p) return static_cast<int>(cudaErrorMemoryAllocation);
  p->kind = kind;
  p->n = n;
  p->rows = rows;
  p->pitch = pitch;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    if (end[i] < begin[i]) err = cudaErrorInvalidValue;
    p->devices[i] = devices[i];
    p->begin[i] = begin[i];
    p->end[i] = end[i];
    if (err == cudaSuccess) p->sms[i] = device_sms(devices[i], &err);
    if (err == cudaSuccess) {
      const DeviceGuard guard(devices[i]);
      err = guard.err;
      if (err == cudaSuccess) {
        err = cudaEventCreateWithFlags(&p->ready[i], cudaEventDisableTiming);
      }
    }
  }
  if (err != cudaSuccess) {
    destroy_plan(p);
    return static_cast<int>(err);
  }
  *plan = p;
  return 0;
}

// One round: ptrs holds in[n], out[n] and streams[n]; member i reads
// in[i] and writes out[i] (device pointers on devices[i]) and its stream
// is streams[i].  Returns a CUDA error code.
int collective_plan_launch(void* plan, const uint64_t* ptrs, float divisor) {
  Plan& p = *static_cast<Plan*>(plan);
  const uint64_t* in = ptrs;
  const uint64_t* out = ptrs + p.n;
  const uint64_t* streams = ptrs + 2 * p.n;
  std::lock_guard<std::mutex> lock(p.mu);
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = graph_for(p, in, out, divisor, &exec);
  if (err != cudaSuccess) {
    cudaGetLastError();  // as below: reported once, here
    return static_cast<int>(err);
  }
  cudaStream_t hub = reinterpret_cast<cudaStream_t>(streams[0]);
  // A stream shared with an earlier member is ordered already.
  auto seen = [&](int i) {
    for (int h = 0; h < i; ++h) {
      if (streams[h] == streams[i]) return true;
    }
    return false;
  };
  int current = -1;
  auto on = [&](int device) {
    if (device == current) return cudaSuccess;
    current = device;
    return cudaSetDevice(device);
  };
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  current = prev;
  for (int i = 1; i < p.n && err == cudaSuccess; ++i) {
    if (seen(i)) continue;
    cudaStream_t si = reinterpret_cast<cudaStream_t>(streams[i]);
    err = on(p.devices[i]);
    if (err == cudaSuccess) err = cudaEventRecord(p.ready[i], si);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(hub, p.ready[i], 0);
  }
  if (err == cudaSuccess) err = on(p.devices[0]);
  if (err == cudaSuccess) err = cudaGraphLaunch(exec, hub);
  bool recorded = false;
  for (int i = 1; i < p.n && err == cudaSuccess; ++i) {
    if (seen(i)) continue;
    if (!recorded) {
      err = on(p.devices[0]);
      if (err == cudaSuccess) err = cudaEventRecord(p.ready[0], hub);
      recorded = true;
    }
    if (err == cudaSuccess) err = on(p.devices[i]);
    if (err == cudaSuccess) {
      err = cudaStreamWaitEvent(reinterpret_cast<cudaStream_t>(streams[i]),
                                p.ready[0], 0);
    }
  }
  if (current != prev) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  // The failed call's error is returned here; read it off the thread's
  // error state so that the next launch's check does not report it again.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The K4 and K5 nodes of the plan's graph: rs[j] and ag[j] are 1 where
// member j has that node (rs: a reduce-scatter or ring-shift node).
void collective_plan_nodes(void* plan, int* rs, int* ag) {
  const Plan& p = *static_cast<Plan*>(plan);
  for (int j = 0; j < p.n; ++j) {
    rs[j] = has_rs(p, j);
    ag[j] = has_ag(p, j);
  }
}

}  // extern "C"
