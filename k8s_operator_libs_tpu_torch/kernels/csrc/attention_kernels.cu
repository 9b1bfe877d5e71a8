// Hand-written Hopper kernel of ring attention's block step.
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, bound with ctypes in k8s_operator_libs_tpu_torch/kernels).
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
//
// K3 block_attention: one (q block x kv block) attention contribution
//   with unnormalised online-softmax outputs.
//   Replaces _block_attention of
//   k8s_operator_libs_tpu/workloads/ring_attention.py:55-79 (the body of
//   every ring step of ring_attention_sharded, 94-143, and of
//   full_attention_reference, 146-157), and with the second entry point
//   also _merge (82-91), the ring step's update of its accumulator.
//   Inputs q [B, Sq, H, D], k and v [B, Sk, H, D], fp32, contiguous (the
//   JAX layout).  With s = (sum_d bf16(q) bf16(k) in fp32) * scale, s =
//   -1e30 where causal hides key j from query i (q_offset + i <
//   k_offset + j), m = rowmax(s) over the whole kv block, pinned to 0
//   where m <= -5e29, p = exp(s - m):
//     num [B, Sq, H, D] = sum_j bf16(p) bf16(v), accumulated in fp32;
//     m   [B, Sq, H];
//     l   [B, Sq, H]    = sum_j p over the unrounded p.
//   attention_block_merge_f32 folds (num, m, l) into a running
//   accumulator in place, as _merge does: new_m = max(acc_m, m),
//   a = exp(acc_m - new_m), b = exp(m - new_m), acc_num = acc_num a +
//   num b, acc_l = acc_l a + l b, each product and sum rounded on its
//   own (no FMA contraction), so the result is the one torch's _merge
//   gives for the same (num, m, l).
//
//   Bound: device memory at the main path's shapes.  At the canary's
//   attention shape (B 32, H 16, S 512, D 64, causal) the fp32 inputs and
//   outputs are about 270 MB, 0.081 ms at 3.35 TB/s, against about
//   17 GFLOP of visible products, 0.018 ms at 989 TFLOP/s in bf16; at the
//   ring's shards (1, 128, 4, 64) and (1, 512, 16, 64) a launch and the
//   latency of a few dependent tile loads cost more than either.  What
//   holds the kernel above that bound is the instructions of each kv
//   tile: 9 for every expf of p, the rounding of each fp32 tile to bf16,
//   the second q.k of pass 2, and the products themselves.
//
//   Design.  A warp owns 16 query rows.  A block takes 128 rows of one
//   (b, h) with 8 warps where that still gives every SM a block, else 64
//   rows with 4 warps, else (the ring's shards) 32 or 16 rows with 4
//   warps whose row groups split each kv tile's keys between them and
//   combine their maxima, sums and num through shared memory at the end.
//   Scores and products use mma.sync m16n8k16 (bf16 in, fp32 accumulate):
//   q's A fragments go from device memory straight into registers once,
//   K and V fragments come by ldmatrix from bf16 tiles padded by 8
//   elements a row, which puts the 8 rows of every ldmatrix on distinct
//   banks.  The scores of a warp's rows stay in registers: the row max
//   and sum take two quad shuffles, and p is packed to bf16 straight into
//   the A operand of P.V (the m16n8k16 accumulator layout is the A
//   layout).  The ring has two fp32 staging stages filled by cp.async and
//   two bf16 tile buffers: while the warps multiply step s's tiles, the
//   block rounds step s + 1's to bf16 (once, in shared memory) and step
//   s + 2's copies are in flight, with one barrier a step.  At most 128
//   registers a thread and about 100 KB of shared memory keep two blocks
//   on an SM.  Two passes over the kv tiles, as the JAX function: the
//   first forms q.k and each row's max over the whole kv block, the second
//   forms q.k again, p, l and p.v, so p's bf16 rounding sees the same max
//   as the plain version (a one-pass kernel would round p against a
//   running max).  A kv tile that causality hides from every row of the
//   block is skipped (its exact result is m 0, l 0, num 0), a warp skips
//   the keys its rows cannot see, and the ragged Sq, Sk and D edges are
//   zero-filled and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"

namespace {

// Threads an SM holds at least: at most 128 registers a thread, so each
// scheduler has 4 warps to switch between.
constexpr int kThreadsPerSm = 512;
constexpr float kNegInf = -1e30f;  // ring_attention.py NEG_INF
constexpr int kMaxDevices = 64;
// The ring: two fp32 staging stages that cp.async fills, and two bf16
// K and V tile buffers that the products read.
constexpr int kStages = 2;

struct Dims {
  int Sq, Sk, H, D;
  long long q_offset, k_offset;
  int causal;
  float scale;
};

// Where a block's (num, m, l) go: written out (K3), or, with merge set,
// folded into the running accumulator (num, m, l) in place.
struct Out {
  float* num;
  float* m;
  float* l;
  int merge;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled past `bytes`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// torch.maximum: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Queues the cp.async copies of rows [row0, row0 + KEYS) of a
// [rows, H, D] slab (row stride H*D floats) into a dense fp32
// [KEYS][DP] staging tile, zero past the last row and past column D.
// Where the block's threads cover whole rows, each thread keeps one
// column and steps over rows.
template <int DP, int KEYS, int THREADS>
__device__ __forceinline__ void issue_tile(float* dst, const float* src,
                                           int row0, int rows, int D,
                                           size_t row_stride) {
  constexpr int kVecs = DP / 4;
  if constexpr (THREADS % kVecs == 0 && KEYS % (THREADS / kVecs) == 0) {
    constexpr int kRowStep = THREADS / kVecs;
    const int col = (threadIdx.x % kVecs) * 4;
    const int r = threadIdx.x / kVecs;
    const float* p = src + static_cast<size_t>(row0 + r) * row_stride + col;
    const size_t step = kRowStep * row_stride;
    const int left = col < D ? rows - row0 - r : 0;  // rows from r on
#pragma unroll
    for (int it = 0; it < KEYS / kRowStep; ++it) {
      const bool ok = it * kRowStep < left;
      cp_async16(dst + 4 * (threadIdx.x + it * THREADS), ok ? p : src,
                 ok ? 16 : 0);
      p += step;
    }
  } else {
#pragma unroll
    for (int it = 0; it < (KEYS * kVecs + THREADS - 1) / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      if (KEYS * kVecs % THREADS && e >= KEYS * kVecs) break;
      const int gr = row0 + e / kVecs;
      const int col = (e % kVecs) * 4;
      const bool ok = gr < rows && col < D;
      cp_async16(dst + 4 * e, ok ? src + gr * row_stride + col : src,
                 ok ? 16 : 0);
    }
  }
}

// A dense fp32 [KEYS][DP] staging tile rounded to a bf16 tile with row
// stride DP + 8.
template <int DP, int KEYS, int THREADS>
__device__ __forceinline__ void round_tile(__nv_bfloat16* dst,
                                           const float* src) {
  constexpr int kVecs = DP / 4;
  constexpr int kLd = DP + 8;
#pragma unroll
  for (int it = 0; it < (KEYS * kVecs + THREADS - 1) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (KEYS * kVecs % THREADS && e >= KEYS * kVecs) break;
    const float4 x = *reinterpret_cast<const float4*>(src + 4 * e);
    uint2 packed;
    packed.x = pack_bf16(x.x, x.y);
    packed.y = pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(dst + (e / kVecs) * kLd + (e % kVecs) * 4) =
        packed;
  }
}

// Bytes of the ring, which the key splits' partial num and l reuse at
// the end; the row maxima follow.
template <int DP, int KEYS, int WARPS>
__host__ __device__ constexpr size_t ring_bytes() {
  constexpr size_t ring = kStages * 2 * KEYS * DP * sizeof(float) +
                          kStages * 2 * KEYS * (DP + 8) * sizeof(__nv_bfloat16);
  constexpr size_t partials = WARPS * (DP / 2 + 2) * 32 * sizeof(float);
  return ring > partials ? ring : partials;
}

template <int DP, int KEYS, int WARPS>
constexpr size_t smem_bytes() {
  return ring_bytes<DP, KEYS, WARPS>() + WARPS * 16 * sizeof(float);
}

// DP: the head dim padded to a multiple of 16.  KEYS: keys a kv tile.
// WARPS: warps a block, 16 query rows each.  SPLITS: warps that share one
// row group, each taking KEYS / SPLITS keys of every kv tile; the block's
// q tile has 16 * WARPS / SPLITS rows.
template <int DP, int KEYS, int WARPS, int SPLITS>
__global__ void __launch_bounds__(32 * WARPS, kThreadsPerSm / (32 * WARPS))
    block_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, Out out, Dims d) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kRows = 16 * WARPS / SPLITS;
  constexpr int kKw = KEYS / SPLITS;  // keys of a kv tile one warp takes
  constexpr int kLd = DP + 8;         // bf16 row stride
  constexpr int kStage = 2 * KEYS * DP;  // floats a stage: K, then V
  constexpr int kTile = 2 * KEYS * kLd;  // bf16 a tile buffer: K, then V
  constexpr int kDFrags = DP / 8;
  static_assert(kKw % 16 == 0, "a warp takes whole 16-key slices");
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tiles =
      reinterpret_cast<__nv_bfloat16*>(stage + kStages * kStage);
  float* sRow = reinterpret_cast<float*>(smem + ring_bytes<DP, KEYS, WARPS>());

  const int i0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp / SPLITS;  // the warp's rows: rg*16 .. rg*16 + 15
  const int ks = warp % SPLITS;  // its keys of a tile: ks*kKw .. + kKw - 1
  const int g = lane >> 2;       // fragment row (and row + 8)
  const int c = lane & 3;        // fragment column pair
  const size_t row_stride = static_cast<size_t>(d.H) * d.D;
  const float* qb = q + static_cast<size_t>(b) * d.Sq * row_stride +
                    static_cast<size_t>(h) * d.D;
  const float* kb = k + static_cast<size_t>(b) * d.Sk * row_stride +
                    static_cast<size_t>(h) * d.D;
  const float* vb = v + static_cast<size_t>(b) * d.Sk * row_stride +
                    static_cast<size_t>(h) * d.D;

  // kv tiles [0, t_end) hold a key that some row of this q tile sees.
  const int n_tiles = (d.Sk + KEYS - 1) / KEYS;
  int t_end = n_tiles;
  if (d.causal) {
    const int i_last = min(i0 + kRows, d.Sq) - 1;
    const long long lim = d.q_offset + i_last - d.k_offset;
    t_end = lim < 0 ? 0
                    : static_cast<int>(
                          min(static_cast<long long>(n_tiles), lim / KEYS + 1));
  }
  // Step s < t_end is pass 1 on tile s (K only), step t_end + t pass 2 on
  // tile t (K and V).  Step s's copies land in stage s % 2 and are rounded
  // into tile buffer s % 2 a step ahead of its products: while a warp
  // multiplies step s's tiles, the block rounds step s + 1's and step
  // s + 2's copies are in flight, with one barrier a step.
  const int steps = 2 * t_end;  // even: none, or at least two
  auto issue = [&](int s) {
    float* st = stage + (s % kStages) * kStage;
    const int t = s < t_end ? s : s - t_end;
    issue_tile<DP, KEYS, kThreads>(st, kb, t * KEYS, d.Sk, d.D, row_stride);
    if (s >= t_end) {
      issue_tile<DP, KEYS, kThreads>(st + KEYS * DP, vb, t * KEYS, d.Sk,
                                     d.D, row_stride);
    }
    cp_async_commit();
  };
  auto round_step = [&](int s) {
    const float* st = stage + (s % kStages) * kStage;
    __nv_bfloat16* tb = tiles + (s % kStages) * kTile;
    round_tile<DP, KEYS, kThreads>(tb, st);
    if (s >= t_end) {
      round_tile<DP, KEYS, kThreads>(tb + KEYS * kLd, st + KEYS * DP);
    }
  };
  if (steps > 0) {
    issue(0);
    issue(1);
  }

  // This warp's A fragments of q, rounded to bf16 once, straight from
  // device memory into registers: a0 (row g, columns 2c, 2c + 1), a1
  // (row g + 8), a2 (columns + 8), a3 (both).
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gi = i0 + rg * 16 + g + (j & 1) * 8;
      const int col = kd * 16 + 2 * c + (j >> 1) * 8;
      float2 x = make_float2(0.0f, 0.0f);
      if (gi < d.Sq && col < d.D) {
        x = *reinterpret_cast<const float2*>(qb + gi * row_stride + col);
      }
      qf[kd][j] = pack_bf16(x.x, x.y);
    }
  }

  const long long q_first = d.q_offset + i0 + rg * 16;  // the warp's row 0
  float row_max[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float row_sum[2] = {0.0f, 0.0f};
  float acc[kDFrags][4];
#pragma unroll
  for (int n = 0; n < kDFrags; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }

  if (steps > 0) {
    cp_async_wait<1>();  // step 0's copies; step 1's may still fly
    __syncthreads();
    round_step(0);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();  // step s + 1's copies, the only ones in flight
    // Every copy of step s + 1 landed, step s's tiles are rounded, and
    // step s - 1's products and rounding are done.
    __syncthreads();
    if (s + 2 < steps) issue(s + 2);  // into the stage rounded at s - 1
    if (s + 1 < steps) round_step(s + 1);  // into the tiles read at s - 1
    const __nv_bfloat16* sK = tiles + (s % kStages) * kTile;
    const __nv_bfloat16* sV = sK + KEYS * kLd;
    const bool pass2 = s >= t_end;
    const int t = pass2 ? s - t_end : s;
    if (s == t_end) {
      // Pass 1 is over: the row group's max over the whole kv block.
      if (SPLITS > 1) {
#pragma unroll
        for (int j = 0; j < SPLITS; ++j) {
          const float* peer = sRow + (rg * SPLITS + j) * 16;
          row_max[0] = fmaxf(row_max[0], peer[g]);
          row_max[1] = fmaxf(row_max[1], peer[g + 8]);
        }
      }
      // Rows with no visible key: pin the max so their p is 0.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row_max[r] <= kNegInf / 2) row_max[r] = 0.0f;
      }
    }

    // This warp's keys of tile t: j0 .. j0 + kKw - 1.
    const int j0 = t * KEYS + ks * kKw;
    const bool live = j0 < d.Sk && (!d.causal || d.k_offset + j0 <=
                                                     q_first + 15);
    if (live) {
      const int mat = lane >> 3;  // the 8x8 matrix this lane addresses
      float sc[kKw / 8][4];
#pragma unroll
      for (int n = 0; n < kKw / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
      }
      {
        const int key = ks * kKw + (mat >> 1) * 8 + (lane & 7);
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
#pragma unroll
          for (int n2 = 0; n2 < kKw / 16; ++n2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, sK + (key + n2 * 16) * kLd + kd * 16 +
                                (mat & 1) * 8);
            mma_bf16(sc[2 * n2], qf[kd], bf[0], bf[1]);
            mma_bf16(sc[2 * n2 + 1], qf[kd], bf[2], bf[3]);
          }
        }
      }
      // s = acc * scale, rounded before the max and the exp (no FMA).
#pragma unroll
      for (int n = 0; n < kKw / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = __fmul_rn(sc[n][e], d.scale);
      }
      // Masked only where the warp's keys cross Sk or the diagonal: key
      // j0 + jj is visible to a row iff jj <= the row's limit.
      if (j0 + kKw > d.Sk ||
          (d.causal && d.k_offset + j0 + kKw - 1 > q_first)) {
        const int sk_last = min(d.Sk - j0, kKw) - 1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int last = sk_last;
          if (d.causal) {
            const long long rel = q_first + g + 8 * r - d.k_offset - j0;
            last = static_cast<int>(
                min(static_cast<long long>(last), max(rel, -1ll)));
          }
#pragma unroll
          for (int n = 0; n < kKw / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n * 8 + 2 * c + e > last) sc[n][2 * r + e] = kNegInf;
            }
          }
        }
      }
      if (!pass2) {
#pragma unroll
        for (int n = 0; n < kKw / 8; ++n) {
          row_max[0] = fmaxf(row_max[0], fmaxf(sc[n][0], sc[n][1]));
          row_max[1] = fmaxf(row_max[1], fmaxf(sc[n][2], sc[n][3]));
        }
      } else {
        // p = exp(s - m), l over the unrounded p, p.v with p in bf16
        // packed straight into the A fragment (the accumulator layout).
#pragma unroll
        for (int n = 0; n < kKw / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(__fsub_rn(sc[n][e], row_max[e >> 1]));
            row_sum[e >> 1] += p;
            sc[n][e] = p;
          }
        }
        const int key = ks * kKw + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < kKw / 16; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
          };
#pragma unroll
          for (int n2 = 0; n2 < DP / 16; ++n2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, sV + (key + kk * 16) * kLd + n2 * 16 +
                                      (mat >> 1) * 8);
            mma_bf16(acc[2 * n2], pa, bf[0], bf[1]);
            mma_bf16(acc[2 * n2 + 1], pa, bf[2], bf[3]);
          }
        }
      }
    }
    if (s == t_end - 1) {
      // The rows' max over this warp's keys, shared with its row group.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_max[r] = fmaxf(row_max[r],
                           __shfl_xor_sync(0xffffffffu, row_max[r], 1));
        row_max[r] = fmaxf(row_max[r],
                           __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      }
      if (SPLITS > 1 && c == 0) {
        sRow[warp * 16 + g] = row_max[0];
        sRow[warp * 16 + g + 8] = row_max[1];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (t_end == 0) row_max[r] = 0.0f;  // nothing visible
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }

  if (SPLITS > 1) {
    // The key splits' l and num meet in the ring, each value at its
    // fragment position, once every warp is done with the tiles.
    constexpr int kPer = (4 * kDFrags + 2) * 32;
    float* mine = stage + warp * kPer;
    __syncthreads();
    if (ks > 0) {
#pragma unroll
      for (int n = 0; n < kDFrags; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = acc[n][e];
      }
      mine[4 * kDFrags * 32 + lane] = row_sum[0];
      mine[(4 * kDFrags + 1) * 32 + lane] = row_sum[1];
    }
    __syncthreads();
    if (ks > 0) return;
#pragma unroll
    for (int j = 1; j < SPLITS; ++j) {
      const float* peer = mine + j * kPer;
#pragma unroll
      for (int n = 0; n < kDFrags; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += peer[(n * 4 + e) * 32 + lane];
      }
      row_sum[0] += peer[4 * kDFrags * 32 + lane];
      row_sum[1] += peer[(4 * kDFrags + 1) * 32 + lane];
    }
  }

  float* nb = out.num + static_cast<size_t>(b) * d.Sq * row_stride +
              static_cast<size_t>(h) * d.D;
  // The merge reads its rows' acc_m and acc_l before lane c == 0 of a
  // quad overwrites them.
  float acc_m[2] = {0.0f, 0.0f};
  float acc_l[2] = {0.0f, 0.0f};
  if (out.merge) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + rg * 16 + g + 8 * r;
      if (i < d.Sq) {
        const size_t idx = (static_cast<size_t>(b) * d.Sq + i) * d.H + h;
        acc_m[r] = out.m[idx];
        acc_l[r] = out.l[idx];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + rg * 16 + g + 8 * r;
    if (i >= d.Sq) continue;
    const size_t idx = (static_cast<size_t>(b) * d.Sq + i) * d.H + h;
    float* num_row = nb + i * row_stride;
    if (!out.merge) {
#pragma unroll
      for (int n = 0; n < kDFrags; ++n) {
        const int col = n * 8 + 2 * c;
        if (col < d.D) {
          *reinterpret_cast<float2*>(num_row + col) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
        }
      }
      if (c == 0) {
        out.m[idx] = row_max[r];
        out.l[idx] = row_sum[r];
      }
      continue;
    }
    // _merge, operation by operation.
    const float new_m = nan_max(acc_m[r], row_max[r]);
    const float a = expf(__fsub_rn(acc_m[r], new_m));
    const float bw = expf(__fsub_rn(row_max[r], new_m));
#pragma unroll
    for (int n = 0; n < kDFrags; ++n) {
      const int col = n * 8 + 2 * c;
      if (col < d.D) {
        float2 x = *reinterpret_cast<float2*>(num_row + col);
        x.x = __fadd_rn(__fmul_rn(x.x, a), __fmul_rn(acc[n][2 * r], bw));
        x.y = __fadd_rn(__fmul_rn(x.y, a), __fmul_rn(acc[n][2 * r + 1], bw));
        *reinterpret_cast<float2*>(num_row + col) = x;
      }
    }
    if (c == 0) {
      out.m[idx] = new_m;
      out.l[idx] = __fadd_rn(__fmul_rn(acc_l[r], a), __fmul_rn(row_sum[r], bw));
    }
  }
}

// The shared-memory limit is raised once per device for each instance,
// and the device's SM count read once.
unsigned long long device_bit(int device) {
  return device >= 0 && device < kMaxDevices ? 1ull << device : 0ull;
}

int sm_count(int device) {
  static std::atomic<int> known[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && known[device].load() > 0) return known[device].load();
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      n < 1) {
    n = 1;
  }
  if (cached) known[device].store(n);
  return n;
}

template <int DP, int KEYS, int WARPS, int SPLITS>
int launch_split(const float* q, const float* k, const float* v,
                 const Out& out, int B, const Dims& d, int device,
                 cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP, KEYS, WARPS>();
  constexpr int rows = 16 * WARPS / SPLITS;
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = device_bit(device);
  if (!bit || !(raised.load() & bit)) {
    auto kernel = block_attention_kernel<DP, KEYS, WARPS, SPLITS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  const dim3 grid((d.Sq + rows - 1) / rows, d.H, B);
  block_attention_kernel<DP, KEYS, WARPS, SPLITS>
      <<<grid, 32 * WARPS, smem, stream>>>(q, k, v, out, d);
  return static_cast<int>(cudaGetLastError());
}

// The tallest q tile that still gives every SM a block: 128 rows (8
// warps), else 64 rows of 4 warps, else 32 or 16 rows of 4 warps whose
// row groups split each kv tile's keys (at least 16 keys a warp).  A
// taller tile reads and rounds each K and V tile for more rows.
template <int DP>
int launch(const float* q, const float* k, const float* v, const Out& out,
           int B, const Dims& d, int device, cudaStream_t stream) {
  constexpr int KEYS = DP <= 64 ? 64 : 32;
  const long long sms = sm_count(device);
  const long long heads = static_cast<long long>(B) * d.H;
  auto blocks = [&](int rows) { return heads * ((d.Sq + rows - 1) / rows); };
  if (blocks(128) >= sms) {
    return launch_split<DP, KEYS, 8, 1>(q, k, v, out, B, d, device, stream);
  }
  if (blocks(64) >= sms) {
    return launch_split<DP, KEYS, 4, 1>(q, k, v, out, B, d, device, stream);
  }
  if constexpr (KEYS >= 64) {
    if (blocks(32) < sms) {
      return launch_split<DP, KEYS, 4, 4>(q, k, v, out, B, d, device,
                                          stream);
    }
  }
  return launch_split<DP, KEYS, 4, 2>(q, k, v, out, B, d, device, stream);
}

int dispatch(const float* q, const float* k, const float* v, const Out& out,
             int B, int Sq, int Sk, int H, int D, long long q_offset,
             long long k_offset, int causal, float scale, int device,
             void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 ||
      D < 8 || D > 128 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Dims d{Sq, Sk, H, D, q_offset, k_offset, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, B, d, device, s);
    case 2: return launch<32>(q, k, v, out, B, d, device, s);
    case 3: return launch<48>(q, k, v, out, B, d, device, s);
    case 4: return launch<64>(q, k, v, out, B, d, device, s);
    case 5: return launch<80>(q, k, v, out, B, d, device, s);
    case 6: return launch<96>(q, k, v, out, B, d, device, s);
    case 7: return launch<112>(q, k, v, out, B, d, device, s);
    default: return launch<128>(q, k, v, out, B, d, device, s);
  }
}

}  // namespace

extern "C" {

int attention_block_f32(const float* q, const float* k, const float* v,
                        float* num, float* m, float* l, int B, int Sq, int Sk,
                        int H, int D, long long q_offset, long long k_offset,
                        int causal, float scale, int device, void* stream) {
  return dispatch(q, k, v, Out{num, m, l, 0}, B, Sq, Sk, H, D, q_offset,
                  k_offset, causal, scale, device, stream);
}

int attention_block_merge_f32(float* acc_num, float* acc_m, float* acc_l,
                              const float* q, const float* k, const float* v,
                              int B, int Sq, int Sk, int H, int D,
                              long long q_offset, long long k_offset,
                              int causal, float scale, int device,
                              void* stream) {
  return dispatch(q, k, v, Out{acc_num, acc_m, acc_l, 1}, B, Sq, Sk, H, D,
                  q_offset, k_offset, causal, scale, device, stream);
}

}  // extern "C"
