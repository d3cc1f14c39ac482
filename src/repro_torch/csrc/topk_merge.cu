// Running top-k merge, for Hopper: a bitonic network over the warp's
// registers.
//
// Replaces the TPU kernel topk_merge_pallas (src/repro/kernels/topk_merge/
// topk_merge.py, body _merge_kernel).
//
// What it computes: for each query row, the k smallest of the k + m entries
// concat([run, cand]) (run: the row's running top-k, cand: m new
// candidates), ascending.  Every non-finite distance counts as +inf and
// sorts last; on ties the lower position wins, so the running entries win
// over the candidates; -0.0 and +0.0 tie.  A selected non-finite slot comes
// out as (+inf, id), the ids of non-finite entries taken in position order
// -- what the plain version's stable sort gives.  Neither list need be
// sorted.  No arithmetic: the result equals the plain version bit for bit.
//
// What bounds it on the H100: no arithmetic, so bytes: each row's k+m
// distances read once, the ids of the k selected entries read once and k
// (distance, id) pairs written, Q*(k+m)*4 + Q*k*id bytes + Q*k*(4+id bytes).
// At the sharded search's sizes (Q=16, k=10, m=30, int64 ids) that is
// 5.8 KB, 1.7 ns at 3.35 TB/s, so launch latency and the row's chain of
// dependent steps bound it in practice; at pod scale (Q=8192, k=32, m=96)
// it is 9.4 MB, 2.8 us, and the instructions a row issues bound it: the
// TPU kernel's k min/mask passes, one after another, cost ~k*(5 + n/32)
// dependent warp steps a row on this card.
//
// Design.  Each entry j of a row becomes one 64-bit key, the order-
// preserving image of its distance above j, so keys are unique and their
// order is (distance, position): the tie rule follows from the key alone.
// One warp takes a row (WARPS rows a block, the ragged edge masked).  The
// warp holds a chunk of N = 32*E keys in registers, E a lane, element
// i = lane*E + r in register r of lane i/E, and sorts it with a bitonic
// network: log2(N)*(log2(N)+1)/2 compare-exchange steps, those of stride
// >= E across lanes (__shfl_xor_sync), the others inside a lane; every lane
// does useful work at every step, and the count does not depend on k.  The
// chunk is loaded coalesced (entry base + r*32 + lane in register r: the
// network does not care where a key starts).  The first sorted chunk is the
// running list; each later chunk is sorted and merged into it: element i
// takes min(list[i], chunk[N-1-i]) (a shuffle with lane ^ 31, registers
// reversed), which leaves the N smallest as a bitonic sequence, and
// log2(N) clean-up steps sort them.  The next chunk's distances are loaded
// before the current one's network runs.  The wrapper picks N (32..256,
// >= k) from what binds: with at most one block an SM, a row's chain of
// dependent steps, so the smallest chunk that holds the row (the sharded
// shape, k = 10, n = 40: one 64-key sort, 21 steps); with more rows, issue
// slots, so chunks of K' = the next power of two >= k, at least 32 (pod
// scale, k = 32, n = 128: 4 chunks of 32, one key a lane, 78 steps of one
// register against 28 steps of 4 registers for one 128-key chunk, and
// every row's warp resident at once), where a serial selection of the k
// slots takes ~k*(5 + n/32) dependent steps a row.
//
// Output: lane j writes slot j (j + 32, ... for k > 32), fetching slot j's
// position from its lane by shuffle, then gathering its id and distance
// from device memory (the distances' lines were just read); the distance
// written is the input value at that position (isfinite ? value : +inf),
// not the decoded key, which would turn -0.0 into +0.0.  (Staging every
// entry's id in shared memory at load time, to save this second trip, was
// measured slower at the sharded shape and no faster at pod scale.)
//
// For k > 256 (a list beyond 8 keys a lane) the same network runs over
// shared memory instead: one block of SMEM_THREADS threads per row, a
// sorted list of K' = next power of two >= k keys and a chunk of K' keys,
// a barrier after every step; K' <= KMAX = 8192 (128 KB of keys).  One
// launch a call, no atomics: two calls give the same bits.
#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

using u64 = unsigned long long;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;             // rows a block on the register path
constexpr int EMAX = 8;              // keys a lane: chunks of up to 256 keys
constexpr int NREG = 32 * EMAX;      // the largest k the register path keeps
constexpr int SMEM_THREADS = 256;    // threads of a block on the shared-memory path
constexpr int KMAX = 8192;           // the largest K' the shared-memory path keeps
constexpr u64 PAD = ~0ull;           // above every real key

// Order-preserving image of a distance: non-finite -> +inf, -0 -> +0 (they
// tie in a float compare), then unsigned order is float order.
__device__ __forceinline__ unsigned order_key(float x) {
  if (!isfinite(x)) x = INFINITY;
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float x, int pos) {
  return (static_cast<u64>(order_key(x)) << 32) | static_cast<unsigned>(pos);
}

// Row-local views of the four inputs; entry j is run[j] for j < k, else
// cand[j - k].
template <typename TI>
struct Row {
  const float* rd;
  const float* cd;
  const TI* ri;
  const TI* ci;
  int k;
  __device__ __forceinline__ float dist(int j) const {
    return j < k ? __ldg(rd + j) : __ldg(cd + (j - k));
  }
  __device__ __forceinline__ TI id(int j) const {
    return j < k ? __ldg(ri + j) : __ldg(ci + (j - k));
  }
};

// ---------------------------------------------------------------------------
// register path: a warp per row
// ---------------------------------------------------------------------------

// One compare-exchange step over the warp's 32*E keys: element i = lane*E+r
// against i ^ stride, the lower of the pair keeping the smaller key where
// (i & size) == 0 and the larger elsewhere (size 0: ascending everywhere).
template <int E>
__device__ __forceinline__ void net_step(u64 (&x)[E], int lane, int size, int stride) {
  if (stride < E) {  // both keys in this lane
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & stride) continue;
      const int s = r | stride;
      const bool asc = ((lane * E + r) & size) == 0;
      const u64 lo = x[s] < x[r] ? x[s] : x[r];
      const u64 hi = x[s] < x[r] ? x[r] : x[s];
      x[r] = asc ? lo : hi;
      x[s] = asc ? hi : lo;
    }
  } else {  // the partner is register r of lane ^ (stride / E)
    const int lm = stride / E;
    const bool lower = (lane & lm) == 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const u64 y = __shfl_xor_sync(FULL, x[r], lm);
      const bool keep_min = lower == (((lane * E + r) & size) == 0);
      x[r] = keep_min == (y < x[r]) ? y : x[r];
    }
  }
}

// Sort the warp's N = 32*E keys ascending (element order i = lane*E + r).
template <int E, int LOG_N>
__device__ __forceinline__ void sort_net(u64 (&x)[E], int lane) {
#pragma unroll
  for (int ls = 1; ls <= LOG_N; ++ls)
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) net_step<E>(x, lane, 1 << ls, 1 << lt);
}

// best <- the N smallest of best and x, both sorted ascending: element i
// takes min(best[i], x[N-1-i]) (a bitonic sequence), then log2(N) clean-up
// steps.  x[N-1-i] is register E-1-r of lane 31-lane.
template <int E, int LOG_N>
__device__ __forceinline__ void merge_net(u64 (&best)[E], const u64 (&x)[E], int lane) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const u64 y = __shfl_xor_sync(FULL, x[E - 1 - r], 31);
    best[r] = y < best[r] ? y : best[r];
  }
#pragma unroll
  for (int lt = LOG_N - 1; lt >= 0; --lt) net_step<E>(best, lane, 0, 1 << lt);
}

template <typename TI, int E>
__global__ void __launch_bounds__(WARPS * 32)
topk_merge_warp(const float* __restrict__ run_d, const TI* __restrict__ run_i,
                const float* __restrict__ cand_d, const TI* __restrict__ cand_i,
                float* __restrict__ out_d, TI* __restrict__ out_i, int Q, int k, int m) {
  constexpr int N = 32 * E;
  constexpr int LOG_N = E == 1 ? 5 : E == 2 ? 6 : E == 4 ? 7 : 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= Q) return;  // ragged edge: no block-wide barrier follows
  const int n = k + m;
  const Row<TI> in{run_d + static_cast<size_t>(row) * k, cand_d + static_cast<size_t>(row) * m,
                   run_i + static_cast<size_t>(row) * k, cand_i + static_cast<size_t>(row) * m, k};

  float v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int j = r * 32 + lane;
    v[r] = j < n ? in.dist(j) : 0.f;
  }
  u64 best[E];
  for (int base = 0; base < n; base += N) {
    u64 x[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int j = base + r * 32 + lane;
      x[r] = j < n ? make_key(v[r], j) : PAD;
    }
    if (base + N < n) {  // the next chunk's loads fly while this one sorts
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int j = base + N + r * 32 + lane;
        v[r] = j < n ? in.dist(j) : 0.f;
      }
    }
    sort_net<E, LOG_N>(x, lane);
    if (base == 0) {
#pragma unroll
      for (int r = 0; r < E; ++r) best[r] = x[r];
    } else {
      merge_net<E, LOG_N>(best, x, lane);
    }
  }
  // slot s = t*32 + lane sits in register s % E of lane s / E (k <= N)
  const size_t o = static_cast<size_t>(row) * k;
#pragma unroll
  for (int t = 0; t < E; ++t) {
    if (t * 32 >= k) break;
    const int s = t * 32 + lane;
    int pos = 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int p = __shfl_sync(FULL, static_cast<int>(best[r] & 0xffffffffu), (s / E) & 31);
      if (s % E == r) pos = p;
    }
    if (s < k) {
      const float dd = in.dist(pos);
      out_d[o + s] = isfinite(dd) ? dd : INFINITY;
      out_i[o + s] = in.id(pos);
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory path (k > NREG): a block per row
// ---------------------------------------------------------------------------

// One compare-exchange step over x[0, 2*half): the pair (i, i | stride),
// i with bit `stride` clear, ascending where (i & size) == 0.
__device__ __forceinline__ void block_step(u64* x, int half, int size, int stride) {
  for (int t = threadIdx.x; t < half; t += SMEM_THREADS) {
    const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
    const int j = i | stride;
    const bool asc = (i & size) == 0;
    const u64 a = x[i], b = x[j];
    if ((b < a) == asc) {
      x[i] = b;
      x[j] = a;
    }
  }
  __syncthreads();
}

template <typename TI>
__global__ void __launch_bounds__(SMEM_THREADS)
topk_merge_block(const float* __restrict__ run_d, const TI* __restrict__ run_i,
                 const float* __restrict__ cand_d, const TI* __restrict__ cand_i,
                 float* __restrict__ out_d, TI* __restrict__ out_i, int k, int m, int kp) {
  extern __shared__ u64 keys_s[];
  u64* list = keys_s;        // the kp smallest keys so far, ascending
  u64* chunk = keys_s + kp;  // the next kp entries
  const int row = blockIdx.x, n = k + m, half = kp / 2;
  const Row<TI> in{run_d + static_cast<size_t>(row) * k, cand_d + static_cast<size_t>(row) * m,
                   run_i + static_cast<size_t>(row) * k, cand_i + static_cast<size_t>(row) * m, k};
  for (int base = 0; base < n; base += kp) {
    u64* x = base == 0 ? list : chunk;
    for (int i = threadIdx.x; i < kp; i += SMEM_THREADS) {
      const int j = base + i;
      x[i] = j < n ? make_key(in.dist(j), j) : PAD;
    }
    __syncthreads();
    for (int size = 2; size <= kp; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) block_step(x, half, size, stride);
    if (base == 0) continue;
    for (int i = threadIdx.x; i < kp; i += SMEM_THREADS) {
      const u64 y = chunk[kp - 1 - i];
      if (y < list[i]) list[i] = y;
    }
    __syncthreads();
    for (int stride = half; stride > 0; stride >>= 1) block_step(list, half, 0, stride);
  }
  const size_t o = static_cast<size_t>(row) * k;
  for (int s = threadIdx.x; s < k; s += SMEM_THREADS) {
    const int pos = static_cast<int>(static_cast<unsigned>(list[s]));
    const float dd = in.dist(pos);
    out_d[o + s] = isfinite(dd) ? dd : INFINITY;
    out_i[o + s] = in.id(pos);
  }
}

struct Args {
  const void *run_d, *run_i, *cand_d, *cand_i;
  void *out_d, *out_i;
  int Q, k, m;
};

template <typename TI, int E>
int launch_warp(const Args& a, cudaStream_t stream) {
  topk_merge_warp<TI, E><<<(a.Q + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(a.run_d), static_cast<const TI*>(a.run_i),
      static_cast<const float*>(a.cand_d), static_cast<const TI*>(a.cand_i),
      static_cast<float*>(a.out_d), static_cast<TI*>(a.out_i), a.Q, a.k, a.m);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch(const Args& a, int chunk, cudaStream_t stream) {
  if (a.k > NREG) {
    int kp = 1;
    while (kp < a.k) kp <<= 1;
    const size_t smem = 2 * sizeof(u64) * kp;
    auto kernel = topk_merge_block<TI>;
    const cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<a.Q, SMEM_THREADS, smem, stream>>>(
        static_cast<const float*>(a.run_d), static_cast<const TI*>(a.run_i),
        static_cast<const float*>(a.cand_d), static_cast<const TI*>(a.cand_i),
        static_cast<float*>(a.out_d), static_cast<TI*>(a.out_i), a.k, a.m, kp);
    return static_cast<int>(cudaGetLastError());
  }
  switch (chunk) {
    case 32: return launch_warp<TI, 1>(a, stream);
    case 64: return launch_warp<TI, 2>(a, stream);
    case 128: return launch_warp<TI, 4>(a, stream);
    default: return launch_warp<TI, 8>(a, stream);
  }
}

}  // namespace

// The largest k a row may keep (K' = next power of two >= k fills shared
// memory twice over at KMAX).  A row's length k + m is not capped by
// memory; its positions are ints, so the wrapper keeps k + m <= 2^30.
extern "C" int topk_merge_max_row() { return KMAX; }

// run_d (Q, k) f32, run_i (Q, k) i32|i64, cand_d (Q, m) f32, cand_i (Q, m)
// of run_i's type -> out_d (Q, k) f32, out_i (Q, k) of run_i's type.
// chunk: the register path's keys a chunk (32, 64, 128 or 256, at least k;
// ignored for k > 256, where the list lies in shared memory).  Requires Q >= 1,
// 1 <= k <= topk_merge_max_row(), m >= 1, k + m <= 2^30 and contiguous rows;
// the Python wrapper checks all of these.  Returns cudaGetLastError() after
// the launch.
extern "C" int topk_merge_launch(const void* run_d, const void* run_i, const void* cand_d,
                                 const void* cand_i, void* out_d, void* out_i, int Q, int k,
                                 int m, int chunk, int ids64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{run_d, run_i, cand_d, cand_i, out_d, out_i, Q, k, m};
  return ids64 ? launch<long long>(a, chunk, s) : launch<int>(a, chunk, s);
}
