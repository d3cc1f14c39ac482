// Running top-k merge, for Hopper.
//
// Replaces the TPU kernel topk_merge_pallas (src/repro/kernels/topk_merge/
// topk_merge.py, body _merge_kernel).
//
// What it computes: for each query row, the k smallest of the k + m entries
// concat([run, cand]) (run: the row's running top-k, cand: m new
// candidates), ascending.  Every non-finite distance counts as +inf and
// sorts last; on ties the lower position wins, so the running entries win
// over the candidates.  A selected non-finite slot comes out as (+inf, id),
// the ids of non-finite entries taken in position order -- what the plain
// version's stable sort gives.  No arithmetic: the result equals the plain
// version bit for bit.
//
// What bounds it on the H100: no arithmetic, so bytes: each row's k+m
// distances read once, the ids of the k selected entries read once and k
// (distance, id) pairs written, Q*(k+m)*4 + Q*k*id bytes + Q*k*(4+id bytes).
// At the sharded search's sizes (Q=16, k=10, m=30, int64 ids) that is
// 5.8 KB, 1.7 ns at 3.35 TB/s, so launch latency bounds it in practice; at
// pod scale (Q=8192, k=32, m=96) it is 9.4 MB, 2.8 us.
//
// Design: one warp per query row, WARPS rows a block, any Q (the ragged
// edge is masked; warps never wait on each other).  The warp loads the
// row's k+m distances, coalesced, into shared memory as order-preserving
// 32-bit keys; the key of entry j
// widened with j in the low word is a 64-bit key that orders entries by
// (distance, position), so the minimum is unique.  Each lane keeps the
// minimum of its strided slice (j = lane mod 32).  Each of the k rounds
// takes the warp-wide minimum with __shfl_xor_sync and records its position
// in shared memory; the lane that held it marks the entry taken and rescans
// its slice, so an entry is never chosen twice -- the TPU kernel's BIG mask
// cannot mark an entry that is already BIG, and repeats position 0's id in
// +inf slots.  The rounds touch only registers and shared memory; after
// them lane j gathers slot j's distance and id, so the k reads of device
// memory overlap and the stores are coalesced.  The TPU kernel's k full
// min/mask passes over a (QB, k+m) VMEM tile and its Q % QB requirement do
// not carry over.
#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int WARPS = 4;                              // query rows per block
constexpr int NMAX = 232448 / (4 * WARPS);            // 2k+m words a row may hold
constexpr unsigned TAKEN = 0xffffffffu;               // above every real key

// Order-preserving image of a distance: non-finite -> +inf, -0 -> +0 (they
// tie in a float compare), then unsigned order is float order.
__device__ __forceinline__ unsigned order_key(float x) {
  if (!isfinite(x)) x = INFINITY;
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Smallest (key, position) of this lane's slice j = lane, lane + 32, ...
__device__ __forceinline__ unsigned long long lane_min(const unsigned* keys, int n, int lane) {
  unsigned long long best = ~0ull;
  for (int j = lane; j < n; j += 32) {
    const unsigned long long key = (static_cast<unsigned long long>(keys[j]) << 32) |
                                   static_cast<unsigned>(j);
    best = key < best ? key : best;
  }
  return best;
}

template <typename TI>
__global__ void __launch_bounds__(WARPS * 32)
topk_merge_kernel(const float* __restrict__ run_d, const TI* __restrict__ run_i,
                  const float* __restrict__ cand_d, const TI* __restrict__ cand_i,
                  float* __restrict__ out_d, TI* __restrict__ out_i,
                  int Q, int k, int m) {
  extern __shared__ unsigned keys_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= Q) return;  // ragged edge: no block-wide barrier follows
  const int n = k + m;
  unsigned* keys = keys_s + warp * (n + k);       // n keys, then k positions
  int* sel = reinterpret_cast<int*>(keys + n);
  const float* rd = run_d + static_cast<size_t>(row) * k;
  const float* cd = cand_d + static_cast<size_t>(row) * m;

  for (int j = lane; j < k; j += 32) keys[j] = order_key(__ldg(rd + j));
  for (int j = lane; j < m; j += 32) keys[k + j] = order_key(__ldg(cd + j));
  __syncwarp();  // lanes read keys other lanes wrote

  unsigned long long best = lane_min(keys, n, lane);
  const size_t o = static_cast<size_t>(row) * k;
  for (int r = 0; r < k; ++r) {
    unsigned long long w = best;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const unsigned long long x = __shfl_xor_sync(0xffffffffu, w, s);
      w = x < w ? x : w;
    }
    const int pos = static_cast<int>(static_cast<unsigned>(w));
    if (lane == (r & 31)) sel[r] = pos;
    if (w == best) {  // this lane held the winner (pos % 32 == lane)
      keys[pos] = TAKEN;
      best = lane_min(keys, n, lane);
    }
  }
  __syncwarp();  // lanes read positions other lanes wrote
  for (int j = lane; j < k; j += 32) {
    const int pos = sel[j];
    // the selected distance again, from the cache lines loaded above
    const float dd = pos < k ? rd[pos] : cd[pos - k];
    out_d[o + j] = isfinite(dd) ? dd : INFINITY;
    out_i[o + j] = pos < k ? run_i[o + pos] : cand_i[static_cast<size_t>(row) * m + (pos - k)];
  }
}

template <typename TI>
int launch(const void* run_d, const void* run_i, const void* cand_d, const void* cand_i,
           void* out_d, void* out_i, int Q, int k, int m, cudaStream_t stream) {
  const size_t smem = sizeof(unsigned) * WARPS * static_cast<size_t>(2 * k + m);
  auto kernel = topk_merge_kernel<TI>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(Q + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(run_d), static_cast<const TI*>(run_i),
      static_cast<const float*>(cand_d), static_cast<const TI*>(cand_i),
      static_cast<float*>(out_d), static_cast<TI*>(out_i), Q, k, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest 2k + m a row may have: its keys and picks fill shared memory.
extern "C" int topk_merge_max_row() { return NMAX; }

// run_d (Q, k) f32, run_i (Q, k) i32|i64, cand_d (Q, m) f32, cand_i (Q, m)
// of run_i's type -> out_d (Q, k) f32, out_i (Q, k) of run_i's type.
// Requires Q >= 1, k >= 1, m >= 1, 2k + m <= topk_merge_max_row() and
// contiguous rows; the Python wrapper checks all of these.  Returns
// cudaGetLastError() after the launch.
extern "C" int topk_merge_launch(const void* run_d, const void* run_i, const void* cand_d,
                                 const void* cand_i, void* out_d, void* out_i, int Q, int k,
                                 int m, int ids64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids64)
    return launch<long long>(run_d, run_i, cand_d, cand_i, out_d, out_i, Q, k, m, s);
  return launch<int>(run_d, run_i, cand_d, cand_i, out_d, out_i, Q, k, m, s);
}
