// Fused IVF cluster scan: squared L2 distances + running top-k, for Hopper.
//
// Replaces the TPU kernel ivf_scan_pallas (src/repro/kernels/ivf_scan/
// ivf_scan.py, body _ivf_scan_kernel, selection _kpass_select).
//
// What it computes: for each query group g (QB queries), the distance
// ||q||^2 - 2 q.t + ||t||^2 (f32) to every row t < valid[c] of slab tile
// c = group_cluster[g], keeping the k smallest per query ordered by the key
// (dist, row): on ties the lower row wins, as _kpass_select and lax.top_k
// do.  Unfilled slots come out as (+inf, -1).
//
// What bounds it on the H100: per group it must read valid*d slab elements
// once and does 2*QB*valid*d FLOPs, about QB/2 FLOP per f32 byte (4 at
// QB=8), far below the ~20 FLOP/byte where CUDA-core f32 would bind, so it
// is bound by memory: bytes / 3.35 TB/s.  Rows past valid are never read.
//
// Design: one block (8 warps) per query group; the cluster's rows are looped
// inside the block (the TPU grid's sequential row-tile axis).  The group's
// queries sit in shared memory as f32.  Each warp takes 4 rows at a time,
// every lane reading 16-byte vectors of each row, so a row is read from
// device memory exactly once and each query chunk read from shared memory
// feeds 4 rows.  The (QB x 4) partial dots are reduced across the warp, and
// lane q inserts its query's 4 candidates into the warp's own sorted list
// (in shared memory).  Rows of a warp arrive in increasing order, so a
// strict (dist, row) comparison keeps the tie order.  At the end one thread
// per query merges the 8 warp lists into the block's top-k.
// A sub-stage often has few groups, so the card runs underfilled; splitting
// a cluster's rows across blocks with a merge pass is left to a later change.
#include <climits>
#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int KMAX = 32;          // largest k the kernel keeps
constexpr int WARPS = 8;          // warps per block
constexpr int ROWS = 4;           // rows a warp processes at once
constexpr int LSTRIDE = KMAX + 1; // padded list stride: no bank conflicts

__device__ __forceinline__ void insert(float* ld, int* li, int k, float dist, int row) {
  const float kd = ld[k - 1];
  const int ki = li[k - 1];
  if (!(dist < kd || (dist == kd && row < ki))) return;  // NaN never enters
  int p = k - 1;
  while (p > 0) {
    const float pd = ld[p - 1];
    const int pi = li[p - 1];
    if (pd < dist || (pd == dist && pi < row)) break;
    ld[p] = pd;
    li[p] = pi;
    --p;
  }
  ld[p] = dist;
  li[p] = row;
}

template <typename TQ, typename TS, int QBT>
__global__ void __launch_bounds__(WARPS * 32)
ivf_scan_kernel(const TQ* __restrict__ q, const int* __restrict__ group_cluster,
                const TS* __restrict__ slab, const int* __restrict__ valid,
                float* __restrict__ out_d, int* __restrict__ out_i,
                int QB, int C, int L, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [QBT][d] queries, f32
  float* qn_s = q_s + QBT * d;       // [QBT] squared query norms
  float* ld_s = qn_s + QBT;          // [WARPS][QBT][LSTRIDE] list distances
  int* li_s = reinterpret_cast<int*>(ld_s + WARPS * QBT * LSTRIDE);  // rows

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = group_cluster[g];
  const int nvalid = (c >= 0 && c < C) ? max(0, min(valid[c], L)) : 0;

  for (int i = tid; i < QBT * d; i += blockDim.x) {
    const int qq = i / d;
    q_s[i] = qq < QB ? to_f(q[(size_t)g * QB * d + i]) : 0.f;
  }
  for (int i = tid; i < WARPS * QBT * LSTRIDE; i += blockDim.x) {
    ld_s[i] = INFINITY;
    li_s[i] = INT_MAX;
  }
  __syncthreads();
  for (int qq = warp; qq < QBT; qq += WARPS) {
    float s = 0.f;
    for (int e = lane; e < d; e += 32) s += q_s[qq * d + e] * q_s[qq * d + e];
    s = warp_sum(s);
    if (lane == 0) qn_s[qq] = s;
  }
  __syncthreads();

  constexpr int N = Vec16<TS>::N;
  const int nvec = d / N;
  const TS* base = slab + (size_t)(nvalid > 0 ? c : 0) * L * d;
  float* my_d = ld_s + (warp * QBT + (lane < QBT ? lane : 0)) * LSTRIDE;
  int* my_i = li_s + (warp * QBT + (lane < QBT ? lane : 0)) * LSTRIDE;

  for (int r0 = warp * ROWS; r0 < nvalid; r0 += WARPS * ROWS) {
    float acc[ROWS][QBT];
    float nrm[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      nrm[r] = 0.f;
#pragma unroll
      for (int qq = 0; qq < QBT; ++qq) acc[r][qq] = 0.f;
    }
    for (int v = lane; v < nvec; v += 32) {
      float t[ROWS][N];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r0 + r < nvalid) {
          Vec16<TS>::load(base + (size_t)(r0 + r) * d + v * N, t[r]);
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) t[r][j] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int j = 0; j < N; ++j) nrm[r] += t[r][j] * t[r][j];
      }
#pragma unroll
      for (int qq = 0; qq < QBT; ++qq) {
        const float4* qp = reinterpret_cast<const float4*>(q_s + qq * d + v * N);
        float qv[N];
#pragma unroll
        for (int j = 0; j < N / 4; ++j) {
          const float4 x = qp[j];
          qv[4 * j] = x.x; qv[4 * j + 1] = x.y; qv[4 * j + 2] = x.z; qv[4 * j + 3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int j = 0; j < N; ++j) acc[r][qq] += t[r][j] * qv[j];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      nrm[r] = warp_sum(nrm[r]);
#pragma unroll
      for (int qq = 0; qq < QBT; ++qq) acc[r][qq] = warp_sum(acc[r][qq]);
    }
    if (lane < QB) {
      const float qn = qn_s[lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = r0 + r;
        if (row >= nvalid) break;
        float dot = 0.f;
#pragma unroll
        for (int qq = 0; qq < QBT; ++qq)
          if (qq == lane) dot = acc[r][qq];
        insert(my_d, my_i, k, qn - 2.f * dot + nrm[r], row);
      }
    }
  }
  __syncthreads();

  if (tid < QB) {
    int pos[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) pos[w] = 0;
    for (int j = 0; j < k; ++j) {
      int best = 0;
      float bd = INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int at = (w * QBT + tid) * LSTRIDE + pos[w];
        const float dd = ld_s[at];
        const int ii = li_s[at];
        if (dd < bd || (dd == bd && ii < bi)) {
          bd = dd;
          bi = ii;
          best = w;
        }
      }
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (w == best) ++pos[w];  // pos stays <= k <= KMAX < LSTRIDE
      const size_t o = ((size_t)g * QB + tid) * k + j;
      const bool fin = isfinite(bd);
      out_d[o] = fin ? bd : INFINITY;
      out_i[o] = fin ? bi : -1;
    }
  }
}

template <typename TQ, typename TS, int QBT>
int launch(const void* q, const void* gc, const void* slab, const void* valid,
           void* out_d, void* out_i, int G, int QB, int C, int L, int d, int k,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)QBT * d + QBT) +
                      (sizeof(float) + sizeof(int)) * WARPS * QBT * LSTRIDE;
  auto kernel = ivf_scan_kernel<TQ, TS, QBT>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<G, WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int*>(gc),
      static_cast<const TS*>(slab), static_cast<const int*>(valid),
      static_cast<float*>(out_d), static_cast<int*>(out_i), QB, C, L, d, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TS>
int launch_qb(const void* q, const void* gc, const void* slab, const void* valid,
              void* out_d, void* out_i, int G, int QB, int C, int L, int d, int k,
              cudaStream_t s) {
  if (QB <= 8) return launch<TQ, TS, 8>(q, gc, slab, valid, out_d, out_i, G, QB, C, L, d, k, s);
  return launch<TQ, TS, 16>(q, gc, slab, valid, out_d, out_i, G, QB, C, L, d, k, s);
}

}  // namespace

// q (G, QB, d) f32|bf16, group_cluster (G,) i32, slab (C, L, d) f32|bf16,
// valid (C,) i32 -> out_d (G, QB, k) f32, out_i (G, QB, k) i32.
// Requires QB <= 16, 1 <= k <= 32, d % 8 == 0 and 16-byte aligned pointers
// (the Python wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int ivf_scan_launch(const void* q, const void* group_cluster, const void* slab,
                               const void* valid, void* out_d, void* out_i, int G, int QB,
                               int C, int L, int d, int k, int q_bf16, int slab_bf16,
                               void* stream) {
  if (G <= 0) return 0;
  if (QB < 1 || QB > 16 || k < 1 || k > KMAX || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (slab_bf16)
      return launch_qb<__nv_bfloat16, __nv_bfloat16>(q, group_cluster, slab, valid, out_d, out_i, G, QB, C, L, d, k, s);
    return launch_qb<__nv_bfloat16, float>(q, group_cluster, slab, valid, out_d, out_i, G, QB, C, L, d, k, s);
  }
  if (slab_bf16)
    return launch_qb<float, __nv_bfloat16>(q, group_cluster, slab, valid, out_d, out_i, G, QB, C, L, d, k, s);
  return launch_qb<float, float>(q, group_cluster, slab, valid, out_d, out_i, G, QB, C, L, d, k, s);
}
