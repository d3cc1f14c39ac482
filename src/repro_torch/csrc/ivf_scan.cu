// Fused IVF cluster scan: squared L2 distances + running top-k, for Hopper,
// with a cluster's rows spread across blocks.
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
// QB=8, and a sub-stage's groups mostly carry one real query), far below
// the ~20 FLOP/byte where CUDA-core f32 would bind and the ~295 of the bf16
// tensor cores, so it is bound by memory: bytes / 3.35 TB/s.  Rows past
// valid are never read.  Tensor cores are not used: with ~1 real query a
// group, a wgmma tile would be 1/64 full, and the FMAs on CUDA cores take
// ~1 us of a call at the main path's shape.
//
// Design.  The grid is G x R: block (g, r) scans rows [r*span, (r+1)*span)
// of cluster group_cluster[g], stopping at valid[c]; the wrapper picks span
// (a multiple of the rows a block takes per pass) from L and G so that G*R
// is ~3 x 132 blocks, since a sub-stage's probes rarely share a cluster and
// G is small (17 groups on the main path: span 32, R 24).  Blocks past
// valid[c] return at once.  In a block (8 warps) the group's queries sit in
// shared memory as f32, loaded 16 bytes a lane; each warp takes ROWS =
// 32/QBT rows at a time (4 at QB <= 8), every lane reading 16-byte vectors
// of each row, two vectors per row in flight, so a row is read from device
// memory exactly once and each query chunk read from shared memory feeds
// ROWS rows.  (Measured on the H100: 4 warps of 8 rows, and an L2 bulk
// prefetch of the block's rows, were both slower.)  A row's distance is
// computed as before the split (lane v takes vectors v, v+32, ...;
// warp_sum), so it does not depend on the split.  The (QBT x ROWS) partial
// dots are reduced across the warp, and lane q inserts its query's
// candidates into the warp's own sorted list (shared memory) under the
// strict (dist, row) key; one thread per query then merges the 8 warp
// lists into the block's list.
//
// Merge.  With one block covering valid[c], that block writes the output.
// Otherwise each block writes its k-lists to scratch, and the last block of
// the group to finish (a counter per group, reset by that block) stages the
// R lists in shared memory and merges them in split order, a warp per
// query with one list per lane, by the same (dist, row) key: rows are
// unique, so ties across split edges go to the lower row and the result is
// the one a single block would give, bit for bit, on every call.  Unfilled
// slots stay (+inf, -1).  One launch per call.  topk_merge was not reused
// for this: its (run, cand) layout would need the lists copied, and a
// second launch per call.
#include <climits>
#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int KMAX = 32;          // largest k the kernel keeps
constexpr int WARPS = 8;          // warps per block
constexpr int RMAX = 32;          // most splits of a cluster: one merge lane each
constexpr int LSTRIDE = KMAX + 1; // padded list stride: no bank conflicts

__device__ __forceinline__ bool before(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

__device__ __forceinline__ void insert(float* ld, int* li, int k, float dist, int row) {
  if (!before(dist, row, ld[k - 1], li[k - 1])) return;  // NaN never enters
  int p = k - 1;
  while (p > 0) {
    const float pd = ld[p - 1];
    const int pi = li[p - 1];
    if (before(pd, pi, dist, row)) break;
    ld[p] = pd;
    li[p] = pi;
    --p;
  }
  ld[p] = dist;
  li[p] = row;
}

// shared memory: queries, norms, then the list area, which holds the warps'
// lists [WARPS][QBT][LSTRIDE] and later the staged split lists [R][QB][k]
__host__ __device__ inline size_t list_pairs(int QBT, int QB, int k, int R) {
  const size_t warp_lists = (size_t)WARPS * QBT * LSTRIDE;
  const size_t staged = R > 1 ? (size_t)R * QB * k : 0;
  return warp_lists > staged ? warp_lists : staged;
}

template <typename TQ, typename TS, int QBT>
__global__ void __launch_bounds__(WARPS * 32)
ivf_scan_kernel(const TQ* __restrict__ q, const int* __restrict__ group_cluster,
                const TS* __restrict__ slab, const int* __restrict__ valid,
                float* __restrict__ out_d, int* __restrict__ out_i,
                float* __restrict__ part_d, int* __restrict__ part_i,
                unsigned* __restrict__ counters, int QB, int C, int L, int d, int k,
                int span) {
  constexpr int ROWS = 32 / QBT;        // rows a warp processes at once
  constexpr int N = 16 / sizeof(TS);    // slab elements per 16-byte vector
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x, r = blockIdx.y, R = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = group_cluster[g];
  const int nvalid = (c >= 0 && c < C) ? max(0, min(valid[c], L)) : 0;
  const int n_active = max(1, min(R, (nvalid + span - 1) / span));
  if (r >= n_active) return;
  const int row_lo = r * span, row_hi = min(row_lo + span, nvalid);

  const size_t npairs = list_pairs(QBT, QB, k, R);
  float* q_s = smem;                 // [QBT][d] queries, f32
  float* qn_s = q_s + QBT * d;       // [QBT] squared query norms
  float* ld_s = qn_s + QBT;          // list distances
  int* li_s = reinterpret_cast<int*>(ld_s + npairs);  // list rows

  // the group's queries, 16 bytes a load (QB * d is a multiple of 8), QV
  // loads in flight a thread
  constexpr int NQ = 16 / sizeof(TQ), QV = 8;
  const TQ* qg = q + (size_t)g * QB * d;
  const int qstep = blockDim.x * NQ;
  for (int i0 = tid * NQ; i0 < QBT * d; i0 += QV * qstep) {
    uint4 raw[QV];
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int i = i0 + u * qstep;
      raw[u] = i < QB * d ? ld16(qg + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int i = i0 + u * qstep;
      if (i < QBT * d) unpack16<TQ>(raw[u], q_s + i);
    }
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

  const int nvec = d / N;
  const TS* base = slab + (size_t)(nvalid > 0 ? c : 0) * L * d;
  float* my_d = ld_s + (warp * QBT + (lane < QBT ? lane : 0)) * LSTRIDE;
  int* my_i = li_s + (warp * QBT + (lane < QBT ? lane : 0)) * LSTRIDE;

  for (int r0 = row_lo + warp * ROWS; r0 < row_hi; r0 += WARPS * ROWS) {
    float acc[ROWS][QBT];
    float nrm[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      nrm[rr] = 0.f;
#pragma unroll
      for (int qq = 0; qq < QBT; ++qq) acc[rr][qq] = 0.f;
    }
    // one row-vector step: rows' norms and dots with every query
    auto accumulate = [&](const uint4 (&raw)[ROWS], int v) {
      float t[ROWS][N];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        unpack16<TS>(raw[rr], t[rr]);
#pragma unroll
        for (int j = 0; j < N; ++j) nrm[rr] += t[rr][j] * t[rr][j];
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
        for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
          for (int j = 0; j < N; ++j) acc[rr][qq] += t[rr][j] * qv[j];
        }
      }
    };
    for (int v0 = lane; v0 < nvec; v0 += 64) {
      const int v1 = v0 + 32;
      const bool has1 = v1 < nvec;
      uint4 t0[ROWS], t1[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const bool ok = r0 + rr < row_hi;
        const TS* row = base + (size_t)(r0 + rr) * d;
        t0[rr] = ok ? ld16(row + v0 * N) : make_uint4(0u, 0u, 0u, 0u);
        t1[rr] = ok && has1 ? ld16(row + v1 * N) : make_uint4(0u, 0u, 0u, 0u);
      }
      accumulate(t0, v0);
      if (has1) accumulate(t1, v1);
    }
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      nrm[rr] = warp_sum(nrm[rr]);
#pragma unroll
      for (int qq = 0; qq < QBT; ++qq) acc[rr][qq] = warp_sum(acc[rr][qq]);
    }
    if (lane < QB) {
      const float qn = qn_s[lane];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const int row = r0 + rr;
        if (row >= row_hi) break;
        float dot = 0.f;
#pragma unroll
        for (int qq = 0; qq < QBT; ++qq)
          if (qq == lane) dot = acc[rr][qq];
        insert(my_d, my_i, k, qn - 2.f * dot + nrm[rr], row);
      }
    }
  }
  __syncthreads();

  // the block's list per query: merge the warps' lists
  const bool single = n_active == 1;
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
        if (before(ld_s[at], li_s[at], bd, bi)) {
          bd = ld_s[at];
          bi = li_s[at];
          best = w;
        }
      }
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (w == best) ++pos[w];  // pos stays <= k <= KMAX < LSTRIDE
      if (single) {
        const size_t o = ((size_t)g * QB + tid) * k + j;
        const bool fin = isfinite(bd);
        out_d[o] = fin ? bd : INFINITY;
        out_i[o] = fin ? bi : -1;
      } else {
        const size_t o = (((size_t)g * R + r) * QB + tid) * k + j;
        part_d[o] = bd;
        part_i[o] = bi;
      }
    }
  }
  if (single || !last_to_arrive(counters + g, n_active)) return;

  // the last block of group g: stage the n_active lists, merge in split order
  const size_t first = (size_t)g * R * QB * k;
  for (int i = tid; i < n_active * QB * k; i += blockDim.x) {
    ld_s[i] = __ldcg(part_d + first + i);
    li_s[i] = __ldcg(part_i + first + i);
  }
  __syncthreads();
  for (int qq = warp; qq < QB; qq += WARPS) {
    int pos = 0;  // lane r's next entry in split r's list
    for (int j = 0; j < k; ++j) {
      float hd = INFINITY;
      int hi = INT_MAX;
      if (lane < n_active && pos < k) {
        hd = ld_s[(lane * QB + qq) * k + pos];
        hi = li_s[(lane * QB + qq) * k + pos];
      }
      float bd = hd;
      int bi = hi;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (before(od, oi, bd, bi)) {
          bd = od;
          bi = oi;
        }
      }
      // every lane holds the least key; rows are unique, so one lane owns it,
      // and once it is an unfilled slot every later one is too
      if (bi != INT_MAX && hi == bi) ++pos;
      if (lane == 0) {
        const size_t o = ((size_t)g * QB + qq) * k + j;
        const bool fin = bi != INT_MAX && isfinite(bd);
        out_d[o] = fin ? bd : INFINITY;
        out_i[o] = fin ? bi : -1;
      }
    }
  }
}

template <typename TQ, typename TS, int QBT>
int launch(const void* q, const void* gc, const void* slab, const void* valid,
           void* out_d, void* out_i, void* part_d, void* part_i, void* counters, int G,
           int QB, int C, int L, int d, int k, int span, int R, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)QBT * d + QBT) +
                      (sizeof(float) + sizeof(int)) * list_pairs(QBT, QB, k, R);
  auto kernel = ivf_scan_kernel<TQ, TS, QBT>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(G, R), WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int*>(gc),
      static_cast<const TS*>(slab), static_cast<const int*>(valid),
      static_cast<float*>(out_d), static_cast<int*>(out_i), static_cast<float*>(part_d),
      static_cast<int*>(part_i), static_cast<unsigned*>(counters), QB, C, L, d, k, span);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TS>
int launch_qb(const void* q, const void* gc, const void* slab, const void* valid,
              void* out_d, void* out_i, void* part_d, void* part_i, void* counters, int G,
              int QB, int C, int L, int d, int k, int span, int R, cudaStream_t s) {
  if (QB <= 8)
    return launch<TQ, TS, 8>(q, gc, slab, valid, out_d, out_i, part_d, part_i, counters, G, QB,
                             C, L, d, k, span, R, s);
  return launch<TQ, TS, 16>(q, gc, slab, valid, out_d, out_i, part_d, part_i, counters, G, QB,
                            C, L, d, k, span, R, s);
}

}  // namespace

// q (G, QB, d) f32|bf16, group_cluster (G,) i32, slab (C, L, d) f32|bf16,
// valid (C,) i32 -> out_d (G, QB, k) f32, out_i (G, QB, k) i32.  Each
// cluster's rows are cut into R <= 32 ranges of `span` rows (R * span >= L).
// part_d/part_i: scratch of G*R*QB*k f32 / i32 (unused when R == 1);
// counters: G u32, zero before the launch and zero again after it.
// Requires QB <= 16, 1 <= k <= 32, d % 8 == 0 and 16-byte aligned pointers
// (the Python wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int ivf_scan_launch(const void* q, const void* group_cluster, const void* slab,
                               const void* valid, void* out_d, void* out_i, void* part_d,
                               void* part_i, void* counters, int G, int QB, int C, int L,
                               int d, int k, int span, int R, int q_bf16, int slab_bf16,
                               void* stream) {
  if (G <= 0) return 0;
  if (QB < 1 || QB > 16 || k < 1 || k > KMAX || d % 8 != 0 || span < 1 || R < 1 || R > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto tq, auto ts) {
    using TQ = decltype(tq);
    using TS = decltype(ts);
    return launch_qb<TQ, TS>(q, group_cluster, slab, valid, out_d, out_i, part_d, part_i,
                             counters, G, QB, C, L, d, k, span, R, s);
  };
  if (q_bf16) return slab_bf16 ? run(__nv_bfloat16{}, __nv_bfloat16{}) : run(__nv_bfloat16{}, 0.f);
  return slab_bf16 ? run(0.f, __nv_bfloat16{}) : run(0.f, 0.f);
}
