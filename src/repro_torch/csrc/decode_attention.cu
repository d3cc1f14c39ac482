// Single-token GQA decode attention for Hopper, split over the cache
// (flash-decoding).
//
// Replaces the TPU kernel decode_attention_pallas (src/repro/kernels/
// decode_attention/decode_attention.py, body _decode_attn_kernel, wrapper
// ops.py::decode_attention).  In the JAX model the same function is the
// jnp oracle layers.decode_attention_ref, called at models/layers.py:352;
// the port calls this kernel at that site.
//
// What it computes: for sequence b and query head h = kvh*G + g,
// softmax(q . k^T / sqrt(dh)) . v over the first lengths[b] cache rows of
// kv head kvh, with an online softmax (m, l, acc) accumulated in f32 on
// f32 or bf16 K/V.  The output is in q's dtype.  Lengths are >= 1 on the
// serving path (an empty slot decodes with cache_len + 1 = 1); a length of
// 0 gives zeros, as acc / max(l, 1e-30) does in the TPU kernel.  Given an
// lse pointer it also writes each head's natural log-sum-exp of the scores,
// ln 2 * (m + log2 l) in the base-2 state below (-inf for a length of 0):
// a rank that holds a block of a sequence-sharded cache returns it beside
// its output, and the partial outputs of the ranks are combined with it.
//
// What bounds it on the H100: it must read sum_b lengths[b] * KV * dh
// elements of K and of V once; the FLOPs are 4 * G per element pair, so at
// G = 2 it does ~2 FLOP per bf16 byte, against the ~295 at which bf16
// tensor cores would bind (and ~20 for f32 CUDA cores): bytes / 3.35 TB/s
// bound it.  Tensor cores are therefore not used: a (G x dh) . (dh x rows)
// product with G = 2 would fill 2 of wgmma's 64 rows, and the 69 MFLOP of
// the main path's call take ~1 us on CUDA cores at 67 TFLOP/s.  The design
// aims at bytes in flight and at filling the 132 SMs.
//
// Design.  The grid is (B * KV * NHG) x n_split: a block takes one kv head
// of one sequence, GB of its G query heads (NHG = ceil(G / GB) head groups,
// GB = 1, 2, 4 or 8), and one chunk of `chunk` cache rows; the wrapper
// picks the chunk from S and the grid size (never from the device-side
// lengths, which would cost a host sync): 128 rows at the main path's
// shape, 16 chunks of which ~9 are live at lengths ~1,055, ~4 blocks per
// SM.  Blocks whose chunk starts at or after lengths[b] return at once.
// In a block, 4 warps each own their rows: a row's K (and V) is read by lpr
// lanes as 16-byte vectors (16 lanes for 256 bytes at dh 128 in bf16), so
// one warp instruction covers 32 / lpr rows, and each lane group keeps U =
// 4 rows' K and V loads in flight.  Scores are an lpr-lane xor-shuffle
// reduction per (row, head); the online-softmax state (m, l and the lane's
// slice of acc for the GB heads) lives in registers, in base 2 (q is
// pre-scaled by log2(e) / sqrt(dh)).  No barrier is taken in the row loop.
// At the end of the block the states of its 4 * 32/lpr lane groups merge
// once, in shared memory, in fixed order.  (Measured on the H100: 8 warps,
// 8 rows in flight, two vectors a lane with double-buffered passes, and an
// L2 bulk prefetch of the chunk were none of them faster; the kernel takes
// ~1.2x the time of one torch.sum over the same bytes, PERF.md section 6.)
//
// Combine.  With one chunk covering lengths[b] the block writes the output
// itself.  Otherwise each block writes its partial (m, l, acc) in f32 to
// scratch the wrapper allocates, and the last block of its (b, kv head,
// head group) to finish, found with a counter that it resets, combines the
// partials in split order: m = max m_i, l = sum l_i 2^(m_i - m),
// out = sum acc_i 2^(m_i - m) / max(l, 1e-30), where an empty partial
// (m_i = -inf) weighs 0, so no 2^(-inf - -inf) is ever taken and a length
// of 0 gives zeros.  Split order makes two calls on one input give the same
// bits; one launch per call keeps the host-bound decode step from paying
// for a second one.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int W = 4;  // warps per block
constexpr int NT = W * 32;
constexpr int MAX_DH = 256;

// lanes per cache row: the row's 16-byte vectors rounded up to a power of
// two, at most a warp (a lane then takes vpr / 32 vectors)
__host__ __device__ inline int lanes_per_row(int vpr) {
  int p = 1;
  while (p < vpr && p < 32) p <<= 1;
  return p;
}

// natural log-sum-exp of a base-2 online-softmax state (m, l)
__device__ inline float lse_of(float m, float l) {
  return l > 0.f ? 0.6931471805599453f * (m + log2f(l)) : -INFINITY;
}

template <typename T, int GB, int VPL>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part,
                        unsigned* __restrict__ counters, int S, int KV, int G, int NHG,
                        int dh, int chunk, float qscale) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int U = VPL == 1 ? 4 : 2;  // rows in flight per lane group
  extern __shared__ __align__(16) float smem[];

  const int bhg = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int bh = bhg / NHG, hg = bhg - bh * NHG;
  const int b = bh / KV, h = bh - b * KV;
  const int len = max(0, min(lengths[b], S));
  const int n_active = max(1, min(n_split, (len + chunk - 1) / chunk));
  if (split >= n_active) return;

  const int g0 = hg * GB, gn = min(GB, G - g0);
  const int lo = split * chunk, hi = min(lo + chunk, len);
  const int vpr = dh / N, lpr = lanes_per_row(vpr), rpi = 32 / lpr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / lpr, sl = lane - sub * lpr;
  const size_t qoff = ((size_t)b * KV * G + (size_t)h * G + g0) * dh;

  float qr[GB][VPL][N];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
      const int vi = sl + 32 * t;
      if (g < gn && vi < vpr) {
        unpack16<T>(ld16(q + qoff + (size_t)g * dh + vi * N), qr[g][t]);
#pragma unroll
        for (int j = 0; j < N; ++j) qr[g][t][j] *= qscale;
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) qr[g][t][j] = 0.f;
      }
    }

  float m[GB], l[GB], acc[GB][VPL][N];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < VPL; ++t)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[g][t][j] = 0.f;
  }

  const size_t rs = (size_t)KV * dh;  // elements between cache rows
  const T* kb = k + ((size_t)b * S * KV + h) * dh;
  const T* vb = v + ((size_t)b * S * KV + h) * dh;
  const int step = W * rpi;  // rows one instruction of every warp covers
  // lane group `sub` of warp `warp` takes rows base + u*step + sub
  for (int base = lo + warp * rpi; base < hi; base += U * step) {
    uint4 kr[U][VPL], vr[U][VPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * step + sub;
      ok[u] = row < hi;
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        const int vi = sl + 32 * t;
        if (ok[u] && vi < vpr) {
          kr[u][t] = ld16(kb + row * rs + vi * N);
          vr[u][t] = ld16(vb + row * rs + vi * N);
        } else {
          kr[u][t] = vr[u][t] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GB; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        float kf[N];
        unpack16<T>(kr[u][t], kf);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int j = 0; j < N; ++j) s[u][g] += qr[g][t][j] * kf[j];
      }
    }
    for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GB; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    }
    // every lane of the group holds the same scores: update its state
    float p[U][GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float mn = fmaxf(m[g], mx);
      const bool any = mn > -INFINITY;
      const float alpha = any ? exp2f(m[g] - mn) : 1.f;  // exp2(-inf) = 0
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][g] = (ok[u] && any) ? exp2f(s[u][g] - mn) : 0.f;
        sum += p[u][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mn;
#pragma unroll
      for (int t = 0; t < VPL; ++t)
#pragma unroll
        for (int j = 0; j < N; ++j) acc[g][t][j] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        float vf[N];
        unpack16<T>(vr[u][t], vf);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int j = 0; j < N; ++j) acc[g][t][j] += p[u][g] * vf[j];
      }
  }

  // the block's lane-group states, merged once in shared memory
  const int nst = W * rpi;
  float* st_acc = smem;                  // [nst][GB][dh]
  float* st_m = st_acc + nst * GB * dh;  // [nst][GB]
  float* st_l = st_m + nst * GB;         // [nst][GB]
  const int st = warp * rpi + sub;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
      const int vi = sl + 32 * t;
      if (vi < vpr) {
#pragma unroll
        for (int j = 0; j < N; ++j) st_acc[(st * GB + g) * dh + vi * N + j] = acc[g][t][j];
      }
    }
    if (sl == 0) {
      st_m[st * GB + g] = m[g];
      st_l[st * GB + g] = l[g];
    }
  }
  __syncthreads();

  const size_t P = (size_t)GB * (dh + 2);  // floats of one partial: m[GB], l[GB], acc[GB][dh]
  float* mine = part + ((size_t)bhg * n_split + split) * P;
  const bool single = n_active == 1;
  for (int i = tid; i < gn * dh; i += NT) {
    const int g = i / dh, e = i - g * dh;
    float M = -INFINITY;
    for (int s2 = 0; s2 < nst; ++s2) M = fmaxf(M, st_m[s2 * GB + g]);
    float L = 0.f, A = 0.f;
    for (int s2 = 0; s2 < nst; ++s2) {
      const float mi = st_m[s2 * GB + g];
      if (mi > -INFINITY) {
        const float w = exp2f(mi - M);
        L += st_l[s2 * GB + g] * w;
        A += st_acc[(s2 * GB + g) * dh + e] * w;
      }
    }
    if (single) {
      out[qoff + (size_t)g * dh + e] = from_f<T>(A / fmaxf(L, 1e-30f));
      if (lse != nullptr && e == 0) lse[qoff / dh + g] = lse_of(M, L);
    } else {
      mine[2 * GB + g * dh + e] = A;
      if (e == 0) {
        mine[g] = M;
        mine[GB + g] = L;
      }
    }
  }
  if (single || !last_to_arrive(counters + bhg, n_active)) return;

  // the last block of this (b, kv head, head group): partials in split order
  const float* all = part + (size_t)bhg * n_split * P;
  for (int i = tid; i < gn * dh; i += NT) {
    const int g = i / dh, e = i - g * dh;
    float M = -INFINITY;
    for (int s2 = 0; s2 < n_active; ++s2) M = fmaxf(M, __ldcg(all + s2 * P + g));
    float L = 0.f, A = 0.f;
    for (int s2 = 0; s2 < n_active; ++s2) {
      const float mi = __ldcg(all + s2 * P + g);
      if (mi > -INFINITY) {
        const float w = exp2f(mi - M);
        L += __ldcg(all + s2 * P + GB + g) * w;
        A += __ldcg(all + s2 * P + 2 * GB + g * dh + e) * w;
      }
    }
    out[qoff + (size_t)g * dh + e] = from_f<T>(A / fmaxf(L, 1e-30f));
    if (lse != nullptr && e == 0) lse[qoff / dh + g] = lse_of(M, L);
  }
}

template <typename T, int GB, int VPL>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           void* lse, void* part, void* counters, int B, int S, int KV, int G, int dh, int chunk,
           int n_split, cudaStream_t stream) {
  const int NHG = (G + GB - 1) / GB;
  const int rpi = 32 / lanes_per_row(dh / (16 / (int)sizeof(T)));
  const size_t smem = sizeof(float) * (size_t)W * rpi * GB * (dh + 2);
  auto kernel = decode_attention_kernel<T, GB, VPL>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(dh));  // log2(e)/sqrt(dh)
  kernel<<<dim3(B * KV * NHG, n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<float*>(part),
      static_cast<unsigned*>(counters), S, KV, G, NHG, dh, chunk, qscale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GB>
int launch_vpl(const void* q, const void* k, const void* v, const void* lengths, void* out,
               void* lse, void* part, void* counters, int B, int S, int KV, int G, int dh, int chunk,
               int n_split, cudaStream_t s) {
  if (dh / (16 / (int)sizeof(T)) > 32)
    return launch<T, GB, 2>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, dh, chunk, n_split, s);
  return launch<T, GB, 1>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, dh, chunk, n_split, s);
}

template <typename T>
int launch_gb(const void* q, const void* k, const void* v, const void* lengths, void* out,
              void* lse, void* part, void* counters, int B, int S, int KV, int G, int GB, int dh,
              int chunk, int n_split, cudaStream_t s) {
  switch (GB) {
    case 1: return launch_vpl<T, 1>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, dh, chunk, n_split, s);
    case 2: return launch_vpl<T, 2>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, dh, chunk, n_split, s);
    case 4: return launch_vpl<T, 4>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, dh, chunk, n_split, s);
    case 8: return launch_vpl<T, 8>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, dh, chunk, n_split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, KV*G, dh), k/v (B, S, KV, dh), all f32 or all bf16; lengths (B,) i32
// -> out (B, KV*G, dh) in q's dtype and, where lse is not null, lse
// (B, KV*G) f32.  GB (1, 2, 4 or 8) query heads a block;
// the cache is cut into n_split chunks of `chunk` rows (n_split * chunk >= S).
// part: f32 scratch of B*KV*ceil(G/GB) * n_split * GB*(dh+2) floats (unused
// when n_split == 1); counters: B*KV*ceil(G/GB) u32, zero before the launch
// and zero again after it.  Requires dh <= 256 and dh * sizeof(T) a multiple
// of 16, contiguous 16-byte aligned tensors (the Python wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* lse, void* part,
                                       void* counters, int B, int S, int KV, int G, int GB,
                                       int dh, int chunk, int n_split, int bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  if (dh < 1 || dh > MAX_DH || chunk < 1 || n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_gb<__nv_bfloat16>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, GB, dh, chunk, n_split, s);
  return launch_gb<float>(q, k, v, lengths, out, lse, part, counters, B, S, KV, G, GB, dh, chunk, n_split, s);
}
