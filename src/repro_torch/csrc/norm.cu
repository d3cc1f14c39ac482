// RMSNorm or LayerNorm over the last dim, with an optional residual add
// before it, for Hopper: a lane group, a warp or a few warps a row, the row
// held in registers.
//
// Has no Pallas counterpart.  It replaces the chain of elementwise ops of
// the port's models/layers.py apply_norm (and of rms_norm_headwise over a
// whole row, MLA's latent norms), and the residual adds before a block's
// norms (models/lm.py _apply_block: the mixer's output before norm2, the
// FFN's before the next block's norm1 or the final norm), which the JAX
// package writes as jnp ops in src/repro/models/layers.py apply_norm and
// its jit hands to XLA, which fuses them into one kernel.  Run eagerly or
// replayed from a CUDA graph, the port launched ~8 kernels a call for the
// same work.
//
// What it computes, for row r of x (rows x d, the last dim contiguous):
//   s = x + delta, rounded to x's dtype and written to res (when delta is
//       given; else s = x),
//   RMSNorm:   y = s * rsqrt(mean(s^2) + eps) * scale
//   LayerNorm: y = (s - mu) * rsqrt(mean((s - mu)^2) + eps) * scale + bias
// in f32, scale and bias widened from the parameter's own dtype, y rounded
// to x's dtype.  Rounding follows the plain chain (kernels/norm/ref.py)
// op for op: every f32 product, sum and difference is its own
// __fmul_rn / __fadd_rn / __fsub_rn, as each is a tensor op of its own
// there, so none becomes an fma; the mean is the sum times 1/d (f32), as
// ATen's mean on the card; rsqrtf, never a fast form.  Only the order of
// the row's sum differs from ATen's reduction, so y is within 1 ulp of the
// plain version in bf16 (rtol 1e-6 in f32; a LayerNorm output that cancels,
// x - mu or a bias against the scaled value, within a few f32 ulps of its
// O(1) terms), and s is equal bit for bit.
//
// The output is not batch-invariant.  The lanes a row takes (G below), and
// so the order of its sum, depend on how many rows the launch holds: at d
// 2,048 bf16 a decode step's 8 rows take 256 lanes a row, an admission's
// 504 rows 64 and 512 rows or more 32.  One row's y can then differ in its
// last bit between those launches, within 1 ulp of itself in bf16 (the
// LayerNorm cancel bound above; rtol 1e-6 in f32); s is the same bits at
// every layout (tests/test_torch_fused.py and test_torch_fused_layout.py
// hold both).
//
// What bounds it on the H100: a row is read once (twice with delta) and
// written once (twice): bytes / 3.35 TB/s at the prefill's 1024 x 2048
// rows (8 MB, ~2.5 us); at decode (8 rows) the latency of one launch and
// of its dependent steps (load, sum, normalise, store).  The design keeps
// that chain short and the card full:
// * a row of up to 256 16-byte vectors (2,048 bf16 or 1,024 f32 values)
//   takes a group of G = 1..32 lanes (a power of two), several rows to a
//   warp at narrow widths (rms_norm_headwise over d_head, MLA's 512-wide
//   latent); a lane holds at most NV = 4 or 8 vectors of the row, raw, in
//   registers, so the row is read once and never staged in shared memory;
//   the row's sum is one xor-shuffle tree over the group: no shared
//   memory and no __syncthreads;
// * a wider row (phi3's 3,072, llama4's and stablelm's 5,120, qwen1.5's
//   8,192, up to 32,768) takes G = 64..512 lanes, a block of 2-16 warps,
//   and NV = 8 (16 for f32 rows past 16,384): each warp's tree, then one
//   exchange between warps through shared memory (LayerNorm: one for its
//   mean and one for its variance);
// * rows that fill fewer than 512 warps so (a decode step's 8) take twice
//   the lanes, again and again, down to one vector a lane: a 2,048-wide
//   bf16 row then takes 8 warps, so each lane's chain of dependent work
//   (its loads, adds and stores) stays short while one row runs on one SM;
//   narrower layouts pack rows into blocks of one warp (four once the rows
//   fill ~1,024 warps), so a prefill's 1,024 rows run as ~1,024 warps;
// * every load and store is a 16-byte vector, scale and bias too (8 or
//   32 bytes where their dtype differs from x's); all of a lane's loads
//   (x, delta, and scale and bias where registers allow) are issued before
//   its first store: the compiler does not move a load above an earlier
//   store, so loads between stores would each wait out their latency;
// * no function attribute is set at launch (no dynamic shared memory).
// The row's sum, in the order tests/test_torch_fused_layout.py emulates:
// lane l of a group holds vectors l, l + G, l + 2G, ... of the row; it adds
// its terms in that order, element by element, from 0; the group's tree
// adds lane (l ^ o)'s partial for o = min(G, 32) / 2, ..., 1 (every lane
// ends with the same bits, since a + b = b + a); a row of several warps
// then adds the warps' partials in warp order, from 0.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int MAX_THREADS = 512;

// The row's sum from each lane's partial: the group's xor tree, then (G >
// 32) the warps' partials in warp order through `red` (G / 32 floats).
__device__ __forceinline__ float row_sum(float v, int G, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < G) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (G <= 32) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < G / 32; ++w) t = __fadd_rn(t, red[w]);
  return t;
}

template <typename T, typename P, int NV, bool LN>
__global__ void __launch_bounds__(MAX_THREADS)
norm_kernel(const T* __restrict__ x, long long x_stride, const T* __restrict__ delta,
            T* __restrict__ res, T* __restrict__ y, const P* __restrict__ scale,
            const P* __restrict__ bias, int rows, int d, int G, float inv_d, float eps) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  // When each load is issued, within ~96 registers of raw vectors a lane
  // (past that the compiler spills): delta with x, before the residual's
  // stores; scale and bias with them too, or else all in one batch after
  // the sum (when the row's delta is dead), or else (f32 parameters of a
  // LayerNorm, or 16 vectors a lane) one vector at a time.
  constexpr int WT = Raw<T, V>::W, WP = Raw<P, V>::W * (LN ? 2 : 1);
  constexpr bool DV_EARLY = NV * 2 * WT <= 96;
  constexpr bool P_EARLY = DV_EARLY && NV * (2 * WT + WP) <= 96;
  constexpr bool P_BATCH = !P_EARLY && NV * (WT + WP) <= 96;
  __shared__ float red[2][MAX_THREADS / 32];
  const int nvec = d / V;
  const int lane = threadIdx.x & (G - 1);
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / G) + threadIdx.x / G;
  const bool live = r < rows;
  const T* xr = x + r * x_stride;
  const long long o = r * d;

  Raw<T, V> s[NV], dv[DV_EARLY ? NV : 1];
  Raw<P, V> sc[NV], bi[LN ? NV : 1];
  auto load_params = [&](int i, int c) {
    sc[i].load(scale + c * V);
    if constexpr (LN) bi[i].load(bias + c * V);
  };
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * G;
    if (live && c < nvec) {
      s[i].load(xr + c * V);
      if constexpr (DV_EARLY)
        if (delta != nullptr) dv[i].load(delta + o + c * V);
      if constexpr (P_EARLY) load_params(i, c);
    }
  }
  if (delta != nullptr) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * G;
      if (live && c < nvec) {
        Raw<T, V> dd;
        if constexpr (DV_EARLY) dd = dv[i];
        else dd.load(delta + o + c * V);
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fadd_rn(s[i].get(j), dd.get(j));
        s[i].set(v);  // s rounded to T, as the plain chain stores it
        s[i].store(res + o + c * V);
      }
    }
  }

  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (live && lane + i * G < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = s[i].get(j);
        acc = __fadd_rn(acc, LN ? v : __fmul_rn(v, v));
      }
    }
  float mu = 0.f, var;
  if constexpr (LN) {
    mu = __fmul_rn(row_sum(acc, G, red[0]), inv_d);
    acc = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live && lane + i * G < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = __fsub_rn(s[i].get(j), mu);
          acc = __fadd_rn(acc, __fmul_rn(t, t));
        }
      }
    var = __fmul_rn(row_sum(acc, G, red[1]), inv_d);
  } else {
    var = __fmul_rn(row_sum(acc, G, red[0]), inv_d);
  }
  const float rs = rsqrtf(__fadd_rn(var, eps));
  if constexpr (P_BATCH) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live && lane + i * G < nvec) load_params(i, lane + i * G);
  }

  // y = ((s - mu) * rs) * scale (+ bias), rounded to T
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * G;
    if (!(live && c < nvec)) continue;
    if constexpr (!P_EARLY && !P_BATCH) load_params(i, c);
    const Raw<P, V>& sv = sc[i];
    const Raw<P, V>& bv = bi[LN ? i : 0];
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = LN ? __fsub_rn(s[i].get(j), mu) : s[i].get(j);
      out[j] = __fmul_rn(__fmul_rn(t, rs), sv.get(j));
      if constexpr (LN) out[j] = __fadd_rn(out[j], bv.get(j));
    }
    Raw<T, V> yv;
    yv.set(out);
    yv.store(y + o + c * V);
  }
}

// The lanes G a row takes (a power of two) and the vectors NV (4, 8 or 16)
// a lane holds at most: the fewest lanes that hold the row at 4 vectors a
// lane up to 128 vectors, else at 8 (16 past 4,096 vectors); then, while
// the rows fill fewer than FILL_WARPS warps (a decode step's few rows), G
// doubles up to one vector a lane, so each lane's chain of dependent work
// stays short and the row's loads spread over more warps.
constexpr long long FILL_WARPS = 512;

inline void norm_layout(int rows, int nvec, int* G_out, int* NV_out) {
  int nv = nvec <= 4 * 32 ? 4 : (nvec <= 8 * MAX_THREADS ? 8 : 16);
  int G = 1;
  while (G * nv < nvec) G *= 2;
  while (G < MAX_THREADS && G < nvec && static_cast<long long>(rows) * G < 32 * FILL_WARPS) G *= 2;
  nv = 4;
  while (nv * G < nvec) nv *= 2;
  *G_out = G;
  *NV_out = nv;
}

template <typename T, typename P, int NV, bool LN>
int launch(const void* x, long long x_stride, const void* delta, void* res, void* y,
           const void* scale, const void* bias, int rows, int d, int G, float eps,
           cudaStream_t s) {
  // G <= 32: rows of G lanes in blocks of one warp, four once the rows fill
  // 1,024 warps; G > 32: one row a block of G threads
  int threads = G;
  if (G <= 32) threads = static_cast<long long>(rows) * G >= 32LL * 1024 ? 128 : 32;
  const long long blocks = G > 32 ? rows : (static_cast<long long>(rows) * G + threads - 1) / threads;
  norm_kernel<T, P, NV, LN><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(delta), static_cast<T*>(res),
      static_cast<T*>(y), static_cast<const P*>(scale), static_cast<const P*>(bias), rows, d, G,
      1.0f / static_cast<float>(d), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int dispatch(const void* x, long long x_stride, const void* delta, void* res, void* y,
             const void* scale, const void* bias, int rows, int d, float eps, int layernorm,
             cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int nvec = d / V;
  int G, NV;
  norm_layout(rows, nvec, &G, &NV);
  if (G > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
#define NORM_LAUNCH(nv) \
  return layernorm ? launch<T, P, nv, true>(x, x_stride, delta, res, y, scale, bias, rows, d, G, eps, s) \
                   : launch<T, P, nv, false>(x, x_stride, delta, res, y, scale, bias, rows, d, G, eps, s)
  if (NV == 4) NORM_LAUNCH(4);
  if (NV == 8) NORM_LAUNCH(8);
  if constexpr (V == 4) NORM_LAUNCH(16);  // f32 rows past 16,384 (bf16 never needs 16)
  return static_cast<int>(cudaErrorInvalidValue);
#undef NORM_LAUNCH
}

}  // namespace

// Largest row the kernel takes: 512 lanes of 16 vectors (f32).
extern "C" int norm_max_d() { return 32768; }

// x: rows x d with rows x_stride elements apart (the last dim contiguous);
// delta, res, y: rows x d contiguous (delta and res null without the
// residual add); scale, bias: d values (bias null for RMSNorm).  x_bf16
// selects the activations' dtype (bf16 or f32), p_bf16 the parameters'.
// Every pointer and x_stride * element size must be 16-byte aligned, and
// d a multiple of 16 bytes' worth of elements (the wrapper checks).
extern "C" int norm_launch(const void* x, long long x_stride, const void* delta, void* res,
                           void* y, const void* scale, const void* bias, int rows, int d,
                           float eps, int layernorm, int x_bf16, int p_bf16, void* stream) {
  if (rows <= 0) return 0;
  if (d < 1 || d > norm_max_d()) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    return p_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s)
                  : dispatch<__nv_bfloat16, float>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s);
  }
  if (d % 4) return static_cast<int>(cudaErrorInvalidValue);
  return p_bf16 ? dispatch<float, __nv_bfloat16>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s)
                : dispatch<float, float>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s);
}
