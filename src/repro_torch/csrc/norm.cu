// RMSNorm or LayerNorm over the last dim, with an optional residual add
// before it, for Hopper: one block a row.
//
// Has no Pallas counterpart.  It replaces the chain of elementwise ops of
// the port's models/layers.py apply_norm (and of rms_norm_headwise over a
// whole row, MLA's latent norms), and the residual add before a block's
// second norm (models/lm.py _apply_block), which the JAX package writes as
// jnp ops in src/repro/models/layers.py apply_norm and its jit hands to
// XLA, which fuses them into one kernel.  Run eagerly or replayed from a
// CUDA graph, the port launched ~8 kernels a call for the same work.
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
// What bounds it on the H100: a row is read once (twice with delta) and
// written once (twice): bytes / 3.35 TB/s at the prefill's 1024 x 2048
// rows (8 MB, ~2.5 us); at decode (8 rows) its launch.  The design aims at
// one launch instead of ~8, and at 16-byte accesses: a thread loads a
// 16-byte vector (8 bf16 or 4 f32 values) at a time, keeps the row in
// shared memory as f32 between its passes (d * 4 bytes), and the block
// sums with warp shuffles and one exchange through shared memory
// (common.cuh block_sum), in an order fixed by the thread layout.
#include "common.cuh"

using namespace repro_torch;

namespace {

template <typename T> __host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename P> __device__ __forceinline__ float param(const P* p, int i) {
  return to_f(p[i]);
}

template <typename T, typename P>
__global__ void norm_kernel(const T* __restrict__ x, long long x_stride,
                            const T* __restrict__ delta, T* __restrict__ res,
                            T* __restrict__ y, const P* __restrict__ scale,
                            const P* __restrict__ bias, int d, float inv_d, float eps,
                            int layernorm) {
  constexpr int V = vec_of<T>();
  extern __shared__ float row[];  // d floats: s, then (s - mu) for LayerNorm
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const T* xr = x + r * x_stride;
  const int nv = d / V;

  // pass 1: s = x (+ delta, rounded) into shared memory; sum s or s^2
  float acc = 0.f;
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    float v[V];
    unpack16<T>(ld16(xr + c * V), v);
    if (delta != nullptr) {
      float dv[V];
      unpack16<T>(ld16(delta + r * d + c * V), dv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = round_to<T>(__fadd_rn(v[j], dv[j]));
      *reinterpret_cast<uint4*>(res + r * d + c * V) = pack16<T>(v);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      row[c * V + j] = v[j];
      acc = __fadd_rn(acc, layernorm ? v[j] : __fmul_rn(v[j], v[j]));
    }
  }
  float var;
  if (layernorm) {
    const float mu = __fmul_rn(block_sum(acc, red), inv_d);
    acc = 0.f;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fsub_rn(row[c * V + j], mu);
        row[c * V + j] = t;  // only this thread reads its own entries
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    }
    var = __fmul_rn(block_sum(acc, red), inv_d);
  } else {
    var = __fmul_rn(block_sum(acc, red), inv_d);
  }
  const float rs = rsqrtf(__fadd_rn(var, eps));

  // pass 2: y = (row * rs) * scale (+ bias), rounded to T
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = c * V + j;
      o[j] = __fmul_rn(__fmul_rn(row[i], rs), param(scale, i));
      if (layernorm) o[j] = __fadd_rn(o[j], param(bias, i));
    }
    *reinterpret_cast<uint4*>(y + r * d + c * V) = pack16<T>(o);
  }
}

template <typename T, typename P>
int launch(const void* x, long long x_stride, const void* delta, void* res, void* y,
           const void* scale, const void* bias, int rows, int d, float eps, int layernorm,
           cudaStream_t s) {
  constexpr int V = vec_of<T>();
  const int nv = d / V;
  int threads = ((nv + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = norm_kernel<T, P>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<rows, threads, smem, s>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(delta), static_cast<T*>(res),
      static_cast<T*>(y), static_cast<const P*>(scale), static_cast<const P*>(bias), d,
      1.0f / static_cast<float>(d), eps, layernorm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest row the kernel takes: its f32 copy in shared memory.
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
    return p_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s)
                  : launch<__nv_bfloat16, float>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s);
  }
  if (d % 4) return static_cast<int>(cudaErrorInvalidValue);
  return p_bf16 ? launch<float, __nv_bfloat16>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s)
                : launch<float, float>(x, x_stride, delta, res, y, scale, bias, rows, d, eps, layernorm, s);
}
