// Gated activation of an FFN, act(a) * b, for Hopper: one pass over n
// elements.
//
// Has no Pallas counterpart.  It replaces the port's models/layers.py
// SwiGLU / GeGLU product _act(x @ w1) * (x @ w3) (apply_ffn, and the MoE
// experts' and shared experts' in apply_moe), which the JAX package writes
// as jnp ops (src/repro/models/layers.py apply_ffn, apply_moe) and its jit
// hands to XLA, which fuses the activation into the product; the port
// launched two kernels and wrote the activation's result between them.
//
// What it computes: out = round(round(act(a)) * b), act SiLU or GELU's
// tanh form (jax.nn.gelu's default), in f32 from a and b of one dtype (f32
// or bf16), where round is to that dtype: the plain chain stores the
// activation in it before the product.  Each activation is ATen's CUDA
// formula, op for op: SiLU a / (1 + expf(-a)) (an IEEE division);
// GELU 0.5 a (1 + tanhf(kBeta (a + kKappa a^3))), where ATen's own build
// contracts a + kKappa a^3 into one fma (nvcc's default --fmad=true), so
// this kernel writes that fma and keeps every other product and sum its own
// __fmul_rn / __fadd_rn; expf and tanhf, never their fast forms.  So it
// equals the plain chain on the card bit for bit.
//
// What bounds it on the H100: a and b are read once and out written once,
// 6 bytes an element in bf16: bytes / 3.35 TB/s (the prefill's 1024 x
// 6144: 38 MB, ~11 us); at decode (8 x 6144) its launch.  A thread takes
// 16-byte vectors (8 bf16 or 4 f32 values) in a grid-stride loop; the
// ragged tail, if any, goes element by element.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float silu(float a) {
  return __fdiv_rn(a, __fadd_rn(1.0f, expf(-a)));
}

__device__ __forceinline__ float gelu_tanh(float a) {
  // ATen's kBeta = M_SQRT2 * M_2_SQRTPI * 0.5 (in double, then float) and
  // kKappa = 0.044715f, the constants written out
  constexpr float kBeta =
      static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(a, a), a);
  const float inner = __fmul_rn(kBeta, __fmaf_rn(kKappa, cube, a));
  return __fmul_rn(__fmul_rn(0.5f, a), __fadd_rn(1.0f, tanhf(inner)));
}

template <typename T>
__device__ __forceinline__ float glu1(float a, float b, int gelu) {
  const float g = round_to<T>(gelu ? gelu_tanh(a) : silu(a));
  return __fmul_rn(g, b);
}

template <typename T>
__global__ void glu_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                           long long n, int gelu) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long nv = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long c = t0; c < nv; c += stride) {
    float av[V], bv[V], o[V];
    unpack16<T>(ld16(a + c * V), av);
    unpack16<T>(ld16(b + c * V), bv);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = glu1<T>(av[j], bv[j], gelu);
    *reinterpret_cast<uint4*>(out + c * V) = pack16<T>(o);
  }
  for (long long i = nv * V + t0; i < n; i += stride)
    out[i] = from_f<T>(glu1<T>(to_f(a[i]), to_f(b[i]), gelu));
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long n, int gelu, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  long long blocks = (n / V + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // a grid-stride loop past 16 blocks an SM
  glu_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: n contiguous values of one dtype (bf16 or f32: x_bf16), each
// 16-byte aligned; gelu selects GELU (tanh form) over SiLU.
extern "C" int glu_launch(const void* a, const void* b, void* out, long long n, int gelu,
                          int x_bf16, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(a, b, out, n, gelu, s)
                : launch<float>(a, b, out, n, gelu, s);
}
