// Per-head qk-norm, split-half RoPE and the decode step's K/V cache write,
// q and k in one launch, for Hopper: a lane group a head, the heads of a
// token side by side.
//
// Has no Pallas counterpart.  It replaces the elementwise chains between
// the q/k/v projections and attention in the port's models/layers.py:
// rms_norm_headwise of q and of k (Qwen3's qk-norm), apply_rope of q and of
// k, and in decode both _scatter_time writes of the new K and V rows.  The
// JAX package writes them as jnp ops (src/repro/models/layers.py
// rms_norm_headwise, apply_rope, _scatter_time) and its jit hands them to
// XLA, which fuses them; the port launched ~45 kernels a layer for them.
//
// What it computes, for token (b, s) and each of its H query and KV key
// heads x (dh values, halves x1 = x[:dh/2], x2 = x[dh/2:]):
//   qk-norm (given scales): x <- round(x * rsqrt(mean(x^2) + eps) * scale)
//   RoPE (given a frequency table f, dh/2 values): with a = pos(b, s) * f,
//     out = round([x1 cos a - x2 sin a, x2 cos a + x1 sin a])
// where round is to the model dtype, as the plain chain stores each
// result; in decode (S = 1, given caches) it then writes the new K head
// and the V head at row clamp(slot[b], 0, rows - 1) of the caches, as
// _scatter_time clamps.  Without qk-norm and RoPE it only writes the
// caches.  Rounding follows the plain chain (kernels/qk_rope/ref.py) op
// for op: every f32 product, sum and difference is its own __fmul_rn /
// __fadd_rn / __fsub_rn, so x1 cos a - x2 sin a is never an fma; cosf,
// sinf and rsqrtf, never their fast forms; the table is the plain
// version's own rope_frequencies on the same device (the wrapper builds it
// once per (dh, theta, device)).  So RoPE and the cache writes equal the
// plain chain bit for bit; the qk-norm's sum over dh runs in another order
// than ATen's reduction, so it is within 1 ulp.
//
// What bounds it on the H100: q, k and v are read once and q, k and the
// cache rows written once (decode at qwen3-1.7b: ~16 KB); the launch and
// one chain of dependent steps bound it at decode, bytes at the prefill's
// 1024 tokens (~10 MB).  The design:
// * a group of G lanes takes a head (G = dh / 2 / V rounded up to a power
//   of two, V = 8 bf16 or 4 f32 values in 16 bytes): lane l holds the V
//   values x1[lV .. lV + V) and the matching V of x2 as two 16-byte
//   vectors, so a rotation pair lies in one lane and needs no exchange; at
//   dh 128 bf16 that is 8 lanes, 4 heads a warp, and every head of a token
//   (q, k, and v's copy) is loaded at once: one dependent round of loads,
//   not one a head;
// * the grid is tokens x groups of heads: a token's heads in one block at
//   prefill; at decode (few tokens) one warp a block, so the 8 tokens of a
//   decode step spread over 64 SMs instead of 8;
// * the token's cosf / sinf of pos * f[j] are computed once a block into
//   shared memory (once a token at prefill, where a block holds its
//   heads), while the heads' loads are in flight, and read by every head;
// * the qk-norm's sum is a shuffle tree within the group;
// * v's copy into its cache row, the k row and q/k's outputs are 16-byte
//   stores; a head whose half is not a whole number of vectors (or an
//   unaligned tensor) takes the same layout with scalar accesses (VEC off).
// The qk-norm's sum, in the order tests/test_torch_fused_layout.py
// emulates: lane l adds x1[lV + e]^2 and then x2[lV + e]^2 for e = 0 ..
// V-1, from 0; the group's tree adds lane (l ^ o)'s partial for o = G/2,
// ..., 1.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int MAX_HALF = 128;  // dh <= 256

template <typename T, typename P, bool VEC>
__global__ void __launch_bounds__(512)
qk_rope_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ q_out, T* __restrict__ k_out, const P* __restrict__ q_scale,
               const P* __restrict__ k_scale, const float* __restrict__ freqs,
               const void* __restrict__ pos, int pos64, long long pos_sb, long long pos_ss,
               T* __restrict__ k_cache, T* __restrict__ v_cache, const int* __restrict__ slot,
               int rows, int S, int H, int KV, int dh, int G, float eps) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  __shared__ float cs[2][MAX_HALF];  // the token's cos a, sin a
  const int tok = blockIdx.x;        // b * S + s
  const int b = tok / S, s = tok - b * S;
  const int half = dh / 2;
  const int lane = threadIdx.x & (G - 1);
  const int hh = blockIdx.y * (blockDim.x / G) + threadIdx.x / G;
  const bool transform = q_scale != nullptr || freqs != nullptr;
  const bool write = k_cache != nullptr;
  // heads: H of q (transformed), KV of k (transformed, then cached), and
  // with the caches KV of v (cached as they are)
  const int n_heads = (transform ? H : 0) + KV + (write ? KV : 0);
  const int h = transform ? hh : hh + H;  // h < H: q; h < H + KV: k; else v
  const bool is_q = h < H, is_k = !is_q && h < H + KV;
  const int head = is_q ? h : (is_k ? h - H : h - H - KV);
  const long long base = (static_cast<long long>(tok) * (is_q ? H : KV) + head) * dh;
  const T* src = is_q ? q : (is_k ? k : v);
  const int j0 = lane * V;
  const bool mine = hh < n_heads && j0 < half;
  int row = 0;
  if (write) {
    row = slot[b];
    row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
  }
  const long long cbase = ((static_cast<long long>(b) * rows + row) * KV + head) * dh;

  // the lane's values of both halves: one round of loads for every head
  Raw<T, V> r1, r2;
  float x1[V], x2[V];
  if (mine) {
    if constexpr (VEC) {
      r1.load(src + base + j0);
      r2.load(src + base + half + j0);
#pragma unroll
      for (int e = 0; e < V; ++e) x1[e] = r1.get(e), x2[e] = r2.get(e);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool in = j0 + e < half;
        x1[e] = in ? to_f(src[base + j0 + e]) : 0.f;
        x2[e] = in ? to_f(src[base + half + j0 + e]) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x1[e] = x2[e] = 0.f;
  }
  const bool is_v = !is_q && !is_k;
  const P* scale = is_q ? q_scale : k_scale;
  Raw<P, V> sa, sb;  // the scales, loaded with the values
  if constexpr (VEC) {
    if (q_scale != nullptr && mine && !is_v) {
      sa.load(scale + j0);
      sb.load(scale + half + j0);
    }
  }
  // the token's angles, once a block, while the loads are in flight
  if (freqs != nullptr) {
    const long long off = b * pos_sb + s * pos_ss;
    const float posf = pos64 ? __ll2float_rn(static_cast<const long long*>(pos)[off])
                             : __int2float_rn(static_cast<const int*>(pos)[off]);
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const float a = __fmul_rn(posf, freqs[j]);
      cs[0][j] = cosf(a);
      cs[1][j] = sinf(a);
    }
    __syncthreads();
  }
  if (q_scale != nullptr) {  // every lane takes part in the group's tree
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e)
      acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(x1[e], x1[e])), __fmul_rn(x2[e], x2[e]));
    for (int o = G / 2; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(acc, 1.0f / static_cast<float>(dh)), eps));
    if (mine && !is_v) {
      float s1[V], s2[V];
      if constexpr (VEC) {
#pragma unroll
        for (int e = 0; e < V; ++e) s1[e] = sa.get(e), s2[e] = sb.get(e);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const bool in = j0 + e < half;
          s1[e] = in ? to_f(scale[j0 + e]) : 0.f;
          s2[e] = in ? to_f(scale[half + j0 + e]) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        x1[e] = round_to<T>(__fmul_rn(__fmul_rn(x1[e], rs), s1[e]));
        x2[e] = round_to<T>(__fmul_rn(__fmul_rn(x2[e], rs), s2[e]));
      }
    }
  }
  if (!mine) return;  // no shuffle below
  if (freqs != nullptr && !is_v) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (!VEC && j0 + e >= half) break;
      const float c = cs[0][j0 + e], sn = cs[1][j0 + e];
      const float o1 = __fsub_rn(__fmul_rn(x1[e], c), __fmul_rn(x2[e], sn));
      const float o2 = __fadd_rn(__fmul_rn(x2[e], c), __fmul_rn(x1[e], sn));
      x1[e] = round_to<T>(o1);
      x2[e] = round_to<T>(o2);
    }
  }
  T* dst = transform && !is_v ? (is_q ? q_out : k_out) : nullptr;
  T* cache = write ? (is_k ? k_cache : (is_v ? v_cache : nullptr)) : nullptr;
  if constexpr (VEC) {
    if (!is_v) {
      r1.set(x1);
      r2.set(x2);
    }
    if (dst != nullptr) {
      r1.store(dst + base + j0);
      r2.store(dst + base + half + j0);
    }
    if (cache != nullptr) {
      r1.store(cache + cbase + j0);
      r2.store(cache + cbase + half + j0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int j = j0 + e;
      if (j >= half) break;
      const T a = is_v ? src[base + j] : from_f<T>(x1[e]);
      const T c = is_v ? src[base + half + j] : from_f<T>(x2[e]);
      if (dst != nullptr) {
        dst[base + j] = a;
        dst[base + half + j] = c;
      }
      if (cache != nullptr) {
        cache[cbase + j] = a;
        cache[cbase + half + j] = c;
      }
    }
  }
}

template <typename T, typename P, bool VEC>
int launch(const void* q, const void* k, const void* v, void* q_out, void* k_out,
           const void* q_scale, const void* k_scale, const float* freqs, const void* pos,
           int pos64, long long pos_sb, long long pos_ss, void* k_cache, void* v_cache,
           const int* slot, int rows, int B, int S, int H, int KV, int dh, float eps,
           cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  int G = 1;
  while (G * V < dh / 2) G *= 2;
  const bool transform = q_scale != nullptr || freqs != nullptr;
  const int n_heads = (transform ? H : 0) + KV + (k_cache != nullptr ? KV : 0);
  const long long tokens = static_cast<long long>(B) * S;
  // a token's heads in one block (at most 512 threads), or, where the
  // tokens fill fewer than ~512 warps so, one warp a block
  const int warps = (n_heads * G + 31) / 32;
  int threads = 32 * (warps < 16 ? warps : 16);
  if (tokens * warps < 512) threads = 32;
  const int per_block = threads / G;
  const dim3 grid(static_cast<unsigned>(tokens), (n_heads + per_block - 1) / per_block);
  qk_rope_kernel<T, P, VEC><<<grid, threads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(q_out), static_cast<T*>(k_out), static_cast<const P*>(q_scale),
      static_cast<const P*>(k_scale), freqs, pos, pos64, pos_sb, pos_ss,
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), slot, rows, S, H, KV, dh, G, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qk_rope_max_dh() { return 2 * MAX_HALF; }

// q: (B, S, H, dh), k and v: (B, S, KV, dh), contiguous; q_out, k_out of
// q's and k's shapes (null without qk-norm and RoPE: then only the caches
// are written).  q_scale, k_scale: dh values each (null: no qk-norm);
// freqs: dh/2 f32 (null: no RoPE); pos: int32 or int64 (pos64) positions
// at pos[b * pos_sb + s * pos_ss].  k_cache, v_cache: (B, rows, KV, dh),
// contiguous, written at row clamp(slot[b], 0, rows - 1) (null: no write;
// then v is not read), which needs S = 1.  x_bf16 selects the activations'
// dtype (bf16 or f32), p_bf16 the scales'.  vec: every tensor 16-byte
// aligned and dh / 2 a multiple of 16 bytes' worth of values (16-byte
// accesses; else scalar ones).
extern "C" int qk_rope_launch(const void* q, const void* k, const void* v, void* q_out,
                              void* k_out, const void* q_scale, const void* k_scale,
                              const void* freqs, const void* pos, int pos64, long long pos_sb,
                              long long pos_ss, void* k_cache, void* v_cache, const void* slot,
                              int rows, int B, int S, int H, int KV, int dh, float eps,
                              int x_bf16, int p_bf16, int vec, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dh < 2 || dh % 2 || dh > qk_rope_max_dh() || H < 1 || KV < 1 ||
      (k_cache != nullptr && (S != 1 || rows < 1 || v_cache == nullptr || slot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(freqs);
  const int* sl = static_cast<const int*>(slot);
#define QK_LAUNCH(T, P) \
  return vec ? launch<T, P, true>(q, k, v, q_out, k_out, q_scale, k_scale, f, pos, pos64, pos_sb, pos_ss, k_cache, v_cache, sl, rows, B, S, H, KV, dh, eps, st) \
             : launch<T, P, false>(q, k, v, q_out, k_out, q_scale, k_scale, f, pos, pos64, pos_sb, pos_ss, k_cache, v_cache, sl, rows, B, S, H, KV, dh, eps, st)
  if (x_bf16) {
    if (p_bf16) QK_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    QK_LAUNCH(__nv_bfloat16, float);
  }
  if (p_bf16) QK_LAUNCH(float, __nv_bfloat16);
  QK_LAUNCH(float, float);
#undef QK_LAUNCH
}
