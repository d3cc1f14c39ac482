// Per-head qk-norm, split-half RoPE and the decode step's K/V cache write,
// q and k in one launch, for Hopper: one block a token, one warp a head.
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
// cache rows written once (decode at qwen3-1.7b: ~16 KB); the launch
// bounds it at decode, bytes at the prefill's 1024 tokens (~10 MB).  The
// design aims at one launch instead of ~45: a warp takes a head, a lane the
// rotation pairs (j, j + dh/2) for j = lane, lane + 32, ... (at most 4, dh
// <= 256), so the qk-norm's sum is one warp shuffle reduction and the
// rotation needs no exchange between lanes.  Loads are 2-byte (bf16)
// scalars, neighbouring lanes on neighbouring values.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int WARPS = 8;
constexpr int MAX_PAIRS = 4;  // dh / 2 / 32 at dh 256

template <typename T, typename P>
__global__ void qk_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ q_out,
                               T* __restrict__ k_out, const P* __restrict__ q_scale,
                               const P* __restrict__ k_scale, const float* __restrict__ freqs,
                               const void* __restrict__ pos, int pos64, long long pos_sb,
                               long long pos_ss, T* __restrict__ k_cache,
                               T* __restrict__ v_cache, const int* __restrict__ slot,
                               int rows, int S, int H, int KV, int dh, float eps) {
  const int tok = blockIdx.x;  // b * S + s
  const int b = tok / S, s = tok - b * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = dh / 2;
  const bool transform = q_scale != nullptr || freqs != nullptr;
  const bool write = k_cache != nullptr;
  int row = 0;
  if (write) {
    row = slot[b];
    row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
  }
  float posf = 0.f;
  if (freqs != nullptr) {
    const long long off = b * pos_sb + s * pos_ss;
    posf = pos64 ? __ll2float_rn(static_cast<const long long*>(pos)[off])
                 : __int2float_rn(static_cast<const int*>(pos)[off]);
  }
  // heads: H of q (transformed), KV of k (transformed, then cached), and
  // with the caches KV of v (cached as they are)
  const int n_heads = (transform ? H : 0) + KV + (write ? KV : 0);
  for (int hh = warp; hh < n_heads; hh += WARPS) {
    int h = transform ? hh : hh + H;  // h < H: q; h < H + KV: k; else v
    const bool is_q = h < H, is_k = !is_q && h < H + KV;
    const int head = is_q ? h : (is_k ? h - H : h - H - KV);
    const int nh = is_q ? H : KV;
    const long long base = (static_cast<long long>(tok) * nh + head) * dh;
    const T* src = is_q ? q : (is_k ? k : v);
    const long long cbase = ((static_cast<long long>(b) * rows + row) * KV + head) * dh;
    if (!is_q && !is_k) {  // v: copied into its cache row
      for (int j = lane; j < dh; j += 32) v_cache[cbase + j] = src[base + j];
      continue;
    }
    // lane's pairs (j, j + half), j = lane + 32 i; unrolled, so they stay
    // in registers
    float x1[MAX_PAIRS], x2[MAX_PAIRS];
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int j = lane + 32 * i;
      x1[i] = j < half ? to_f(src[base + j]) : 0.f;
      x2[i] = j < half ? to_f(src[base + j + half]) : 0.f;
    }
    const P* scale = is_q ? q_scale : k_scale;
    if (scale != nullptr) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_PAIRS; ++i)
        if (lane + 32 * i < half)
          acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(x1[i], x1[i])), __fmul_rn(x2[i], x2[i]));
      const float var = __fmul_rn(warp_sum(acc), 1.0f / static_cast<float>(dh));
      const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
      for (int i = 0; i < MAX_PAIRS; ++i) {
        const int j = lane + 32 * i;
        if (j < half) {
          x1[i] = round_to<T>(__fmul_rn(__fmul_rn(x1[i], rs), to_f(scale[j])));
          x2[i] = round_to<T>(__fmul_rn(__fmul_rn(x2[i], rs), to_f(scale[j + half])));
        }
      }
    }
    if (freqs != nullptr) {
#pragma unroll
      for (int i = 0; i < MAX_PAIRS; ++i) {
        const int j = lane + 32 * i;
        if (j < half) {
          const float a = __fmul_rn(posf, freqs[j]);
          const float c = cosf(a), sn = sinf(a);
          const float o1 = __fsub_rn(__fmul_rn(x1[i], c), __fmul_rn(x2[i], sn));
          const float o2 = __fadd_rn(__fmul_rn(x2[i], c), __fmul_rn(x1[i], sn));
          x1[i] = round_to<T>(o1);
          x2[i] = round_to<T>(o2);
        }
      }
    }
    T* dst = transform ? (is_q ? q_out : k_out) : nullptr;
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int j = lane + 32 * i;
      if (j >= half) continue;
      const T a = from_f<T>(x1[i]), c = from_f<T>(x2[i]);
      if (dst != nullptr) {
        dst[base + j] = a;
        dst[base + j + half] = c;
      }
      if (is_k && write) {
        k_cache[cbase + j] = a;
        k_cache[cbase + j + half] = c;
      }
    }
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k, const void* v, void* q_out, void* k_out,
           const void* q_scale, const void* k_scale, const float* freqs, const void* pos,
           int pos64, long long pos_sb, long long pos_ss, void* k_cache, void* v_cache,
           const int* slot, int rows, int B, int S, int H, int KV, int dh, float eps,
           cudaStream_t st) {
  qk_rope_kernel<T, P><<<B * S, WARPS * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(q_out), static_cast<T*>(k_out), static_cast<const P*>(q_scale),
      static_cast<const P*>(k_scale), freqs, pos, pos64, pos_sb, pos_ss,
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), slot, rows, S, H, KV, dh, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qk_rope_max_dh() { return 2 * 32 * MAX_PAIRS; }

// q: (B, S, H, dh), k and v: (B, S, KV, dh), contiguous; q_out, k_out of
// q's and k's shapes (null without qk-norm and RoPE: then only the caches
// are written).  q_scale, k_scale: dh values each (null: no qk-norm);
// freqs: dh/2 f32 (null: no RoPE); pos: int32 or int64 (pos64) positions
// at pos[b * pos_sb + s * pos_ss].  k_cache, v_cache: (B, rows, KV, dh),
// contiguous, written at row clamp(slot[b], 0, rows - 1) (null: no write;
// then v is not read), which needs S = 1.  x_bf16 selects the activations'
// dtype (bf16 or f32), p_bf16 the scales'.
extern "C" int qk_rope_launch(const void* q, const void* k, const void* v, void* q_out,
                              void* k_out, const void* q_scale, const void* k_scale,
                              const void* freqs, const void* pos, int pos64, long long pos_sb,
                              long long pos_ss, void* k_cache, void* v_cache, const void* slot,
                              int rows, int B, int S, int H, int KV, int dh, float eps,
                              int x_bf16, int p_bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dh < 2 || dh % 2 || dh > qk_rope_max_dh() || H < 1 || KV < 1 ||
      (k_cache != nullptr && (S != 1 || rows < 1 || v_cache == nullptr || slot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(freqs);
  const int* sl = static_cast<const int*>(slot);
  if (x_bf16)
    return p_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, q_out, k_out, q_scale, k_scale, f, pos, pos64, pos_sb, pos_ss, k_cache, v_cache, sl, rows, B, S, H, KV, dh, eps, st)
                  : launch<__nv_bfloat16, float>(q, k, v, q_out, k_out, q_scale, k_scale, f, pos, pos64, pos_sb, pos_ss, k_cache, v_cache, sl, rows, B, S, H, KV, dh, eps, st);
  return p_bf16 ? launch<float, __nv_bfloat16>(q, k, v, q_out, k_out, q_scale, k_scale, f, pos, pos64, pos_sb, pos_ss, k_cache, v_cache, sl, rows, B, S, H, KV, dh, eps, st)
                : launch<float, float>(q, k, v, q_out, k_out, q_scale, k_scale, f, pos, pos64, pos_sb, pos_ss, k_cache, v_cache, sl, rows, B, S, H, KV, dh, eps, st);
}
