// Single-token GQA decode attention for Hopper.
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
// 0 gives zeros, as acc / max(l, 1e-30) does in the TPU kernel.
//
// What bounds it on the H100: it must read sum_b lengths[b] * KV * dh
// elements of K and of V once; the FLOPs are 4 * G per element pair, so at
// G = 2 it is bound by memory: bytes / 3.35 TB/s.
//
// Design: one block (4 warps) per (b, kv head), holding that head's G query
// heads, so each K/V row is read from device memory once for all G heads.
// The sequential KV-tile grid axis of the TPU kernel becomes a loop inside
// the block, over 32-row tiles up to lengths[b] only.  Tiles are copied
// with 16-byte cp.async into a two-stage shared-memory ring, so the next
// tile is in flight while the current one is computed.  Per tile: a warp
// per cache row computes the G scores (lanes split dh), a warp per query
// head updates (m, l) and turns scores into probabilities, then every
// thread updates its (g, e) accumulators from the V tile.  G is taken as it
// is (no padding) and S need not be a multiple of the tile.
// With B*KV blocks (64 at 8 slots of qwen3-1.7b) the card runs underfilled;
// splitting the cache across blocks (split-K) is left to a later change.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int NT = 128;  // threads per block
constexpr int TT = 32;   // cache rows per tile (one per lane in the softmax)
constexpr int MAX_DH = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int S, int KV, int G, int dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);  // [2][TT][dh]
  T* vbuf = kbuf + 2 * TT * dh;              // [2][TT][dh]
  float* q_s = reinterpret_cast<float*>(vbuf + 2 * TT * dh);  // [G][dh], scaled
  float* acc_s = q_s + G * dh;               // [G][dh]
  float* p_s = acc_s + G * dh;               // [G][TT] scores, then probabilities
  float* m_s = p_s + G * TT;                 // [G] running max
  float* l_s = m_s + G;                      // [G] running denominator
  float* a_s = l_s + G;                      // [G] rescale of this tile

  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(lengths[b], S));
  const size_t head0 = ((size_t)b * KV + h) * G * dh;  // q/out offset of head h*G

  for (int i = tid; i < G * dh; i += NT) {
    q_s[i] = to_f(q[head0 + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < G; i += NT) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  const size_t row_stride = (size_t)KV * dh;  // elements between cache rows
  const T* kb = k + (size_t)b * S * row_stride + (size_t)h * dh;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)h * dh;
  const int vec_per_row = dh * (int)sizeof(T) / 16;
  const int ntiles = (len + TT - 1) / TT;

  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * TT, n = min(TT, len - t0);
    for (int i = tid; i < n * vec_per_row; i += NT) {
      const int r = i / vec_per_row, c = i - r * vec_per_row;
      const size_t src = (size_t)(t0 + r) * row_stride;
      const int dst = (stage * TT + r) * dh;
      cp_async16(reinterpret_cast<char*>(kbuf + dst) + 16 * c,
                 reinterpret_cast<const char*>(kb + src) + 16 * c);
      cp_async16(reinterpret_cast<char*>(vbuf + dst) + 16 * c,
                 reinterpret_cast<const char*>(vb + src) + 16 * c);
    }
    cp_async_commit();
  };

  if (ntiles > 0) load_tile(0, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_tile(j + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(TT, len - j * TT);
    const T* kt = kbuf + st * TT * dh;
    const T* vt = vbuf + st * TT * dh;

    // scores: a warp per cache row, lanes split dh
    for (int r = warp; r < n; r += NT / 32) {
      float kr[MAX_DH / 32];
#pragma unroll
      for (int i = 0; i < MAX_DH / 32; ++i) {
        const int e = lane + 32 * i;
        kr[i] = e < dh ? to_f(kt[r * dh + e]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_DH / 32; ++i) {
          const int e = lane + 32 * i;
          if (e < dh) s += kr[i] * q_s[g * dh + e];
        }
        s = warp_sum(s);
        if (lane == 0) p_s[g * TT + r] = s;
      }
    }
    __syncthreads();

    // online softmax: a warp per query head, a lane per cache row
    for (int g = warp; g < G; g += NT / 32) {
      const float s = lane < n ? p_s[g * TT + lane] : -INFINITY;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));  // finite: n >= 1
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[g * TT + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V, a thread per (g, e)
    for (int i = tid; i < G * dh; i += NT) {
      const int g = i / dh, e = i - g * dh;
      const float* pg = p_s + g * TT;
      float a = acc_s[i] * a_s[g];
      for (int r = 0; r < n; ++r) a += pg[r] * to_f(vt[r * dh + e]);
      acc_s[i] = a;
    }
    __syncthreads();  // the stage read here is refilled by the next iteration
  }

  __syncthreads();
  for (int i = tid; i < G * dh; i += NT) {
    const float l = l_s[i / dh];
    out[head0 + i] = from_f<T>(acc_s[i] / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int B, int S, int KV, int G, int dh, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 4 * TT * dh + sizeof(float) * (2 * G * dh + G * TT + 3 * G);
  auto kernel = decode_attention_kernel<T>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B * KV, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, KV, G, dh,
      1.0f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, KV*G, dh), k/v (B, S, KV, dh), all f32 or all bf16; lengths (B,) i32
// -> out (B, KV*G, dh) in q's dtype.  Requires dh <= 256 and dh * sizeof(T)
// a multiple of 16, contiguous 16-byte aligned tensors (the Python wrapper
// checks).  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int S, int KV,
                                       int G, int dh, int bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  if (dh < 1 || dh > MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, KV, G, dh, s);
  return launch<float>(q, k, v, lengths, out, B, S, KV, G, dh, s);
}
