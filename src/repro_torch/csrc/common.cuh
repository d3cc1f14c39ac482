// Helpers shared by the port's CUDA kernels (no PyTorch headers: every
// source is built alone by nvcc into a library with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One 16-byte read-only global load, kept raw: 4 f32 or 8 bf16 values.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Widen 16 raw bytes to float: 4 f32 or 8 bf16 values (a bf16 is the high
// half of the f32 with the same bits, so widening is a shift).
template <typename T> __device__ __forceinline__ void unpack16(const uint4& v, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One value widened to f32 (exact for bf16), and an f32 rounded to T's
// precision and widened back: the value a plain chain stores and reloads
// when it writes an intermediate tensor in T (round to nearest even).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16 raw bytes from 4 f32 or 8 bf16 values, each f32 rounded to T (the
// inverse of unpack16).
template <typename T> __device__ __forceinline__ uint4 pack16(const float* f);
template <> __device__ __forceinline__ uint4 pack16<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// N values of type E (f32 or bf16) held raw as 32-bit words, loaded and
// stored as one vector (8 or 16 bytes) or two 16-byte vectors (32 bytes):
// 16 bytes of a row, or the matching parameters of another dtype.  The
// address must be aligned to the vector (8 or 16 bytes).
template <typename E, int N> struct Raw {
  static constexpr int W = N * static_cast<int>(sizeof(E)) / 4;
  static_assert(W == 2 || W == 4 || W == 8, "8, 16 or 32 bytes");
  unsigned w[W];

  __device__ __forceinline__ void load(const E* p) {
    if constexpr (W == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
        w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void store(E* p) const {
    if constexpr (W == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < W; i += 4)
        reinterpret_cast<uint4*>(p)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    }
  }
  // value j widened to f32 (a bf16 is the high half of the f32 with its bits)
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(E) == 4) return __uint_as_float(w[j]);
    else return __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
  }
  // the N values f, each rounded to E (round to nearest even)
  __device__ __forceinline__ void set(const float* f) {
    if constexpr (sizeof(E) == 4) {
#pragma unroll
      for (int j = 0; j < N; ++j) w[j] = __float_as_uint(f[j]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i)
        w[i] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
               (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))) << 16);
    }
  }
};

// Cross-block combine of a split grid.  Every thread of a block calls this
// after writing the block's partial result; it returns true, in every
// thread, in the last of the `n` blocks to arrive at `*counter`, and that
// block resets the counter to 0 for the next launch.  The last block then
// sees every other block's partials (read them with __ldcg, from L2: this
// SM's L1 may hold stale lines).  The order in which blocks arrive decides
// only which block combines, never the order in which partials are summed.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, unsigned n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == n - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K> inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
