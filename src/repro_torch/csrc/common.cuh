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

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024),
// returned in every thread.  `red` is 32 floats of shared memory.  The
// order of the additions is fixed by the thread layout, so two launches
// on one input give the same bits.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f);
}

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
