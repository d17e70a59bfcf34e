// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 activations and does its
// arithmetic in float32. bf16 values are converted only through the
// cuda_bf16.h intrinsics (__bfloat162float, __float2bfloat16 rounds to
// nearest even), so the sources also build under the -D__CUDA_NO_*
// conversion guards that torch.utils.cpp_extension sets.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace vct {

// dtype codes shared with the Python wrappers (ops/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// 48 KB default (the H100 grants up to 227 KB to one block).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

namespace {

// Second pass of the backward kernels' cross-block reductions:
//   out[c][j] = sum_{p < parts} part[c][p][j]
// one thread per (c, j), partials summed in a fixed order, so the result
// does not depend on the order in which the first pass's blocks ran (no
// atomics anywhere).
template <typename Tout>
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    Tout* __restrict__ out, int parts,
                                    long long m) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= m) return;
  const float* src = part + static_cast<size_t>(blockIdx.y) * parts * m + j;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += src[static_cast<size_t>(p) * m];
  out[static_cast<size_t>(blockIdx.y) * m + j] = from_f32<Tout>(acc);
}

template <typename Tout>
void sum_partials(const float* part, Tout* out, int batch, int parts,
                  long long m, cudaStream_t stream) {
  if (batch == 0 || m == 0) return;
  const int threads = 256;
  dim3 grid(static_cast<unsigned>((m + threads - 1) / threads), batch);
  sum_partials_kernel<Tout><<<grid, threads, 0, stream>>>(part, out, parts, m);
}

}  // namespace

}  // namespace vct
