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
#include <string.h>

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

// two neighbouring values of a dtype, as one 4- or 8-byte word
template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
  static __device__ __forceinline__ float2 unpack(float2 v) { return v; }
  static __device__ __forceinline__ float2 pack(float x, float y) {
    return make_float2(x, y);
  }
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 unpack(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ __nv_bfloat162 pack(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};

// 16 bytes of a dtype (8 bf16 or 4 float32 values) as one uint4 word: one
// 128-bit load or store, unpacked to or packed from float32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& w, float* x) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float2 two(unsigned int w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, sizeof(h));
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ unsigned int word(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    unsigned int w;
    memcpy(&w, &h, sizeof(w));
    return w;
  }
  static __device__ __forceinline__ void unpack(const uint4& w, float* x) {
    const float2 a = two(w.x), b = two(w.y), c = two(w.z), d = two(w.w);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    x[4] = c.x; x[5] = c.y; x[6] = d.x; x[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(word(x[0], x[1]), word(x[2], x[3]), word(x[4], x[5]),
                      word(x[6], x[7]));
  }
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 2^x by the special-function unit, denormals flushed: one MUFU op
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
