// Tensor-core helpers of the head-last attention kernels (K8 and K9 in
// heads_attention.cu, V3 in heads_variants.cu): mma.sync products with
// bf16 operands and float32 sums, ldmatrix fragment loads, cp.async copies
// and one tile of the online softmax. The fragment layouts are the PTX
// ISA's for m16n8k16 / m16n8k8: a lane l holds rows g = l / 4 and g + 8 of
// a 16-row tile and columns 2 t, 2 t + 1 (t = l % 4) of each 8 columns.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vct {

constexpr float kLog2e = 1.4426950408889634f;

// D += A . B for one m16n8k16 tile: A 16 x 16 bf16 (row), B 16 x 8 bf16
// (col), D 16 x 8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B for one m16n8k8 tile: A 16 x 8, B 8 x 8
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2],
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring bf16 values (the first at an even index)
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit, one MUFU.EX2 (exp2f under fast math;
// a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lanes 8 i .. 8 i + 7 give the 16-byte rows of matrix i; the
// lane receives row g, columns 2 t and 2 t + 1 of each matrix (.trans:
// rows 2 t and 2 t + 1 of column g). x2 reads the addresses of lanes 0-15.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One 16-key tile of the online softmax for the two rows (g, g + 8) a lane
// holds: s[half][e] are the raw scores of keys k0 + 8 half + 2 t + (e & 1)
// for row g + 8 (e >> 1). Scales them by scale_log2 (the softmax scale
// times log2 e, so that exp2 gives the exps), masks keys >= n with -inf,
// updates the maxima m (in that base-2 domain) and the lane's partial sums
// l, returns the factor each row's output sums must be scaled by in alpha,
// and P, rounded to bf16, as the A fragment of the P.V product. `upper`
// (warp-uniform) is false when rows g + 8 are all padding: their exps are
// skipped, as are those of keys k0 + 8.. when they are all padding. A row
// with no real key yet keeps m = -inf and p = 0 without a NaN.
__device__ __forceinline__ void softmax_tile(float (&s)[2][4], int k0, int n,
                                             bool upper, float scale_log2,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             uint32_t (&pa)[4]) {
  const int t = threadIdx.x & 3;
  const bool keys_hi = k0 + 8 < n;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * half + 2 * t + (e & 1);
      s[half][e] = key < n ? s[half][e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[half][e]);
    }
  float ref[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == 1 && !upper) {
      ref[r] = 0.f;
      alpha[r] = 1.f;
      continue;
    }
    mx[r] = quad_max(mx[r]);
    ref[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    alpha[r] = exp2_approx(m[r] - ref[r]);  // 0 on the first tile
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
  float p[2][4] = {};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 1 && !keys_hi) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((e >> 1) == 1 && !upper) continue;
      p[half][e] = exp2_approx(s[half][e] - ref[e >> 1]);
      l[e >> 1] += p[half][e];
    }
  }
  pa[0] = pack(p[0][0], p[0][1]);
  pa[1] = pack(p[0][2], p[0][3]);
  pa[2] = pack(p[1][0], p[1][1]);
  pa[3] = pack(p[1][2], p[1][3]);
}

}  // namespace vct
