// K4: small-sequence attention, softmax(q k^T * scale) v per group.
//
// Replaces the Pallas TPU kernel built by vit_cnn_tpu/ops/attention.py
// `_make_kernel` (launched by `_pallas_attention`). q is (G, Lq, dh), k and
// v are (G, Lk, dh), with G the folded batch (and heads). The flagship's
// NonLocal block calls it at (Lq, Lk, dh) = (49, 9, 128) and (25, 4, 72)
// with scale 1.0 and G = windows per band.
//
// What bounds it on the H100: per group it reads Lq*dh + 2*Lk*dh values
// and writes Lq*dh, and does 4*Lq*Lk*dh FLOPs: about 7.6 FLOPs per byte
// in bf16 at the larger shape, far below the tensor cores' ~295 and below
// even the CUDA cores' float32 ridge (67e12 / 3.35e12 = 20), so it is
// memory bound once the scores stay on chip. The scores never leave the
// SM.
//
// Design: a block of 4 warps walks over groups (grid-stride, which also
// masks the ragged G). Per group it stages k and v in shared memory as
// float32 (Lk <= 64, dh <= 256). Each warp takes one query row at a time:
// lanes hold the row's dh values in registers, every score is a warp
// reduction in float32, the softmax subtracts the row max, and the P.V
// product writes the row back coalesced, in q's dtype.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxLk = 64;
constexpr int kMaxDh = 256;
constexpr int kPerLane = kMaxDh / 32;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int G, int Lq,
                 int Lk, int dh, float scale) {
  extern __shared__ float smem[];
  float* sk = smem;                    // [Lk][dh]
  float* sv = sk + Lk * dh;            // [Lk][dh]
  float* sp = sv + Lk * dh;            // [warps][kMaxLk] scores, then probs
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* myp = sp + warp * kMaxLk;

  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    __syncthreads();                   // previous group's k/v reads done
    const size_t kv0 = static_cast<size_t>(g) * Lk * dh;
    for (int idx = threadIdx.x; idx < Lk * dh; idx += 32 * kWarps) {
      sk[idx] = vct::to_f32(k[kv0 + idx]);
      sv[idx] = vct::to_f32(v[kv0 + idx]);
    }
    __syncthreads();

    for (int r = warp; r < Lq; r += kWarps) {
      const size_t q0 = (static_cast<size_t>(g) * Lq + r) * dh;
      float qv[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + 32 * i;
        qv[i] = c < dh ? vct::to_f32(q[q0 + c]) : 0.f;
      }
      for (int j = 0; j < Lk; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < dh) part += qv[i] * sk[j * dh + c];
        }
        part = vct::warp_sum(part);
        if (lane == 0) myp[j] = part * scale;
      }
      __syncwarp();
      const float s0 = lane < Lk ? myp[lane] : -INFINITY;
      const float s1 = lane + 32 < Lk ? myp[lane + 32] : -INFINITY;
      const float m = vct::warp_max(fmaxf(s0, s1));
      const float e0 = lane < Lk ? expf(s0 - m) : 0.f;
      const float e1 = lane + 32 < Lk ? expf(s1 - m) : 0.f;
      const float sum = vct::warp_sum(e0 + e1);
      __syncwarp();
      if (lane < Lk) myp[lane] = e0 / sum;
      if (lane + 32 < Lk) myp[lane + 32] = e1 / sum;
      __syncwarp();
      for (int c = lane; c < dh; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < Lk; ++j) acc += myp[j] * sv[j * dh + c];
        o[q0 + c] = vct::from_f32<T>(acc);
      }
      __syncwarp();                    // probs read before the next row
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int G,
           int Lq, int Lk, int dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * Lk * dh + kWarps * kMaxLk);
  cudaError_t err = vct::allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = G < 65535 ? G : 65535;
  attention_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), G, Lq, Lk, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vct_attention(int dtype, const void* q, const void* k,
                             const void* v, void* o, int G, int Lq, int Lk,
                             int dh, float scale, void* stream) {
  if (Lk < 1 || Lk > kMaxLk || dh < 1 || dh > kMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || Lq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return launch<float>(q, k, v, o, G, Lq, Lk, dh, scale, st);
  if (dtype == vct::kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, G, Lq, Lk, dh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
