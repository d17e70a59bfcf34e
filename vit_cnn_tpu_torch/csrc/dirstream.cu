// K2 and K3: the directional-stream pair of the multi-directional Mamba
// layer, lane-major layout ((L, d, b) with b innermost).
//
// K2 `dir_conv_silu` replaces the Pallas TPU kernel
// vit_cnn_tpu/ops/dirstream.py `_dir_conv_kernel` (launched by
// `_dir_conv_forward`). For each static token order o it gathers the rows
// u[order_o[t]] and applies the depthwise k-tap conv, bias and SiLU:
//   forward stream  fwd[o, t] = silu(cb + sum_j cw[j] * pu[t - (k-1-j)])
//   reverse stream  rev[r, t] = silu(cb + sum_j cw[j] * pu[t + (k-1-j)])
// with zeros outside [0, L). Reverse streams exist for the orders listed
// in rev_rows, in that order.
//
// K3 `inv_perm_weighted_sum` replaces `_inv_sum_kernel` (launched by
// `_inv_sum_forward`):
//   out[t] = sum_i wf[i] * yf[i][inv_i[t]] + sum_j wr[j] * yr[j][inv_{rev_rows[j]}[t]]
// accumulated in float32.
//
// What bounds them on the H100: both are pure data movement with a few
// FLOPs per byte. K2 reads u once and writes nb + nr streams, K3 reads
// nb + nr streams and writes one; at the serving shapes (L, d) = (81, 72)
// and (49, 128) with 6 + 4 streams that is about 11 tensors of
// L * d * b elements each, so both are memory bound.
//
// Design: one thread per (d, b) column, warps along b so that every row
// access is a coalesced 64- or 128-byte segment, whatever the gathered
// token index. K2 stages its block's whole (L, 4, 32) tile of u in shared
// memory once (float32) and reads the k taps of every order from there,
// so u crosses the memory bus once for all 10 streams. K3 reads each
// input row exactly once (the orders are permutations). The order tables
// and weights are small int32 / float32 device tensors; the ragged batch
// edge is masked in the kernels, with no padding.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;      // sequences per block
constexpr int kConvRows = 4;    // channels per block in K2 (bounds its smem)
constexpr int kSumRows = 8;     // channels per block in K3
constexpr int kMaxTaps = 8;

template <typename T>
__global__ void __launch_bounds__(kLanes * kConvRows)
dir_conv_silu_kernel(const T* __restrict__ u, const float* __restrict__ cw,
                     const float* __restrict__ cb,
                     const int* __restrict__ orders,
                     const int* __restrict__ rev_rows,
                     T* __restrict__ fwd, T* __restrict__ rev,
                     int L, int d, int b, int nb, int nr, int k) {
  extern __shared__ float smem[];
  float* su = smem;                                         // [L][rows][lanes]
  int* sord = reinterpret_cast<int*>(su + L * kConvRows * kLanes);  // [nb][L]

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int bi = blockIdx.x * kLanes + lane;
  const int di = blockIdx.y * kConvRows + row;
  const int tid = row * kLanes + lane;
  const size_t seq = static_cast<size_t>(d) * b;

  for (int idx = tid; idx < nb * L; idx += kLanes * kConvRows)
    sord[idx] = orders[idx];
  for (int idx = tid; idx < L * kConvRows * kLanes; idx += kLanes * kConvRows) {
    const int l = idx % kLanes;
    const int r = (idx / kLanes) % kConvRows;
    const int t = idx / (kLanes * kConvRows);
    const int bb = blockIdx.x * kLanes + l;
    const int dd = blockIdx.y * kConvRows + r;
    su[idx] = (bb < b && dd < d)
                  ? vct::to_f32(u[t * seq + static_cast<size_t>(dd) * b + bb])
                  : 0.f;
  }
  __syncthreads();
  if (bi >= b || di >= d) return;

  float w[kMaxTaps];
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) w[j] = j < k ? cw[j * d + di] : 0.f;
  const float bias = cb[di];
  const size_t col = static_cast<size_t>(di) * b + bi;
  const float* mine = su + row * kLanes + lane;            // stride rows*lanes per t
  const int tstride = kConvRows * kLanes;

  for (int o = 0; o < nb; ++o) {
    const int* ord = sord + o * L;
    int slot = -1;
    for (int j = 0; j < nr; ++j)
      if (rev_rows[j] == o) slot = j;
    T* out_f = fwd + static_cast<size_t>(o) * L * seq;
    for (int t = 0; t < L; ++t) {
      float acc = bias;
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j) {
        const int src = t - (k - 1 - j);
        if (j < k && src >= 0) acc += w[j] * mine[ord[src] * tstride];
      }
      out_f[t * seq + col] = vct::from_f32<T>(acc / (1.f + expf(-acc)));
    }
    if (slot < 0) continue;
    T* out_r = rev + static_cast<size_t>(slot) * L * seq;
    for (int t = 0; t < L; ++t) {
      float acc = bias;
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j) {
        const int src = t + (k - 1 - j);
        if (j < k && src < L) acc += w[j] * mine[ord[src] * tstride];
      }
      out_r[t * seq + col] = vct::from_f32<T>(acc / (1.f + expf(-acc)));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kSumRows)
inv_perm_weighted_sum_kernel(const T* __restrict__ yf,
                             const T* __restrict__ yr,
                             const float* __restrict__ wf,
                             const float* __restrict__ wr,
                             const int* __restrict__ inv,
                             const int* __restrict__ rev_rows,
                             T* __restrict__ out, int L, int d, int b,
                             int nb, int nr) {
  extern __shared__ int sinv[];   // [nb][L] inverse orders, then [nr] rows
  int* srows = sinv + nb * L;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int idx = tid; idx < nb * L; idx += kLanes * kSumRows) sinv[idx] = inv[idx];
  for (int idx = tid; idx < nr; idx += kLanes * kSumRows) srows[idx] = rev_rows[idx];
  __syncthreads();

  const int bi = blockIdx.x * kLanes + threadIdx.x;
  const int di = blockIdx.y * kSumRows + threadIdx.y;
  if (bi >= b || di >= d) return;
  const size_t seq = static_cast<size_t>(d) * b;
  const size_t col = static_cast<size_t>(di) * b + bi;
  const size_t stream = static_cast<size_t>(L) * seq;

  for (int t = 0; t < L; ++t) {
    float acc = 0.f;
    for (int i = 0; i < nb; ++i)
      acc += wf[i] * vct::to_f32(yf[i * stream + sinv[i * L + t] * seq + col]);
    for (int j = 0; j < nr; ++j)
      acc += wr[j] *
             vct::to_f32(yr[j * stream + sinv[srows[j] * L + t] * seq + col]);
    out[t * seq + col] = vct::from_f32<T>(acc);
  }
}

}  // namespace

extern "C" int vct_dir_conv_silu(int dtype, const void* u, const float* cw,
                                 const float* cb, const int* orders,
                                 const int* rev_rows, void* fwd, void* rev,
                                 int L, int d, int b, int nb, int nr, int k,
                                 void* stream) {
  if (k < 1 || k > kMaxTaps || nb < 1 || nr < 0 || nr > nb ||
      (d + kConvRows - 1) / kConvRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0 || d == 0 || b == 0) return 0;
  const size_t smem = sizeof(float) * L * kConvRows * kLanes + sizeof(int) * nb * L;
  dim3 block(kLanes, kConvRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kConvRows - 1) / kConvRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vct::kF32) {
    err = vct::allow_smem(dir_conv_silu_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dir_conv_silu_kernel<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(u), cw, cb, orders, rev_rows,
        static_cast<float*>(fwd), static_cast<float*>(rev), L, d, b, nb, nr, k);
  } else if (dtype == vct::kBF16) {
    err = vct::allow_smem(dir_conv_silu_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dir_conv_silu_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(u), cw, cb, orders, rev_rows,
        static_cast<__nv_bfloat16*>(fwd), static_cast<__nv_bfloat16*>(rev),
        L, d, b, nb, nr, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vct_inv_perm_weighted_sum(int dtype, const void* yf,
                                         const void* yr, const float* wf,
                                         const float* wr, const int* inv,
                                         const int* rev_rows, void* out,
                                         int L, int d, int b, int nb, int nr,
                                         void* stream) {
  if (nb < 1 || nr < 0 || nr > nb || (d + kSumRows - 1) / kSumRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0 || d == 0 || b == 0) return 0;
  const size_t smem = sizeof(int) * (nb * L + nr);
  dim3 block(kLanes, kSumRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kSumRows - 1) / kSumRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vct::kF32) {
    err = vct::allow_smem(inv_perm_weighted_sum_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    inv_perm_weighted_sum_kernel<float><<<grid, block, smem, st>>>(
        static_cast<const float*>(yf), static_cast<const float*>(yr), wf, wr,
        inv, rev_rows, static_cast<float*>(out), L, d, b, nb, nr);
  } else if (dtype == vct::kBF16) {
    err = vct::allow_smem(inv_perm_weighted_sum_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    inv_perm_weighted_sum_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(yf),
        static_cast<const __nv_bfloat16*>(yr), wf, wr, inv, rev_rows,
        static_cast<__nv_bfloat16*>(out), L, d, b, nb, nr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
