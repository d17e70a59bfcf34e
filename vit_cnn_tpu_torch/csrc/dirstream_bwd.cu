// K6 and K7: the adjoints of the directional-stream pair (K2, K3),
// lane-major layout ((L, d, b) with b innermost).
//
// K6 `dir_conv_silu_bwd` replaces the Pallas TPU kernel
// vit_cnn_tpu/ops/dirstream.py `_dir_conv_adj_kernel` (launched by
// `_dir_conv_adjoint`). For every stream of K2 (the forward stream of each
// base order o, and the reverse stream of the orders in rev_rows) it
// recomputes the preactivation z = cb + sum_j cw[j] * pu[t -/+ (k-1-j)],
// pu = u[order_o], and with the stream's cotangent g takes
//   dz = g * sigmoid(z) * (1 + z * (1 - sigmoid(z)))
//   dcb += sum dz,   dcw[j] += sum_t dz[t] * pu[t -/+ (k-1-j)]
//   du[order_o[t -/+ (k-1-j)]] += cw[j] * dz[t]
// so both streams of an order add into one du.
//
// K7 `inv_perm_weighted_sum_bwd` replaces `_inv_sum_adj_kernel`
// (launched by `_inv_sum_adjoint`). K3 computes
// out[t] = sum_i w_i * y_i[inv_i[t]], so with out's cotangent g:
//   dy_i[inv_i[t]] = w_i * g[t],   dw_i = sum_{t,d,b} g[t] * y_i[inv_i[t]]
// (every row of dy_i is written once: inv_i is a permutation).
//
// What bounds them on the H100: both move data with a few FLOPs per byte.
// K6 reads u and the nb + nr stream cotangents and writes du; K7 reads g
// and the nb + nr streams and writes their cotangents: at the flagship's
// shapes 12 and 21 tensors of L * d * b elements, so both are memory
// bound.
//
// Design: one thread per (d, b) column, warps along b, so every row access
// is a coalesced segment whatever the gathered token. K6 keeps its block's
// (L, 4, 32) tile of u AND the column's du accumulator in shared memory
// (float32): each thread scatters only into its own column, so the
// scatter through the orders needs no atomics, and du is written once.
// K7 is a gather with a per-block reduction. K7 could have been a Triton
// kernel; it stays CUDA to share this file's build, its tables and the
// partial-sum pass with K6. The parameter gradients (dcw, dcb, dw) sum
// over b and t: each block reduces its lanes with warp shuffles into one
// float32 partial, and sum_partials adds the partials in a fixed order,
// so they are the same from run to run (no atomics).
#include "common.cuh"

namespace {

constexpr int kLanes = 32;       // sequences per block
constexpr int kConvRows = 4;     // channels per block in K6 (bounds its smem)
constexpr int kSumRows = 8;      // channels per block in K7
constexpr int kMaxTaps = 8;
constexpr int kMaxStreams = 16;  // nb + nr that K7 keeps in registers

template <typename T>
__global__ void __launch_bounds__(kLanes * kConvRows)
dir_conv_silu_bwd_kernel(const T* __restrict__ u,
                         const float* __restrict__ cw,
                         const float* __restrict__ cb,
                         const int* __restrict__ orders,
                         const int* __restrict__ rev_rows,
                         const T* __restrict__ gf, const T* __restrict__ gr,
                         T* __restrict__ du, float* __restrict__ pcw,
                         float* __restrict__ pcb, int L, int d, int b, int nb,
                         int nr, int k) {
  extern __shared__ float smem[];
  constexpr int kTile = kConvRows * kLanes;
  float* su = smem;                                     // [L][rows][lanes]
  float* sdu = su + L * kTile;                          // [L][rows][lanes]
  int* sord = reinterpret_cast<int*>(sdu + L * kTile);  // [nb][L]

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int bi = blockIdx.x * kLanes + lane;
  const int di = blockIdx.y * kConvRows + row;
  const int tid = row * kLanes + lane;
  const bool active = bi < b && di < d;
  const size_t seq = static_cast<size_t>(d) * b;
  const size_t col = static_cast<size_t>(di) * b + bi;

  for (int idx = tid; idx < nb * L; idx += kTile) sord[idx] = orders[idx];
  for (int idx = tid; idx < L * kTile; idx += kTile) {
    const int l = idx % kLanes;
    const int r = (idx / kLanes) % kConvRows;
    const int t = idx / kTile;
    const int bb = blockIdx.x * kLanes + l;
    const int dd = blockIdx.y * kConvRows + r;
    su[idx] = (bb < b && dd < d)
                  ? vct::to_f32(u[t * seq + static_cast<size_t>(dd) * b + bb])
                  : 0.f;
    sdu[idx] = 0.f;
  }
  __syncthreads();

  float w[kMaxTaps], acc_w[kMaxTaps];
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    w[j] = (j < k && di < d) ? cw[j * d + di] : 0.f;
    acc_w[j] = 0.f;
  }
  const float bias = di < d ? cb[di] : 0.f;
  float acc_b = 0.f;
  const float* mine = su + tid;      // column of this thread, stride kTile
  float* my_du = sdu + tid;

  for (int o = 0; o < nb; ++o) {
    const int* ord = sord + o * L;
    int slot = -1;
    for (int j = 0; j < nr; ++j)
      if (rev_rows[j] == o) slot = j;
    for (int pass = 0; pass < (slot >= 0 ? 2 : 1); ++pass) {
      const bool rv = pass == 1;
      const T* gs = rv ? gr + static_cast<size_t>(slot) * L * seq
                       : gf + static_cast<size_t>(o) * L * seq;
      for (int t = 0; t < L; ++t) {
        float z = bias;
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
          const int src = rv ? t + (k - 1 - j) : t - (k - 1 - j);
          if (j < k && src >= 0 && src < L) z += w[j] * mine[ord[src] * kTile];
        }
        const float gv = active ? vct::to_f32(gs[t * seq + col]) : 0.f;
        const float sig = 1.f / (1.f + expf(-z));
        const float dz = gv * sig * (1.f + z * (1.f - sig));
        acc_b += dz;
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
          const int src = rv ? t + (k - 1 - j) : t - (k - 1 - j);
          if (j < k && src >= 0 && src < L) {
            const int p = ord[src] * kTile;
            acc_w[j] += dz * mine[p];
            my_du[p] += w[j] * dz;
          }
        }
      }
    }
  }
  if (active)
    for (int t = 0; t < L; ++t)
      du[t * seq + col] = vct::from_f32<T>(my_du[t * kTile]);

  // dcw, dcb: one partial per (block column, channel); a warp is a channel
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    const float v = vct::warp_sum(acc_w[j]);
    if (lane == 0 && di < d && j < k)
      pcw[(static_cast<size_t>(blockIdx.x) * k + j) * d + di] = v;
  }
  const float vb = vct::warp_sum(acc_b);
  if (lane == 0 && di < d) pcb[static_cast<size_t>(blockIdx.x) * d + di] = vb;
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kSumRows)
inv_perm_weighted_sum_bwd_kernel(const T* __restrict__ g,
                                 const T* __restrict__ yf,
                                 const T* __restrict__ yr,
                                 const float* __restrict__ wf,
                                 const float* __restrict__ wr,
                                 const int* __restrict__ inv,
                                 const int* __restrict__ rev_rows,
                                 T* __restrict__ dyf, T* __restrict__ dyr,
                                 float* __restrict__ pw, int L, int d, int b,
                                 int nb, int nr) {
  extern __shared__ int sinv[];   // [nb][L] inverse orders, then [nr] rows
  __shared__ float sw[kSumRows][kMaxStreams];
  int* srows = sinv + nb * L;
  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * kLanes + lane;
  for (int idx = tid; idx < nb * L; idx += kLanes * kSumRows) sinv[idx] = inv[idx];
  for (int idx = tid; idx < nr; idx += kLanes * kSumRows) srows[idx] = rev_rows[idx];
  __syncthreads();

  const int bi = blockIdx.x * kLanes + lane;
  const int di = blockIdx.y * kSumRows + row;
  const bool active = bi < b && di < d;
  const size_t seq = static_cast<size_t>(d) * b;
  const size_t col = static_cast<size_t>(di) * b + bi;
  const size_t stream = static_cast<size_t>(L) * seq;
  const int ns = nb + nr;

  float acc[kMaxStreams];
#pragma unroll
  for (int i = 0; i < kMaxStreams; ++i) acc[i] = 0.f;
  if (active) {
    for (int t = 0; t < L; ++t) {
      const float gv = vct::to_f32(g[t * seq + col]);
#pragma unroll
      for (int i = 0; i < kMaxStreams; ++i) {
        if (i < ns) {
          const bool rv = i >= nb;
          const int j = rv ? i - nb : i;
          const int p = sinv[(rv ? srows[j] : i) * L + t];
          const size_t at = j * stream + p * seq + col;
          const float yv = vct::to_f32(rv ? yr[at] : yf[at]);
          const T dy = vct::from_f32<T>((rv ? wr[j] : wf[j]) * gv);
          if (rv) dyr[at] = dy; else dyf[at] = dy;
          acc[i] += gv * yv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxStreams; ++i) {
    const float v = vct::warp_sum(acc[i]);
    if (lane == 0 && i < ns) sw[row][i] = v;
  }
  __syncthreads();
  if (tid < ns) {
    float tot = 0.f;
    for (int r = 0; r < kSumRows; ++r) tot += sw[r][tid];
    pw[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * ns + tid] = tot;
  }
}

template <typename T>
int launch_conv_bwd(const void* u, const float* cw, const float* cb,
                    const int* orders, const int* rev_rows, const void* gf,
                    const void* gr, void* du, float* dcw, float* dcb,
                    float* work, int L, int d, int b, int nb, int nr, int k,
                    cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * 2 * L * kConvRows * kLanes + sizeof(int) * nb * L;
  cudaError_t err = vct::allow_smem(dir_conv_silu_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kLanes, kConvRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kConvRows - 1) / kConvRows);
  float* pcw = work;
  float* pcb = work + static_cast<size_t>(grid.x) * k * d;
  dir_conv_silu_bwd_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), cw, cb, orders, rev_rows,
      static_cast<const T*>(gf), static_cast<const T*>(gr),
      static_cast<T*>(du), pcw, pcb, L, d, b, nb, nr, k);
  vct::sum_partials<float>(pcw, dcw, 1, grid.x, static_cast<long long>(k) * d,
                           stream);
  vct::sum_partials<float>(pcb, dcb, 1, grid.x, d, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sum_bwd(const void* g, const void* yf, const void* yr,
                   const float* wf, const float* wr, const int* inv,
                   const int* rev_rows, void* dyf, void* dyr, float* dw,
                   float* work, int L, int d, int b, int nb, int nr,
                   cudaStream_t stream) {
  const size_t smem = sizeof(int) * (nb * L + nr);
  cudaError_t err = vct::allow_smem(inv_perm_weighted_sum_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kLanes, kSumRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kSumRows - 1) / kSumRows);
  inv_perm_weighted_sum_bwd_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(yf),
      static_cast<const T*>(yr), wf, wr, inv, rev_rows, static_cast<T*>(dyf),
      static_cast<T*>(dyr), work, L, d, b, nb, nr);
  vct::sum_partials<float>(work, dw, 1, grid.x * grid.y, nb + nr, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 elements of the workspace vct_dir_conv_silu_bwd needs
extern "C" long long vct_dir_conv_silu_bwd_workspace(int d, int b, int k) {
  const long long bx = (b + kLanes - 1) / kLanes;
  return bx * (static_cast<long long>(k) + 1) * d;
}

extern "C" int vct_dir_conv_silu_bwd(int dtype, const void* u, const float* cw,
                                     const float* cb, const int* orders,
                                     const int* rev_rows, const void* gf,
                                     const void* gr, void* du, float* dcw,
                                     float* dcb, float* work, int L, int d,
                                     int b, int nb, int nr, int k,
                                     void* stream) {
  if (k < 1 || k > kMaxTaps || nb < 1 || nr < 0 || nr > nb ||
      (d + kConvRows - 1) / kConvRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 0 || d == 0 || b == 0) {
    cudaMemsetAsync(dcw, 0, sizeof(float) * k * d, st);
    cudaMemsetAsync(dcb, 0, sizeof(float) * d, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == vct::kF32)
    return launch_conv_bwd<float>(u, cw, cb, orders, rev_rows, gf, gr, du,
                                  dcw, dcb, work, L, d, b, nb, nr, k, st);
  if (dtype == vct::kBF16)
    return launch_conv_bwd<__nv_bfloat16>(u, cw, cb, orders, rev_rows, gf, gr,
                                          du, dcw, dcb, work, L, d, b, nb, nr,
                                          k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// float32 elements of the workspace vct_inv_perm_weighted_sum_bwd needs
extern "C" long long vct_inv_perm_weighted_sum_bwd_workspace(int d, int b,
                                                             int nb, int nr) {
  const long long blocks = static_cast<long long>((b + kLanes - 1) / kLanes) *
                           ((d + kSumRows - 1) / kSumRows);
  return blocks * (nb + nr);
}

extern "C" int vct_inv_perm_weighted_sum_bwd(int dtype, const void* g,
                                             const void* yf, const void* yr,
                                             const float* wf, const float* wr,
                                             const int* inv,
                                             const int* rev_rows, void* dyf,
                                             void* dyr, float* dw, float* work,
                                             int L, int d, int b, int nb,
                                             int nr, void* stream) {
  if (nb < 1 || nr < 0 || nr > nb || nb + nr > kMaxStreams ||
      (d + kSumRows - 1) / kSumRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 0 || d == 0 || b == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * (nb + nr), st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == vct::kF32)
    return launch_sum_bwd<float>(g, yf, yr, wf, wr, inv, rev_rows, dyf, dyr,
                                 dw, work, L, d, b, nb, nr, st);
  if (dtype == vct::kBF16)
    return launch_sum_bwd<__nv_bfloat16>(g, yf, yr, wf, wr, inv, rev_rows,
                                         dyf, dyr, dw, work, L, d, b, nb, nr,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
