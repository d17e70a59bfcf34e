// K5: selective-scan backward (the adjoint of K1), lane-major layout.
//
// Replaces the Pallas TPU kernel vit_cnn_tpu/ops/selective_scan.py
// `_scan_bwd_kernel` (launched by `_pallas_backward`). For the forward
//   h_t = dA_t * h_{t-1} + (dt_t * u_t) * B_t,   dA_t = exp(dt_t * A[d])
//   y_t = C_t . h_t + D[d] * u_t
// and the output cotangent g, the adjoint state runs against the scan
// direction:
//   lam_t = C_t * g_t + dA_{t+1} * lam_{t+1}
// and gives, per element,
//   du_t  = dt_t * S_t + D * g_t,        S_t = sum_i lam_t[i] B_t[i]
//   ddt_t = u_t * S_t + sum_i lam_t[i] h_{t-1}[i] dA_t[i] A[i]
//   dB_t  = sum_d lam_t * dt_t * u_t,    dC_t = sum_d h_t * g_t
// and, summed over streams, time and batch,
//   dA = sum lam_t * h_{t-1} * dA_t * dt_t,   dD = sum g_t * u_t.
//
// Layout as K1: u, dt, g, du, ddt are (ns, L, d, b); B, C, dB, dC are
// (ns, L, n, b); A (d, n) and D (d,) float32; b innermost.
//
// What bounds it on the H100: per (t, d, b) element the two sweeps below
// take 48 exps (the forward's 16, three times) and about 14 bytes of
// traffic in bf16, plus ~3 x 4 bytes of float32 scratch: far from the
// memory bound. Measured at the flagship's train shapes, it is bound by
// the latency of each thread's sequential time loop at 16 warps per SM
// (the shared-memory trajectory allows two blocks): taking out the
// per-step block reduction saves 5%, taking out sweep 1 8%, and the
// exp's instruction count is what the fast __expf (ex2.approx, ~2e-6
// relative error) already took out (21%).
//
// Design: K1's layout, one thread per (stream, d, b) with the 16-wide
// state in float32 registers, a 32-sequence by 8-channel block. A full
// (ns, L, d, n, b) float32 trajectory would take 2.3 GB at the train
// shapes, so, as the Pallas kernel does, sweep 1 runs the forward and
// keeps only h at the start of every kChunk-step chunk in float32 scratch;
// sweep 2 walks the chunks against the scan direction, recomputes h
// through each chunk into shared memory and runs the adjoint through it.
// dB_t and dC_t sum over d, which spans several blocks: each block sums
// its 8 channels in shared memory and writes one float32 partial per
// (block row, t, n, b); dA and dD are summed over the block's lanes with
// warp shuffles into per-block partials. A second pass (sum_partials)
// adds the partials in a fixed order: no atomics, so every gradient is
// the same from run to run.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // sequences per block (one warp wide)
constexpr int kRows = 8;     // channels per block (one warp each)
constexpr int kMaxN = 16;    // largest state size compiled in
constexpr int kChunk = 4;    // steps between stored boundary states

constexpr int kTile = kRows * kLanes;
constexpr size_t kSmemBytes =
    sizeof(float) * (kChunk * kMaxN * kTile + 2 * kMaxN * kTile);

struct Work {            // carve of the float32 workspace
  float *bounds, *pB, *pC, *pA, *pD;
};

inline int n_chunks(int L) { return (L + kChunk - 1) / kChunk; }

inline Work carve(float* w, int ns, int L, int d, int n, int b) {
  const size_t bx = (b + kLanes - 1) / kLanes, ty = (d + kRows - 1) / kRows;
  Work out;
  out.bounds = w;
  out.pB = out.bounds + static_cast<size_t>(ns) * n_chunks(L) * n * d * b;
  out.pC = out.pB + static_cast<size_t>(ns) * ty * L * n * b;
  out.pA = out.pC + static_cast<size_t>(ns) * ty * L * n * b;
  out.pD = out.pA + static_cast<size_t>(ns) * bx * d * n;
  return out;
}

inline size_t work_floats(int ns, int L, int d, int n, int b) {
  const size_t bx = (b + kLanes - 1) / kLanes, ty = (d + kRows - 1) / kRows;
  return static_cast<size_t>(ns) * n_chunks(L) * n * d * b +
         2 * static_cast<size_t>(ns) * ty * L * n * b +
         static_cast<size_t>(ns) * bx * d * (n + 1);
}

template <typename T>
__global__ void __launch_bounds__(kTile)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          const float* __restrict__ Dv,
                          const T* __restrict__ g, T* __restrict__ du,
                          T* __restrict__ ddt, Work w, int L, int d, int n,
                          int b, int reverse) {
  extern __shared__ float smem[];
  float* sH = smem;                          // [kChunk][kMaxN][kRows][kLanes]
  float* sRB = sH + kChunk * kMaxN * kTile;  // [kMaxN][kRows][kLanes]
  float* sRC = sRB + kMaxN * kTile;

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * kLanes + lane;
  const int bi = blockIdx.x * kLanes + lane;
  const int di = blockIdx.y * kRows + row;
  const size_t s = blockIdx.z;
  const bool lane_ok = bi < b;
  const bool active = lane_ok && di < d;

  const size_t seq_d = static_cast<size_t>(d) * b;
  const size_t seq_n = static_cast<size_t>(n) * b;
  const size_t col = static_cast<size_t>(di) * b + bi;
  const T* u_s = u + s * L * seq_d;
  const T* dt_s = dt + s * L * seq_d;
  const T* g_s = g + s * L * seq_d;
  T* du_s = du + s * L * seq_d;
  T* ddt_s = ddt + s * L * seq_d;
  const T* B_s = Bm + s * L * seq_n;
  const T* C_s = Cm + s * L * seq_n;
  const int nch = (L + kChunk - 1) / kChunk;
  float* bnd_s = w.bounds + s * nch * n * seq_d;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    a[i] = (di < d && i < n) ? A[di * n + i] : 0.f;
    h[i] = 0.f;
  }
  const float dval = di < d ? Dv[di] : 0.f;
  auto time_of = [&](int p) { return reverse ? L - 1 - p : p; };
  auto sh = [&](int k, int i) -> float& {
    return sH[(k * kMaxN + i) * kTile + tid];
  };

  // ---- sweep 1: forward, keeping h at the start of every chunk ----
  for (int c = 0; c < nch; ++c) {
    if (!active) break;
    float* bnd = bnd_s + static_cast<size_t>(c) * n * seq_d + col;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i)
      if (i < n) bnd[i * seq_d] = h[i];
    const int p0 = c * kChunk, tc = min(kChunk, L - p0);
    for (int k = 0; k < tc; ++k) {
      const int t = time_of(p0 + k);
      const float uv = vct::to_f32(u_s[t * seq_d + col]);
      const float dtv = vct::to_f32(dt_s[t * seq_d + col]);
      const float dtu = dtv * uv;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i)
        if (i < n)
          h[i] = __expf(dtv * a[i]) * h[i] +
                 dtu * vct::to_f32(B_s[t * seq_n + i * b + bi]);
    }
  }

  // ---- sweep 2: chunks against the scan direction ----
  float mu[kMaxN], dA_acc[kMaxN];   // mu = dA_{t+1} * lam_{t+1}
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) mu[i] = dA_acc[i] = 0.f;
  float dD_acc = 0.f;
  for (int c = nch - 1; c >= 0; --c) {
    const int p0 = c * kChunk, tc = min(kChunk, L - p0);
    // recompute h through the chunk: sh(k) holds h before step k
    const float* bnd = bnd_s + static_cast<size_t>(c) * n * seq_d + col;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) h[i] = (active && i < n) ? bnd[i * seq_d] : 0.f;
    for (int k = 0; k < tc; ++k) {
      const int t = time_of(p0 + k);
      const float uv = active ? vct::to_f32(u_s[t * seq_d + col]) : 0.f;
      const float dtv = active ? vct::to_f32(dt_s[t * seq_d + col]) : 0.f;
      const float dtu = dtv * uv;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          sh(k, i) = h[i];
          const float bv = lane_ok ? vct::to_f32(B_s[t * seq_n + i * b + bi]) : 0.f;
          h[i] = __expf(dtv * a[i]) * h[i] + dtu * bv;
        }
      }
    }
    // adjoint through the chunk, last step first; h holds h after it
    for (int k = tc - 1; k >= 0; --k) {
      const int t = time_of(p0 + k);
      const size_t off = t * seq_d + col;
      const float uv = active ? vct::to_f32(u_s[off]) : 0.f;
      const float dtv = active ? vct::to_f32(dt_s[off]) : 0.f;
      const float gv = active ? vct::to_f32(g_s[off]) : 0.f;
      const float dtu = dtv * uv;
      float S = 0.f, Tt = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          const size_t bc = t * seq_n + i * b + bi;
          const float bv = lane_ok ? vct::to_f32(B_s[bc]) : 0.f;
          const float cv = lane_ok ? vct::to_f32(C_s[bc]) : 0.f;
          const float h_prev = sh(k, i);
          const float h_after = k == tc - 1 ? h[i] : sh(k + 1, i);
          const float lam = cv * gv + mu[i];
          const float dA = __expf(dtv * a[i]);
          const float q = lam * h_prev * dA;
          S += lam * bv;
          Tt += q * a[i];
          dA_acc[i] += q * dtv;
          sRB[i * kTile + tid] = lam * dtu;
          sRC[i * kTile + tid] = h_after * gv;
          mu[i] = dA * lam;
        }
      }
      if (active) {
        ddt_s[off] = vct::from_f32<T>(Tt + uv * S);
        du_s[off] = vct::from_f32<T>(dtv * S + dval * gv);
      }
      dD_acc += gv * uv;
      __syncthreads();
      // this block's 8 channels of dB_t and dC_t, one partial per block row
      for (int idx = tid; idx < n * kLanes; idx += kTile) {
        const int l = idx % kLanes, i = idx / kLanes;
        const int bb = blockIdx.x * kLanes + l;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          sb += sRB[i * kTile + r * kLanes + l];
          sc += sRC[i * kTile + r * kLanes + l];
        }
        if (bb < b) {
          const size_t p = ((s * gridDim.y + blockIdx.y) * L + t) * seq_n +
                           static_cast<size_t>(i) * b + bb;
          w.pB[p] = sb;
          w.pC[p] = sc;
        }
      }
      __syncthreads();
    }
  }

  // dA, dD: sum over the block's 32 lanes (one warp per channel row)
  const size_t blk = s * gridDim.x + blockIdx.x;
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    const float v = vct::warp_sum(dA_acc[i]);
    if (lane == 0 && di < d && i < n) w.pA[(blk * d + di) * n + i] = v;
  }
  const float vd = vct::warp_sum(dD_acc);
  if (lane == 0 && di < d) w.pD[blk * d + di] = vd;
}

template <typename T>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, const void* g, void* du, void* ddt,
           void* dB, void* dC, float* dA, float* dD, float* work, int ns,
           int L, int d, int n, int b, int reverse, cudaStream_t stream) {
  cudaError_t err = vct::allow_smem(selective_scan_bwd_kernel<T>, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Work w = carve(work, ns, L, d, n, b);
  dim3 block(kLanes, kRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kRows - 1) / kRows, ns);
  selective_scan_bwd_kernel<T><<<grid, block, kSmemBytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<const T*>(g), static_cast<T*>(du), static_cast<T*>(ddt), w,
      L, d, n, b, reverse);
  const long long bn = static_cast<long long>(L) * n * b;
  vct::sum_partials<T>(w.pB, static_cast<T*>(dB), ns, grid.y, bn, stream);
  vct::sum_partials<T>(w.pC, static_cast<T*>(dC), ns, grid.y, bn, stream);
  vct::sum_partials<float>(w.pA, dA, 1, ns * grid.x,
                           static_cast<long long>(d) * n, stream);
  vct::sum_partials<float>(w.pD, dD, 1, ns * grid.x, d, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 elements of the workspace vct_selective_scan_bwd needs
extern "C" long long vct_selective_scan_bwd_workspace(int ns, int L, int d,
                                                      int n, int b) {
  return static_cast<long long>(work_floats(ns, L, d, n, b));
}

extern "C" int vct_selective_scan_bwd(int dtype, const void* u, const void* dt,
                                      const float* A, const void* B,
                                      const void* C, const float* D,
                                      const void* g, void* du, void* ddt,
                                      void* dB, void* dC, float* dA, float* dD,
                                      float* work, int ns, int L, int d, int n,
                                      int b, int reverse, void* stream) {
  if (n < 1 || n > kMaxN || ns > 65535 || (d + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns == 0 || L == 0 || d == 0 || b == 0) {   // nothing to sum: zeros
    cudaMemsetAsync(dA, 0, sizeof(float) * d * n, st);
    cudaMemsetAsync(dD, 0, sizeof(float) * d, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == vct::kF32)
    return launch<float>(u, dt, A, B, C, D, g, du, ddt, dB, dC, dA, dD, work,
                         ns, L, d, n, b, reverse, st);
  if (dtype == vct::kBF16)
    return launch<__nv_bfloat16>(u, dt, A, B, C, D, g, du, ddt, dB, dC, dA,
                                 dD, work, ns, L, d, n, b, reverse, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
