// K1: selective-scan forward (Mamba-1 recurrence), lane-major layout.
//
// Replaces the Pallas TPU kernel vit_cnn_tpu/ops/selective_scan.py
// `_scan_kernel` (launched by `_pallas_forward`). Computes, per stream s,
// channel d and sequence b:
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = C_t . h_t + D[d] * u_t
// over t = 0..L-1, or L-1..0 when `reverse` is set.
//
// Layout: u, dt, y are (ns, L, d, b); B, C are (ns, L, n, b); A is (d, n)
// and D is (d,), both float32. b is the innermost axis, so a warp's 32
// lanes are 32 neighbouring sequences and every load and store is
// coalesced.
//
// What bounds it on the H100: each (t, d, b) element costs n = 16 exps,
// 32 FMAs and about 7 bytes of traffic in bf16 (u, dt, y, plus B and C
// shared by all d of a column). The exps run on the special-function
// units, about 3.9e12 per second on the card, against 3.35 TB/s of
// memory: the exps take about twice as long as the bytes, so the kernel
// is bound by the exp rate, not by memory.
//
// Design: one thread per (stream, d, b) with the n-wide state in float32
// registers, looping over t (a bf16 state diverges over L steps). The
// block is a 32-sequence by 8-channel tile; every channel of the tile
// reads the same B_t and C_t, so the block stages them for TC steps at a
// time in shared memory. The ragged batch edge is masked in the kernel,
// with no padding of the inputs.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // sequences per block (one warp wide)
constexpr int kRows = 8;     // channels per block
constexpr int kMaxN = 16;    // largest state size compiled in
constexpr int kChunk = 8;    // time steps of B/C staged per sync

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, T* __restrict__ y,
                      int L, int d, int n, int b, int reverse) {
  __shared__ float sB[kChunk][kMaxN][kLanes];
  __shared__ float sC[kChunk][kMaxN][kLanes];

  const int lane = threadIdx.x;
  const int bi = blockIdx.x * kLanes + lane;
  const int di = blockIdx.y * kRows + threadIdx.y;
  const size_t s = blockIdx.z;
  const bool active = bi < b && di < d;

  const size_t seq_d = static_cast<size_t>(d) * b;   // one time step of u
  const size_t seq_n = static_cast<size_t>(n) * b;   // one time step of B
  const T* u_s = u + s * L * seq_d;
  const T* dt_s = dt + s * L * seq_d;
  const T* B_s = Bm + s * L * seq_n;
  const T* C_s = Cm + s * L * seq_n;
  T* y_s = y + s * L * seq_d;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    a[i] = (di < d && i < n) ? A[di * n + i] : 0.f;
    h[i] = 0.f;
  }
  const float dval = di < d ? Dv[di] : 0.f;
  const int tid = threadIdx.y * kLanes + lane;

  for (int c0 = 0; c0 < L; c0 += kChunk) {
    const int tc = min(kChunk, L - c0);
    const int base = reverse ? L - c0 - tc : c0;   // chunk covers [base, base+tc)
    __syncthreads();                               // last chunk's reads done
    for (int idx = tid; idx < tc * n * kLanes; idx += kLanes * kRows) {
      const int l = idx % kLanes;
      const int rest = idx / kLanes;
      const int i = rest % n;
      const int tt = rest / n;
      const int bb = blockIdx.x * kLanes + l;
      float bv = 0.f, cv = 0.f;
      if (bb < b) {
        const size_t off = (base + tt) * seq_n + static_cast<size_t>(i) * b + bb;
        bv = vct::to_f32(B_s[off]);
        cv = vct::to_f32(C_s[off]);
      }
      sB[tt][i][l] = bv;
      sC[tt][i][l] = cv;
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < tc; ++k) {
      const int tt = reverse ? tc - 1 - k : k;
      const size_t off = (base + tt) * seq_d + static_cast<size_t>(di) * b + bi;
      const float uv = vct::to_f32(u_s[off]);
      const float dtv = vct::to_f32(dt_s[off]);
      const float du = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          h[i] = expf(dtv * a[i]) * h[i] + du * sB[tt][i][lane];
          acc += sC[tt][i][lane] * h[i];
        }
      }
      y_s[off] = vct::from_f32<T>(acc + dval * uv);
    }
  }
}

template <typename T>
void launch(const void* u, const void* dt, const float* A, const void* B,
            const void* C, const float* D, void* y, int ns, int L, int d,
            int n, int b, int reverse, cudaStream_t stream) {
  dim3 block(kLanes, kRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kRows - 1) / kRows, ns);
  selective_scan_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), L, d, n, b, reverse);
}

}  // namespace

extern "C" int vct_selective_scan(int dtype, const void* u, const void* dt,
                                  const float* A, const void* B,
                                  const void* C, const float* D, void* y,
                                  int ns, int L, int d, int n, int b,
                                  int reverse, void* stream) {
  if (n < 1 || n > kMaxN || ns > 65535 || (d + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ns == 0 || L == 0 || d == 0 || b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    launch<float>(u, dt, A, B, C, D, y, ns, L, d, n, b, reverse, st);
  else if (dtype == vct::kBF16)
    launch<__nv_bfloat16>(u, dt, A, B, C, D, y, ns, L, d, n, b, reverse, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
