// V2: selective-scan forward with batch-major I/O.
//
// Replaces the tuning probe perf/scan_bm_sweep.py `_scan_kernel_bm`
// (launched by `scan_bm`), which asked whether the scan can read the
// mixer's batch-major layout directly instead of being fed by transposes.
// It computes K1's recurrence (csrc/selective_scan_fwd.cu), forward only:
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = C_t . h_t + D[d] * u_t
// with u, dt, y (b, L, d) and B, C (b, L, n); A (d, n) and D (d,) float32.
//
// What bounds it on the H100: the same work as K1 (n exps and 2n FMAs per
// (b, t, d) element, ~7 bytes of traffic in bf16), so the exp rate.
//
// Design: the TPU probe transposed each block to the lane-major compute
// layout inside VMEM; on the card that is not needed. Threads run along d
// of one sequence: thread k of a block owns channel k % d of sequence
// k / d, with its n-wide state in float32 registers, so at every step a
// warp reads and writes contiguous runs of u, dt and y. A block holds
// `seqs` = 256 / d sequences, at least 1 and at most 32. The B_t and C_t
// of each sequence (n values per step, read by all d channels) are staged per
// chunk of kChunk steps in shared memory: for one sequence they are
// kChunk * n contiguous values. The ragged batch edge is masked in the
// kernel (the probe's block_b divisibility was a TPU constraint).
#include "common.cuh"

namespace {

constexpr int kMaxN = 16;
constexpr int kChunk = 8;          // the probe's time chunk
constexpr int kMaxThreads = 1024;
constexpr int kTargetThreads = 256;
constexpr int kMaxSeqs = 32;       // 32 KB of staged B and C per block

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
scan_batch_major_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                        const float* __restrict__ A,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const float* __restrict__ Dv, T* __restrict__ y,
                        int L, int d, int n, int b, int seqs) {
  extern __shared__ float smem[];
  float* sB = smem;                            // [seqs][kChunk][kMaxN]
  float* sC = smem + seqs * kChunk * kMaxN;

  const int tid = threadIdx.x;
  const int sl = tid / d;                      // sequence within the block
  const int di = tid - sl * d;
  const long long bi = static_cast<long long>(blockIdx.x) * seqs + sl;
  const bool active = sl < seqs && bi < b;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    a[i] = (active && i < n) ? A[di * n + i] : 0.f;
    h[i] = 0.f;
  }
  const float dval = active ? Dv[di] : 0.f;
  const size_t seq_u = static_cast<size_t>(L) * d;     // one sequence of u
  const size_t seq_b = static_cast<size_t>(L) * n;     // one sequence of B
  const size_t u0 = active ? bi * seq_u + di : 0;
  const float* sBs = sB + sl * kChunk * kMaxN;
  const float* sCs = sC + sl * kChunk * kMaxN;

  for (int c0 = 0; c0 < L; c0 += kChunk) {
    const int tc = min(kChunk, L - c0);
    __syncthreads();                           // last chunk's reads done
    for (int idx = tid; idx < seqs * tc * n; idx += blockDim.x) {
      const int s = idx / (tc * n);
      const int rest = idx - s * tc * n;       // tt * n + i
      const int tt = rest / n, i = rest - tt * n;
      const long long bb = static_cast<long long>(blockIdx.x) * seqs + s;
      float bv = 0.f, cv = 0.f;
      if (bb < b) {
        const size_t off = bb * seq_b + static_cast<size_t>(c0) * n + rest;
        bv = vct::to_f32(Bm[off]);
        cv = vct::to_f32(Cm[off]);
      }
      sB[(s * kChunk + tt) * kMaxN + i] = bv;
      sC[(s * kChunk + tt) * kMaxN + i] = cv;
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < tc; ++tt) {
      const size_t off = u0 + static_cast<size_t>(c0 + tt) * d;
      const float uv = vct::to_f32(u[off]);
      const float dtv = vct::to_f32(dt[off]);
      const float du = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          h[i] = expf(dtv * a[i]) * h[i] + du * sBs[tt * kMaxN + i];
          acc += sCs[tt * kMaxN + i] * h[i];
        }
      }
      y[off] = vct::from_f32<T>(acc + dval * uv);
    }
  }
}

template <typename T>
int launch_batch_major(const void* u, const void* dt, const float* A,
                       const void* B, const void* C, const float* D, void* y,
                       int L, int d, int n, int b, cudaStream_t stream) {
  const int seqs = d >= kTargetThreads ? 1
                   : (kTargetThreads / d < kMaxSeqs ? kTargetThreads / d
                                                    : kMaxSeqs);
  const int threads = (seqs * d + 31) / 32 * 32;
  const size_t smem = 2 * sizeof(float) * seqs * kChunk * kMaxN;
  const long long blocks = (static_cast<long long>(b) + seqs - 1) / seqs;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  scan_batch_major_kernel<T><<<static_cast<unsigned>(blocks), threads, smem,
                               stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), L, d, n, b, seqs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vct_selective_scan_batch_major(int dtype, const void* u,
                                              const void* dt, const float* A,
                                              const void* B, const void* C,
                                              const float* D, void* y, int L,
                                              int d, int n, int b,
                                              void* stream) {
  if (n < 1 || n > kMaxN || d > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0 || d == 0 || b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return launch_batch_major<float>(u, dt, A, B, C, D, y, L, d, n, b, st);
  if (dtype == vct::kBF16)
    return launch_batch_major<__nv_bfloat16>(u, dt, A, B, C, D, y, L, d, n,
                                             b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
