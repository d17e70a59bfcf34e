// V1: the tile and chunk grid of the first selective-scan forward.
//
// The first K1 replaced the Pallas TPU kernel
// vit_cnn_tpu/ops/selective_scan.py `_scan_kernel` (launched by
// `_pallas_forward`). The main path now runs the kernel of
// csrc/selective_scan_fwd.cu; this file keeps the first K1 unchanged as the
// (8, 8) instance of its grid (tools/scan_ab.py holds it against an older
// commit's K1). It computes, per stream s,
// channel d and sequence b:
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = C_t . h_t + D[d] * u_t
// over t = 0..L-1, or L-1..0 when `reverse` is set.
//
// V1 replaces the tuning probe perf/scan_sweep.py `_kernel_lanemajor`
// (launched by `scan_lanemajor_pre`), which swept the TPU kernel's time
// chunk and its tile over sequences. A warp here already spans 32
// sequences, so the tile that varies on the card is the channels per block
// (kRows); the time chunk (kChunk) is the steps of B and C staged per
// synchronisation. The grid is kRows in {4, 8, 16} x kChunk in {8, 16, 27}
// (`vct_selective_scan_tiled`).
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
// block is a 32-sequence by kRows-channel tile; every channel of the tile
// reads the same B_t and C_t, so the block stages them for kChunk steps at
// a time in shared memory: 4 KB per step, so 32 KB at chunk 8, in static
// shared memory as the first K1 had it, and 64 KB at chunk 16 and 110.6 KB at
// chunk 27, above the 48 KB of static shared memory: those instances take
// dynamic shared memory with the cap raised per instance (fewer blocks
// then fit on an SM). The ragged batch edge is masked in the kernel, with
// no padding of the inputs.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // sequences per block (one warp wide)
constexpr int kMaxN = 16;    // largest state size compiled in

// bytes of B and C staged for kChunk steps, and whether they fit in static
// shared memory
__host__ __device__ constexpr size_t staging_bytes(int chunk) {
  return 2 * sizeof(float) * chunk * kMaxN * kLanes;
}
__host__ __device__ constexpr bool static_staging(int chunk) {
  return staging_bytes(chunk) <= 48 * 1024;
}

struct ScanArgs {
  const void* u;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  int ns, L, d, n, b, reverse;
  cudaStream_t stream;
};

template <typename T, int kRows, int kChunk>
__global__ void __launch_bounds__(kLanes * kRows)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, T* __restrict__ y,
                      int L, int d, int n, int b, int reverse) {
  constexpr bool kStatic = static_staging(kChunk);
  constexpr int kStaticSteps = kStatic ? kChunk : 1;
  __shared__ float sB_static[kStaticSteps][kMaxN][kLanes];
  __shared__ float sC_static[kStaticSteps][kMaxN][kLanes];
  extern __shared__ float smem[];
  float(*sB)[kMaxN][kLanes] =
      kStatic ? sB_static : reinterpret_cast<float(*)[kMaxN][kLanes]>(smem);
  float(*sC)[kMaxN][kLanes] = kStatic ? sC_static : sB + kChunk;

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

template <typename T, int kRows, int kChunk>
int launch(const ScanArgs& p) {
  const size_t smem = static_staging(kChunk) ? 0 : staging_bytes(kChunk);
  const auto kernel = selective_scan_kernel<T, kRows, kChunk>;
  if ((p.d + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kLanes, kRows);
  dim3 grid((p.b + kLanes - 1) / kLanes, (p.d + kRows - 1) / kRows, p.ns);
  kernel<<<grid, block, smem, p.stream>>>(
      static_cast<const T*>(p.u), static_cast<const T*>(p.dt), p.A,
      static_cast<const T*>(p.B), static_cast<const T*>(p.C), p.D,
      static_cast<T*>(p.y), p.L, p.d, p.n, p.b, p.reverse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRows>
int by_chunk(int chunk, const ScanArgs& p) {
  if (chunk == 8) return launch<T, kRows, 8>(p);
  if (chunk == 16) return launch<T, kRows, 16>(p);
  if (chunk == 27) return launch<T, kRows, 27>(p);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_tile(int rows, int chunk, const ScanArgs& p) {
  if (rows == 4) return by_chunk<T, 4>(chunk, p);
  if (rows == 8) return by_chunk<T, 8>(chunk, p);
  if (rows == 16) return by_chunk<T, 16>(chunk, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

int scan(int dtype, int rows, int chunk, const ScanArgs& p) {
  if (p.n < 1 || p.n > kMaxN || p.ns > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.ns == 0 || p.L == 0 || p.d == 0 || p.b == 0) return 0;
  if (dtype == vct::kF32) return by_tile<float>(rows, chunk, p);
  if (dtype == vct::kBF16) return by_tile<__nv_bfloat16>(rows, chunk, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// V1: the (rows, chunk) instance of the grid; rows in {4, 8, 16}, chunk in
// {8, 16, 27}, anything else is cudaErrorInvalidValue
extern "C" int vct_selective_scan_tiled(int dtype, const void* u,
                                        const void* dt, const float* A,
                                        const void* B, const void* C,
                                        const float* D, void* y, int ns,
                                        int L, int d, int n, int b,
                                        int reverse, int rows, int chunk,
                                        void* stream) {
  return scan(dtype, rows, chunk,
              ScanArgs{u, dt, A, B, C, D, y, ns, L, d, n, b, reverse,
                       static_cast<cudaStream_t>(stream)});
}
