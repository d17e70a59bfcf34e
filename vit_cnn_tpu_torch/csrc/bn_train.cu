// Train-mode BatchNorm over the last axis of channel-last activations,
// with the ReLU after it where the caller asks (ops/bn_train.py), as four
// passes under one autograd Function. It replaces no TPU kernel: the JAX
// package leaves the chain to XLA. PyTorch runs it as a float32 chain (the
// cast to float32, two means, the mean square, clamp, rsqrt, affine, cast
// and ReLU, then autograd back through each op) that moves ~55 bytes an
// element of a bf16 tensor forward and ~100 backward; these passes move 16
// (bf16) or 32 (float32):
//
//   1. moments   one read of x: per-channel float32 sum(x) and sum(x^2),
//                and the row count, in `sums` (2C + 1 values)
//   2. apply     one read of x, one write of y:
//                y = relu(round_T((x - mean) * (rsqrt(var + eps) * w) + b))
//                and, in one block, the running statistics
//   3. backward sums   one read of dy and x: per-channel sum(g) and
//                sum(g * (x - mean)), g = dy where the recomputed y > 0
//                (all of dy without the ReLU); dw and db from them
//   4. backward apply  one read of dy and x, one write of dx:
//                dx = a * (g - sum(g) / n - (x - mean) * c2), a = inv * w,
//                c2 = inv^2 * sum(g * (x - mean)) / n where the raw
//                variance is >= 0, else 0 (the clamp's gradient)
//
// with mean = sum(x) / n, raw = sum(x^2) / n - mean^2, var = raw < 0 ? 0 :
// raw and inv = rsqrt(var + eps): flax's fast biased variance, in the
// plain chain's order of roundings (no FMA contraction in the forward, so
// y equals the chain's `normalize` fed the same mean and var bit for bit).
// Under a mesh the wrapper sums `sums` over the ranks between passes 1
// and 2, and the two backward sums between passes 3 and 4.
//
// Bound: bytes. The two elementwise passes keep the eval-mode pass's
// design (csrc/bn_act.cu): 16-byte loads and stores (8 bf16 or 4 float32
// values) where C is a multiple of that and every plane is 16-byte
// aligned, one value a thread otherwise; a grid of the resident blocks
// whose stride is a multiple of C, so that each thread keeps its channels
// and computes their constants once. The two reduce passes run a 2-D
// grid: blockIdx.x a group of tx column vectors (tx a power of two, at
// most 8 sixteen-byte vectors, so that a warp reads 128 contiguous bytes
// of a row, or 32 single values), blockIdx.y a share of the rows, sized
// to fill the card with four blocks an SM. Each thread sums its rows in
// float32 (four loads in flight, each group of four summed pairwise
// first); from there on in float64, which costs nothing here: the block
// sums its row lanes (warp shuffles, then the warps in order), and the
// last block of each column group to finish sums the groups' partials in
// block order. No float atomics: an integer counter per
// column group elects that last block, so two runs on one input agree bit
// for bit whatever order the blocks ran in.

#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the reduce passes' grid: blocks an SM (the card's 132 SMs at both ends
// of FusAtNet's shapes), rows a thread sums at least, loads in flight
constexpr int kBlocksPerSm = 4;
constexpr int kMinRows = 2;
constexpr int kLoads = 4;  // pass 1 sums each four pairwise
// channels a reduce block covers at most (tx x values a vector)
constexpr int kMaxLanes = 64;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return vct::to_f32(vct::from_f32<T>(v));
}

// channel c's batch statistics from `sums` (sum x, sum x^2, count), as
// the plain chain's mesh branch takes them
struct Moments {
  float mean, raw, var, inv;
};

__device__ __forceinline__ Moments moments_of(const float* sums, int C,
                                              int c, float eps) {
  const float n = sums[2 * C];
  Moments m;
  m.mean = __fdiv_rn(sums[c], n);
  m.raw = __fsub_rn(__fdiv_rn(sums[C + c], n), __fmul_rn(m.mean, m.mean));
  m.var = m.raw < 0.f ? 0.f : m.raw;  // NaN stays NaN, as clamp_min
  m.inv = rsqrtf(__fadd_rn(m.var, eps));
  return m;
}

// the forward's value before the cast: (x - mean) * mul + shift, no FMA
__device__ __forceinline__ float affine(float v, float mean, float mul,
                                        float shift) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, mean), mul), shift);
}

// relu's gradient on the recomputed output: threshold_backward passes the
// cotangent where the output is not <= 0 (NaN included)
template <typename T>
__device__ __forceinline__ float masked(float g, float v, float mean,
                                        float mul, float shift, bool relu) {
  if (!relu) return g;
  return round_to<T>(affine(v, mean, mul, shift)) <= 0.f ? 0.f : g;
}

// ---------------------------------------------------------------------------
// the reduce passes' shared tail

// Each thread holds acc[q][j] (q: the two sums, j: its vector's values)
// over its rows, in float32. From there on the sums are float64: over
// the block's row lanes into the block's partial row
// part[blockIdx.y][q][c]; then the last block of the column group to
// finish sums the gridDim.y partials in order into fin[q * lanes + k]
// (shared) and returns true. lanes = tx * kVec. So a sum's rounding is
// that of its threads' float32 runs of rows alone, however many threads
// and blocks share the rows (a run is 2 rows a thread at C = 1).
template <int kVec>
__device__ bool group_sums(const float (&acc)[2][kVec], int tx_log2, int C,
                           double* __restrict__ part,
                           unsigned int* __restrict__ done, double* red,
                           double* fin) {
  const int tx = 1 << tx_log2;
  const int lanes = tx * kVec;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's row lanes of one column: lanes that differ in the bits
  // above tx_log2, summed in a fixed butterfly
  double wide[2][kVec];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      wide[q][j] = acc[q][j];
      for (int o = 16; o >= tx; o >>= 1)
        wide[q][j] += __shfl_xor_sync(0xffffffffu, wide[q][j], o);
    }
  if (lane < tx) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        red[(warp * 2 + q) * kMaxLanes + lane * kVec + j] = wide[q][j];
  }
  __syncthreads();
  const int c0 = blockIdx.x * lanes;
  if (threadIdx.x < 2 * lanes) {
    const int q = threadIdx.x / lanes, k = threadIdx.x % lanes;
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[(w * 2 + q) * kMaxLanes + k];
    if (c0 + k < C)
      part[(static_cast<size_t>(blockIdx.y) * 2 + q) * C + c0 + k] = s;
  }
  // the last block of this column group sums the partials
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&done[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const int outs = 2 * lanes, slices = kThreads / outs;
  const int o = threadIdx.x % outs, slice = threadIdx.x / outs;
  const int rows = gridDim.y;
  if (slice < slices) {
    const int q = o / lanes, k = o % lanes;
    const int lo = static_cast<int>(static_cast<long long>(rows) * slice /
                                    slices),
              hi = static_cast<int>(static_cast<long long>(rows) *
                                    (slice + 1) / slices);
    double s = 0.0;
    if (c0 + k < C) {
      const double* src = part + static_cast<size_t>(q) * C + c0 + k;
      for (int r = lo; r < hi; ++r)
        s += __ldcg(src + static_cast<size_t>(r) * 2 * C);
    }
    red[slice * outs + o] = s;
  }
  __syncthreads();
  if (threadIdx.x < outs) {
    double s = 0.0;
    for (int k = 0; k < slices; ++k) s += red[k * outs + threadIdx.x];
    fin[threadIdx.x] = s;
  }
  __syncthreads();
  return true;
}

// pass 1: sums[c] = sum x, sums[C + c] = sum x^2 over the rows; sums[2C]
// = the row count
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) bn_train_moments_reduce_kernel(
    const T* __restrict__ x, long long rows, int C, int tx_log2,
    double* __restrict__ part, unsigned int* __restrict__ done,
    float* __restrict__ sums) {
  __shared__ double red[kWarps * 2 * kMaxLanes];
  __shared__ double fin[2 * kMaxLanes];
  const int tx = 1 << tx_log2, ty = kThreads >> tx_log2;
  const int col = blockIdx.x * tx + (threadIdx.x & (tx - 1));
  float acc[2][kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (col < C / kVec) {
    using IO = vct::VecIO<T, kVec>;
    const long long step = static_cast<long long>(gridDim.y) * ty;
    for (long long r = static_cast<long long>(blockIdx.y) * ty +
                       (threadIdx.x >> tx_log2);
         r < rows; r += kLoads * step) {
      typename IO::Raw raw[kLoads];
      float v[kLoads][kVec];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (r + u * step < rows)
          raw[u] = IO::load(x + (r + u * step) * C + col * kVec);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (r + u * step < rows) {
          IO::unpack(raw[u], v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float s = __fadd_rn(__fadd_rn(v[0][j], v[1][j]),
                                  __fadd_rn(v[2][j], v[3][j]));
        const float s2 =
            __fadd_rn(__fadd_rn(__fmul_rn(v[0][j], v[0][j]),
                                __fmul_rn(v[1][j], v[1][j])),
                      __fadd_rn(__fmul_rn(v[2][j], v[2][j]),
                                __fmul_rn(v[3][j], v[3][j])));
        acc[0][j] = __fadd_rn(acc[0][j], s);
        acc[1][j] = __fadd_rn(acc[1][j], s2);
      }
    }
  }
  if (!group_sums<kVec>(acc, tx_log2, C, part, done, red, fin)) return;
  const int lanes = tx * kVec, c0 = blockIdx.x * lanes;
  for (int k = threadIdx.x; k < lanes; k += kThreads) {
    if (c0 + k >= C) break;
    sums[c0 + k] = static_cast<float>(fin[k]);
    sums[C + c0 + k] = static_cast<float>(fin[lanes + k]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    sums[2 * C] = static_cast<float>(rows);
}

// pass 3: gsums[c] = sum g, gsums[C + c] = sum g * (x - mean); dw = inv *
// gsums[C + c] and db = gsums[c] in T (this rank's, before any mesh sum)
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) bn_train_backward_reduce_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, long long rows, int C,
    int tx_log2, const float* __restrict__ sums, const T* __restrict__ weight,
    const T* __restrict__ bias, float eps, bool relu,
    double* __restrict__ part, unsigned int* __restrict__ done,
    float* __restrict__ gsums, T* __restrict__ dw, T* __restrict__ db) {
  __shared__ double red[kWarps * 2 * kMaxLanes];
  __shared__ double fin[2 * kMaxLanes];
  const int tx = 1 << tx_log2, ty = kThreads >> tx_log2;
  const int col = blockIdx.x * tx + (threadIdx.x & (tx - 1));
  float acc[2][kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (col < C / kVec) {
    float mean[kVec], mul[kVec], shift[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = col * kVec + j;
      const Moments m = moments_of(sums, C, c, eps);
      mean[j] = m.mean;
      mul[j] = __fmul_rn(m.inv, vct::to_f32(weight[c]));
      shift[j] = vct::to_f32(bias[c]);
    }
    using IO = vct::VecIO<T, kVec>;
    constexpr int kU = kLoads / 2;  // two tensors: as many bytes in flight
    const long long step = static_cast<long long>(gridDim.y) * ty;
    for (long long r = static_cast<long long>(blockIdx.y) * ty +
                       (threadIdx.x >> tx_log2);
         r < rows; r += kU * step) {
      typename IO::Raw rg[kU], rx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r + u * step < rows) {
          const long long at = (r + u * step) * C + col * kVec;
          rg[u] = IO::load(dy + at);
          rx[u] = IO::load(x + at);
        }
      }
      float g[kU][kVec], gd[kU][kVec];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r + u * step < rows) {
          float a[kVec], b[kVec];
          IO::unpack(rg[u], a);
          IO::unpack(rx[u], b);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            g[u][j] = masked<T>(a[j], b[j], mean[j], mul[j], shift[j], relu);
            gd[u][j] = __fmul_rn(g[u][j], __fsub_rn(b[j], mean[j]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) g[u][j] = gd[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        acc[0][j] = __fadd_rn(acc[0][j], __fadd_rn(g[0][j], g[1][j]));
        acc[1][j] = __fadd_rn(acc[1][j], __fadd_rn(gd[0][j], gd[1][j]));
      }
    }
  }
  if (!group_sums<kVec>(acc, tx_log2, C, part, done, red, fin)) return;
  const int lanes = tx * kVec, c0 = blockIdx.x * lanes;
  for (int k = threadIdx.x; k < lanes; k += kThreads) {
    const int c = c0 + k;
    if (c >= C) break;
    const float sum_g = static_cast<float>(fin[k]),
                sum_gd = static_cast<float>(fin[lanes + k]);
    gsums[c] = sum_g;
    gsums[C + c] = sum_gd;
    dw[c] = vct::from_f32<T>(
        __fmul_rn(moments_of(sums, C, c, eps).inv, sum_gd));
    db[c] = vct::from_f32<T>(sum_g);
  }
}

// ---------------------------------------------------------------------------
// the elementwise passes: a grid of the resident blocks striding over the
// n_vec vectors by a multiple of c_vec (as csrc/bn_act.cu)

// pass 2: y from x; block 0 also writes the running statistics
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) bn_train_apply_elementwise_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long n_vec, int C,
    const float* __restrict__ sums, const T* __restrict__ weight,
    const T* __restrict__ bias, float eps, bool relu,
    float* __restrict__ running_mean,
    float* __restrict__ running_var, float keep, float take) {
  if (blockIdx.x == 0 && running_mean != nullptr) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const Moments m = moments_of(sums, C, c, eps);
      running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]),
                                  __fmul_rn(take, m.mean));
      running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                                 __fmul_rn(take, m.var));
    }
  }
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (first >= n_vec) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int c0 = static_cast<int>(first % (C / kVec)) * kVec;
  float mean[kVec], mul[kVec], shift[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const Moments m = moments_of(sums, C, c0 + j, eps);
    mean[j] = m.mean;
    mul[j] = __fmul_rn(m.inv, vct::to_f32(weight[c0 + j]));
    shift[j] = vct::to_f32(bias[c0 + j]);
  }
  using IO = vct::VecIO<T, kVec>;
  constexpr int kUnroll = kVec == 1 ? 4 : 2;
  for (long long v = first; v < n_vec; v += kUnroll * stride) {
    typename IO::Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i < n_vec) raw[u] = IO::load(x + i * kVec);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i >= n_vec) break;
      float a[kVec];
      IO::unpack(raw[u], a);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float o = affine(a[j], mean[j], mul[j], shift[j]);
        if (relu) {
          o = round_to<T>(o);
          if (!isnan(o)) o = fmaxf(o, 0.f);
        }
        a[j] = o;
      }
      IO::store(y + i * kVec, a);
    }
  }
}

// pass 4: dx from dy and x, with the (mesh-summed) backward sums
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    bn_train_backward_elementwise_kernel(
        const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
        long long n_vec, int C, const float* __restrict__ sums,
        const float* __restrict__ gsums, const T* __restrict__ weight,
        const T* __restrict__ bias, float eps, bool relu) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (first >= n_vec) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int c0 = static_cast<int>(first % (C / kVec)) * kVec;
  const float n = sums[2 * C];
  float mean[kVec], mul[kVec], shift[kVec], k1[kVec], c2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = c0 + j;
    const Moments m = moments_of(sums, C, c, eps);
    mean[j] = m.mean;
    mul[j] = __fmul_rn(m.inv, vct::to_f32(weight[c]));
    shift[j] = vct::to_f32(bias[c]);
    k1[j] = __fdiv_rn(gsums[c], n);
    // the clamp passes no gradient where the raw variance is below 0
    c2[j] = m.raw >= 0.f
                ? __fdiv_rn(__fmul_rn(__fmul_rn(m.inv, m.inv), gsums[C + c]),
                            n)
                : 0.f;
  }
  using IO = vct::VecIO<T, kVec>;
  constexpr int kUnroll = kVec == 1 ? 4 : 2;
  for (long long v = first; v < n_vec; v += kUnroll * stride) {
    typename IO::Raw rg[kUnroll], rx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i < n_vec) {
        rg[u] = IO::load(dy + i * kVec);
        rx[u] = IO::load(x + i * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i >= n_vec) break;
      float a[kVec], b[kVec];
      IO::unpack(rg[u], a);
      IO::unpack(rx[u], b);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g = masked<T>(a[j], b[j], mean[j], mul[j], shift[j], relu);
        const float d = b[j] - mean[j];
        a[j] = mul[j] * (g - k1[j] - d * c2[j]);
      }
      IO::store(dx + i * kVec, a);
    }
  }
}

// ---------------------------------------------------------------------------
// launch plans

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// the reduce passes' grid for rows x C of kVec-value vectors
struct Plan {
  int tx_log2, gx, gy;
};

Plan plan(long long rows, int C, int kvec) {
  const int c_vec = C / kvec;
  const int cap = kvec == 1 ? 32 : 8;
  Plan p{0, 0, 0};
  while ((1 << p.tx_log2) < std::min(c_vec, cap)) ++p.tx_log2;
  const int tx = 1 << p.tx_log2, ty = kThreads / tx;
  p.gx = (c_vec + tx - 1) / tx;
  const long long most = std::max<long long>(
      1, (rows + static_cast<long long>(ty) * kMinRows - 1) /
             (static_cast<long long>(ty) * kMinRows));
  const long long want =
      std::max<long long>(1, sm_count() * kBlocksPerSm / p.gx);
  p.gy = static_cast<int>(std::min(most, want));
  return p;
}

// a reduce pass's workspace (float32 elements, 8-byte aligned as
// torch allocates it): the gy x 2 x C float64 partials, then gx counters
long long workspace_floats(const Plan& p, int C) {
  return static_cast<long long>(p.gy) * 4 * C + p.gx;
}

unsigned int* counters(const Plan& p, int C, float* ws) {
  return reinterpret_cast<unsigned int*>(
      ws + static_cast<long long>(p.gy) * 4 * C);
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// the elementwise passes' grid: the resident blocks of `kernel`, rounded
// up to a stride that is a multiple of c_vec, or fewer where the tensor
// has fewer vectors
template <typename K>
int elementwise_grid(K kernel, int* resident, long long n_vec, int c_vec,
                     unsigned* grid) {
  if (*resident == 0) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    *resident = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (n_vec + kThreads - 1) / kThreads;
  const long long m = c_vec / gcd(c_vec, kThreads);
  *grid = static_cast<unsigned>(
      std::min(need, (*resident + m - 1) / m * m));
  return 0;
}

template <typename T>
bool wide(int C, std::initializer_list<const void*> planes) {
  if (C % vct::Vec16<T>::kN != 0) return false;
  for (const void* p : planes)
    if (!vct::aligned16(p)) return false;
  return true;
}

template <typename T, int kVec>
int moments(const T* x, long long rows, int C, float* ws, float* sums,
            cudaStream_t st) {
  const Plan p = plan(rows, C, kVec);
  unsigned int* done = counters(p, C, ws);
  cudaError_t err =
      cudaMemsetAsync(done, 0, sizeof(unsigned int) * p.gx, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_train_moments_reduce_kernel<T, kVec>
      <<<dim3(p.gx, p.gy), kThreads, 0, st>>>(
          x, rows, C, p.tx_log2, reinterpret_cast<double*>(ws), done, sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int apply(const T* x, T* y, long long rows, int C, const float* sums,
          const T* w, const T* b, float eps, bool relu, float* rm, float* rv,
          float keep, float take, cudaStream_t st) {
  static int resident = 0;
  auto kernel = bn_train_apply_elementwise_kernel<T, kVec>;
  const long long n_vec = rows * (C / kVec);
  unsigned grid = 0;
  const int err = elementwise_grid(kernel, &resident, n_vec, C / kVec, &grid);
  if (err) return err;
  kernel<<<std::max(grid, 1u), kThreads, 0, st>>>(
      x, y, n_vec, C, sums, w, b, eps, relu, rm, rv, keep, take);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int backward_sums(const T* dy, const T* x, long long rows, int C,
                  const float* sums, const T* w, const T* b, float eps,
                  bool relu, float* ws, float* gsums, T* dw, T* db,
                  cudaStream_t st) {
  const Plan p = plan(rows, C, kVec);
  unsigned int* done = counters(p, C, ws);
  cudaError_t err =
      cudaMemsetAsync(done, 0, sizeof(unsigned int) * p.gx, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_train_backward_reduce_kernel<T, kVec>
      <<<dim3(p.gx, p.gy), kThreads, 0, st>>>(
          dy, x, rows, C, p.tx_log2, sums, w, b, eps, relu,
          reinterpret_cast<double*>(ws), done, gsums, dw, db);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int backward_apply(const T* dy, const T* x, T* dx, long long rows, int C,
                   const float* sums, const float* gsums, const T* w,
                   const T* b, float eps, bool relu, cudaStream_t st) {
  static int resident = 0;
  auto kernel = bn_train_backward_elementwise_kernel<T, kVec>;
  const long long n_vec = rows * (C / kVec);
  unsigned grid = 0;
  const int err = elementwise_grid(kernel, &resident, n_vec, C / kVec, &grid);
  if (err) return err;
  kernel<<<std::max(grid, 1u), kThreads, 0, st>>>(
      dy, x, dx, n_vec, C, sums, gsums, w, b, eps, relu);
  return static_cast<int>(cudaGetLastError());
}

bool bad(int dtype, long long rows, int C) {
  return C < 1 || rows < 1 || (dtype != vct::kF32 && dtype != vct::kBF16);
}

}  // namespace

// Every entry point takes x (and dy, dx) as rows x C contiguous values of
// `dtype`, the per-channel weight and bias as C values of `dtype`, and
// `sums` as pass 1 left it (2C + 1 float32 values, summed over the ranks
// under a mesh). Each returns cudaGetLastError() after its launch.

// floats of the workspace that passes 1 and 3 need for rows x C
extern "C" long long vct_bn_train_workspace(long long rows, int C) {
  if (C < 1 || rows < 1) return 1;
  long long most = workspace_floats(plan(rows, C, 1), C);
  for (int kvec : {4, 8})
    if (C % kvec == 0)
      most = std::max(most, workspace_floats(plan(rows, C, kvec), C));
  return most;
}

extern "C" int vct_bn_train_moments(int dtype, const void* x, long long rows,
                                    int C, float* ws, float* sums,
                                    void* stream) {
  if (bad(dtype, rows, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32) {
    auto* p = static_cast<const float*>(x);
    return wide<float>(C, {x}) ? moments<float, 4>(p, rows, C, ws, sums, st)
                               : moments<float, 1>(p, rows, C, ws, sums, st);
  }
  auto* p = static_cast<const __nv_bfloat16*>(x);
  return wide<__nv_bfloat16>(C, {x})
             ? moments<__nv_bfloat16, 8>(p, rows, C, ws, sums, st)
             : moments<__nv_bfloat16, 1>(p, rows, C, ws, sums, st);
}

// running_mean / running_var: C float32 values updated as keep * old +
// take * batch value, or null to leave them
extern "C" int vct_bn_train_apply(int dtype, const void* x, void* y,
                                  long long rows, int C, const float* sums,
                                  const void* weight, const void* bias,
                                  float eps, int relu, float* running_mean,
                                  float* running_var, float keep, float take,
                                  void* stream) {
  if (bad(dtype, rows, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = relu != 0;
  if (dtype == vct::kF32) {
    using T = float;
    auto run = wide<T>(C, {x, y}) ? apply<T, 4> : apply<T, 1>;
    return run(static_cast<const T*>(x), static_cast<T*>(y), rows, C, sums,
               static_cast<const T*>(weight), static_cast<const T*>(bias),
               eps, r, running_mean, running_var, keep, take, st);
  }
  using T = __nv_bfloat16;
  auto run = wide<T>(C, {x, y}) ? apply<T, 8> : apply<T, 1>;
  return run(static_cast<const T*>(x), static_cast<T*>(y), rows, C, sums,
             static_cast<const T*>(weight), static_cast<const T*>(bias), eps,
             r, running_mean, running_var, keep, take, st);
}

// gsums: 2C float32 (sum g, sum g * (x - mean)); dw, db: C values of dtype
extern "C" int vct_bn_train_backward_sums(
    int dtype, const void* dy, const void* x, long long rows, int C,
    const float* sums, const void* weight, const void* bias, float eps,
    int relu, float* ws, float* gsums, void* dw, void* db, void* stream) {
  if (bad(dtype, rows, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = relu != 0;
  if (dtype == vct::kF32) {
    using T = float;
    auto run = wide<T>(C, {dy, x}) ? backward_sums<T, 4> : backward_sums<T, 1>;
    return run(static_cast<const T*>(dy), static_cast<const T*>(x), rows, C,
               sums, static_cast<const T*>(weight),
               static_cast<const T*>(bias), eps, r, ws, gsums,
               static_cast<T*>(dw), static_cast<T*>(db), st);
  }
  using T = __nv_bfloat16;
  auto run = wide<T>(C, {dy, x}) ? backward_sums<T, 8> : backward_sums<T, 1>;
  return run(static_cast<const T*>(dy), static_cast<const T*>(x), rows, C,
             sums, static_cast<const T*>(weight), static_cast<const T*>(bias),
             eps, r, ws, gsums, static_cast<T*>(dw), static_cast<T*>(db), st);
}

extern "C" int vct_bn_train_backward_apply(
    int dtype, const void* dy, const void* x, void* dx, long long rows, int C,
    const float* sums, const float* gsums, const void* weight,
    const void* bias, float eps, int relu, void* stream) {
  if (bad(dtype, rows, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = relu != 0;
  if (dtype == vct::kF32) {
    using T = float;
    auto run =
        wide<T>(C, {dy, x, dx}) ? backward_apply<T, 4> : backward_apply<T, 1>;
    return run(static_cast<const T*>(dy), static_cast<const T*>(x),
               static_cast<T*>(dx), rows, C, sums, gsums,
               static_cast<const T*>(weight), static_cast<const T*>(bias),
               eps, r, st);
  }
  using T = __nv_bfloat16;
  auto run =
      wide<T>(C, {dy, x, dx}) ? backward_apply<T, 8> : backward_apply<T, 1>;
  return run(static_cast<const T*>(dy), static_cast<const T*>(x),
             static_cast<T*>(dx), rows, C, sums, gsums,
             static_cast<const T*>(weight), static_cast<const T*>(bias), eps,
             r, st);
}
