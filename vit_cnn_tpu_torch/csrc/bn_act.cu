// Eval-mode BatchNorm over the last axis of channel-last activations, as
// one elementwise pass that can also take in the preceding conv's bias and
// the ReLU after it (ops/bn_act.py). It replaces no TPU kernel: the JAX
// package leaves the chain to XLA. PyTorch runs it on the card as up to
// seven elementwise kernels (the conv's bias add, the cast to float32, the
// subtract, multiply and add, the cast back, the ReLU) that move ~44 bytes
// an element of a bf16 tensor; this pass moves 4 (bf16) or 8 (float32).
//
// Bound: bytes, one read of x and one write of y; the per-channel vectors
// are a few KB. So the design is about bytes: 16-byte loads and stores (8
// bf16 or 4 float32 values) where C is a multiple of that and both planes
// are 16-byte aligned, one value a thread otherwise (C = 1, 25, 49 in the
// flagship); a grid of the resident blocks whose stride over the tensor is
// a multiple of C, so that each thread keeps the same channels throughout
// and computes its per-channel constants once, into registers; two 16-byte
// loads in flight a thread, or four single values (a sweep at FusAtNet's
// and the flagship's shapes: more 16-byte loads gained nothing, more
// single ones 14% at C = 25).
//
// The arithmetic is the plain chain's, operation by operation, so the
// output equals it bit for bit (NaN and inf included):
//   mul = rsqrt(var + eps) * weight                  float32
//   t   = round_T(x + conv_bias)                     the conv's bias add
//   y   = round_T(((t - mean) * mul) + bias)         no FMA contraction
//   out = isnan(y) ? y : fmax(y, 0)                  torch.relu on y
// with the per-channel vectors in x's dtype, widened exactly. The bias and
// the ReLU are runtime flags, uniform over the launch: timed against
// instances with them compiled in, at FusAtNet's and the flagship's
// shapes, they were within 1.5% either way.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// v rounded to T and widened back: the plain chain's store of T
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return vct::to_f32(vct::from_f32<T>(v));
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) bn_act_elementwise_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long n_vec, int c_vec,
    const T* __restrict__ mean, const T* __restrict__ var,
    const T* __restrict__ weight, const T* __restrict__ bias,
    const T* __restrict__ conv_bias, float eps, bool relu) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (first >= n_vec) return;
  // the stride is a multiple of c_vec (or the loop runs once): the
  // thread's channels are those of its first vector
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int c0 = static_cast<int>(first % c_vec) * kVec;
  const bool has_bias = conv_bias != nullptr;
  float mu[kVec], mul[kVec], shift[kVec], cb[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = c0 + j;
    mu[j] = vct::to_f32(mean[c]);
    mul[j] = __fmul_rn(rsqrtf(__fadd_rn(vct::to_f32(var[c]), eps)),
                       vct::to_f32(weight[c]));
    shift[j] = vct::to_f32(bias[c]);
    cb[j] = has_bias ? vct::to_f32(conv_bias[c]) : 0.f;
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
        float s = a[j];
        if (has_bias) s = round_to<T>(__fadd_rn(s, cb[j]));
        float o =
            __fadd_rn(__fmul_rn(__fsub_rn(s, mu[j]), mul[j]), shift[j]);
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

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int kVec>
int launch(const T* x, T* y, long long n, int C, const T* mean, const T* var,
           const T* weight, const T* bias, const T* conv_bias, float eps,
           bool relu, cudaStream_t stream) {
  auto kernel = bn_act_elementwise_kernel<T, kVec>;
  // the SMs and resident blocks of this instance, asked once a process
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_vec = n / kVec;
  const int c_vec = C / kVec;
  const long long need = (n_vec + kThreads - 1) / kThreads;
  // more vectors than resident threads: round the grid up so that its
  // stride is a multiple of c_vec
  const long long m = c_vec / gcd(c_vec, kThreads);
  const long long grid = std::min(need, (resident + m - 1) / m * m);
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      x, y, n_vec, c_vec, mean, var, weight, bias, conv_bias, eps, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, long long n, int C, const void* mean,
             const void* var, const void* weight, const void* bias,
             const void* conv_bias, float eps, int relu,
             cudaStream_t stream) {
  constexpr int kVec = vct::Vec16<T>::kN;
  const bool wide = C % kVec == 0 && vct::aligned16(x) && vct::aligned16(y);
  auto run = wide ? launch<T, kVec> : launch<T, 1>;
  return run(static_cast<const T*>(x), static_cast<T*>(y), n, C,
             static_cast<const T*>(mean), static_cast<const T*>(var),
             static_cast<const T*>(weight), static_cast<const T*>(bias),
             static_cast<const T*>(conv_bias), eps, relu != 0, stream);
}

}  // namespace

// y = the eval-mode BatchNorm of x (n values, rows of C channels,
// contiguous), optionally after the conv bias (or null) and before a ReLU;
// mean, var, weight, bias and the conv bias are C values each, all in x's
// dtype.
extern "C" int vct_bn_act(int dtype, const void* x, void* y, long long n,
                          int C, const void* mean, const void* var,
                          const void* weight, const void* bias,
                          const void* conv_bias, float eps, int relu,
                          void* stream) {
  if (C < 1 || n < 0 || n % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return dispatch<float>(x, y, n, C, mean, var, weight, bias, conv_bias,
                           eps, relu, st);
  if (dtype == vct::kBF16)
    return dispatch<__nv_bfloat16>(x, y, n, C, mean, var, weight, bias,
                                   conv_bias, eps, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
