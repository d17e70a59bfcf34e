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
// Design of K3. The first K3 gave a thread one (d, b) column and walked
// the tokens: each warp load moved 64 bytes in bf16, the stream counts and
// weights were read at run time inside the token loop, so few loads were
// in flight, and its (b / 32, d / 8) grid left a tail (1.32 TB/s of the
// card's 3.35). The weights are per stream, not per channel, so output
// token t is a weighted sum of whole (d, b) planes, one per stream:
//   out[t, :] = sum_s w_s * y_s[row_s(t), :]
// and K3 now works on each plane as one flat vector of d * b values:
// - a thread owns 16 bytes of one token's plane (8 bf16 or 4 float32
//   values), where d * b is a multiple of that and every plane starts
//   16-byte aligned (at the serving and train shapes in both dtypes); the
//   scalar instance takes one value a thread elsewhere;
// - grid (plane chunks of 256 threads, L): a block's threads share one
//   token, so its stream rows inv_s[t] are the same broadcast loads for
//   all of them, cached in L1; no shared memory and no barrier;
// - the main path's 6 + 4 streams are fixed at compile time: the weights
//   go to registers, and all 10 16-byte loads of a thread are issued
//   before its first FMA (160 bytes in flight a thread); other stream
//   counts are read at run time;
// - 81 x 267 = 21,627 blocks at serving stage 1 in bf16, dozens of waves,
//   so the last one is a small share.
// K3 reads each input row exactly once (the orders are permutations).
//
// Design of K2 (the first K2 staged a (L, 4, 32) float32 tile, read each
// tap as two dependent shared loads, took SiLU by expf and an IEEE
// division, and stored 2 bytes per thread):
// - The block stages its whole (L, 2 channels, 64 sequences) tile of u in
//   shared memory once, in u's dtype (bf16 values are exact in bf16), so u
//   crosses the memory bus once for all the streams: 20.7 KB at L = 81 in
//   bf16, where the first K2's float32 tile of as many columns took
//   41.5 KB.
// - A thread owns two neighbouring sequences of one channel: each gathered
//   row is one 4-byte (bf16) or 8-byte (float32) shared load, and each
//   output row one packed store, 128 bytes per warp in bf16 (odd b falls
//   back to two scalar stores where a pair is not aligned).
// - A sliding window in registers: walking an order's tokens, the last K
//   gathered values (K = 4, or 8 for k > 4; the k taps sit at its end,
//   zero weights before them) serve both streams of the order. At token t
//   the forward output t and the reverse output t - K + 1 read the same K
//   values, so each gathered row costs one order lookup (a broadcast), one
//   shared load and K FMAs per stream. The walk runs K - 1 tokens past the
//   end on zeros and predicates its stores, so its loop body has no
//   branch and the compiler interleaves the unrolled tokens.
// - SiLU as x / (1 + 2^(-x log2 e)) with ex2.approx (denormals flushed)
//   and __fdividef: two MUFU ops.
// The order tables and weights are small int32 / float32 device tensors;
// the ragged batch edge is masked in the kernels, with no padding.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;      // sequences per block
constexpr int kConvRows = 2;    // channels per block in K2
constexpr int kConvLanes = 2 * kLanes;   // sequences per K2 block
constexpr int kSumThreads = 256; // threads per block in K3
constexpr int kMaxTaps = 8;

__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.f + vct::ex2_approx(-1.4426950408889634f * x));
}

// kEven: b is even, so every thread's pair of sequences is in range and
// every pair of outputs is aligned for one packed store
template <typename T, int K, bool kEven>
__global__ void __launch_bounds__(kLanes * kConvRows)
dir_conv_silu_kernel(const T* __restrict__ u, const float* __restrict__ cw,
                     const float* __restrict__ cb,
                     const int* __restrict__ orders,
                     const int* __restrict__ rev_rows,
                     T* __restrict__ fwd, T* __restrict__ rev,
                     int L, int d, int b, int nb, int nr, int k) {
  using P = typename vct::PairOf<T>::type;
  constexpr int kThreads = kLanes * kConvRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);          // [L][rows][kConvLanes]
  int* sord = reinterpret_cast<int*>(su + static_cast<size_t>(L) * kConvRows *
                                              kConvLanes);    // [nb][L]
  int* sslot = sord + nb * L;       // [nb]: each order's reverse stream or -1

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * kLanes + lane;
  const int b0 = blockIdx.x * kConvLanes;
  const int d0 = blockIdx.y * kConvRows;
  const size_t seq = static_cast<size_t>(d) * b;

  for (int idx = tid; idx < nb * L; idx += kThreads) sord[idx] = orders[idx];
  for (int o = tid; o < nb; o += kThreads) {
    int slot = -1;
    for (int j = 0; j < nr; ++j)
      if (rev_rows[j] == o) slot = j;
    sslot[o] = slot;
  }
  for (int idx = tid; idx < L * kConvRows * kConvLanes; idx += kThreads) {
    const int l = idx % kConvLanes;
    const int r = (idx / kConvLanes) % kConvRows;
    const int t = idx / (kConvLanes * kConvRows);
    const int bb = b0 + l;
    const int dd = d0 + r;
    su[idx] = (bb < b && dd < d)
                  ? u[t * seq + static_cast<size_t>(dd) * b + bb]
                  : vct::from_f32<T>(0.f);
  }
  __syncthreads();
  const int di = d0 + row;
  const int bi = b0 + 2 * lane;
  if (bi >= b || di >= d) return;
  const bool v1 = bi + 1 < b;

  // tap j of the window weighs the value K - 1 - j tokens back
  float w[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    w[j] = j >= K - k ? cw[(j - (K - k)) * d + di] : 0.f;
  const float bias = cb[di];
  const size_t col = static_cast<size_t>(di) * b + bi;
  const P* mine = reinterpret_cast<const P*>(su) + row * kLanes + lane;
  constexpr int kStride = kConvRows * kLanes;      // pairs per token

  // One walk over an order's tokens; the window holds pu[t - K + 1 .. t].
  // At token t it gives forward output t and (kRev) reverse output
  // t - K + 1. The walk runs K - 1 tokens past the end on zeros, so the
  // loop body has no branch: the outputs outside [0, L) are computed and
  // not stored.
  auto walk = [&](const int* ord, T* out_f, T* out_r, auto rev_on) {
    constexpr bool kRev = decltype(rev_on)::value;
    float2 win[K];
#pragma unroll
    for (int j = 0; j < K; ++j) win[j] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int t = 0; t < L + K - 1; ++t) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
      const float2 got = vct::PairOf<T>::unpack(mine[ord[min(t, L - 1)] * kStride]);
      win[K - 1] = t < L ? got : make_float2(0.f, 0.f);
      float x0 = bias, x1 = bias;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        x0 = fmaf(w[j], win[j].x, x0);
        x1 = fmaf(w[j], win[j].y, x1);
      }
      if (t < L)
        vct::store_pair<T, kEven>(out_f + t * seq, silu_fast(x0),
                                  silu_fast(x1), v1);
      if constexpr (kRev) {
        const int s = t - (K - 1);
        float r0 = bias, r1 = bias;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          r0 = fmaf(w[j], win[K - 1 - j].x, r0);
          r1 = fmaf(w[j], win[K - 1 - j].y, r1);
        }
        if (s >= 0)
          vct::store_pair<T, kEven>(out_r + s * seq, silu_fast(r0),
                                    silu_fast(r1), v1);
      }
    }
  };
  for (int o = 0; o < nb; ++o) {
    const int slot = sslot[o];
    T* out_f = fwd + static_cast<size_t>(o) * L * seq + col;
    if (slot >= 0)
      walk(sord + o * L, out_f, rev + static_cast<size_t>(slot) * L * seq + col,
           std::true_type{});
    else
      walk(sord + o * L, out_f, out_f, std::false_type{});
  }
}

// One thread: kVec neighbouring values of one token's (d, b) plane. Grid
// (plane chunks, L): every thread of a block shares its token, so the
// stream rows it gathers are the same broadcast loads for all of them.
// NB, NR: stream counts fixed at compile time (all NB + NR loads issued
// before the first FMA, weights in registers), or -1 to read nb, nr.
template <typename T, int kVec, int NB, int NR>
__global__ void __launch_bounds__(kSumThreads)
inv_perm_weighted_sum_kernel(const T* __restrict__ yf,
                             const T* __restrict__ yr,
                             const float* __restrict__ wf,
                             const float* __restrict__ wr,
                             const int* __restrict__ inv,
                             const int* __restrict__ rev_rows,
                             T* __restrict__ out, int L, long long n,
                             int nb, int nr) {
  using IO = vct::VecIO<T, kVec>;
  const long long e =
      (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) * kVec;
  if (e >= n) return;
  const int t = blockIdx.y;
  const size_t stream = static_cast<size_t>(L) * n;
  float acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.f;
  // this thread's values of stream i's (forward) or j's (reverse) row that
  // lands on token t
  auto fwd_at = [&](int i) {
    return yf + i * stream + static_cast<size_t>(inv[i * L + t]) * n + e;
  };
  auto rev_at = [&](int j) {
    return yr + j * stream +
           static_cast<size_t>(inv[rev_rows[j] * L + t]) * n + e;
  };
  auto add = [&](const typename IO::Raw& raw, float w) {
    float x[kVec];
    IO::unpack(raw, x);
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = fmaf(w, x[c], acc[c]);
  };
  // forward streams first, then reverse ones, as the TPU kernel adds them
  if constexpr (NB >= 0) {
    constexpr int kS = NB + NR;
    typename IO::Raw raw[kS];
    float w[kS];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      raw[i] = IO::load(fwd_at(i));
      w[i] = wf[i];
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      raw[NB + j] = IO::load(rev_at(j));
      w[NB + j] = wr[j];
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) add(raw[s], w[s]);
  } else {
#pragma unroll 2
    for (int i = 0; i < nb; ++i) add(IO::load(fwd_at(i)), wf[i]);
#pragma unroll 2
    for (int j = 0; j < nr; ++j) add(IO::load(rev_at(j)), wr[j]);
  }
  IO::store(out + t * n + e, acc);
}

template <typename T, int K, bool kEven>
int launch_conv(const void* u, const float* cw, const float* cb,
                const int* orders, const int* rev_rows, void* fwd, void* rev,
                int L, int d, int b, int nb, int nr, int k, size_t smem,
                cudaStream_t stream) {
  const auto kernel = dir_conv_silu_kernel<T, K, kEven>;
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kLanes, kConvRows);
  dim3 grid((b + kConvLanes - 1) / kConvLanes,
            (d + kConvRows - 1) / kConvRows);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), cw, cb, orders, rev_rows, static_cast<T*>(fwd),
      static_cast<T*>(rev), L, d, b, nb, nr, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_taps(const void* u, const float* cw, const float* cb,
            const int* orders, const int* rev_rows, void* fwd, void* rev,
            int L, int d, int b, int nb, int nr, int k, cudaStream_t stream) {
  const size_t smem = sizeof(T) * L * kConvRows * kConvLanes +
                      sizeof(int) * (nb * L + nb);
  const bool even = b % 2 == 0;
  if (k <= 4 && even)
    return launch_conv<T, 4, true>(u, cw, cb, orders, rev_rows, fwd, rev, L,
                                   d, b, nb, nr, k, smem, stream);
  if (k <= 4)
    return launch_conv<T, 4, false>(u, cw, cb, orders, rev_rows, fwd, rev, L,
                                    d, b, nb, nr, k, smem, stream);
  if (even)
    return launch_conv<T, kMaxTaps, true>(u, cw, cb, orders, rev_rows, fwd,
                                          rev, L, d, b, nb, nr, k, smem,
                                          stream);
  return launch_conv<T, kMaxTaps, false>(u, cw, cb, orders, rev_rows, fwd,
                                         rev, L, d, b, nb, nr, k, smem,
                                         stream);
}

template <typename T, int kVec, int NB, int NR>
int launch_sum(const void* yf, const void* yr, const float* wf,
               const float* wr, const int* inv, const int* rev_rows,
               void* out, int L, long long n, int nb, int nr,
               cudaStream_t stream) {
  const long long chunks = (n / kVec + kSumThreads - 1) / kSumThreads;
  dim3 grid(static_cast<unsigned>(chunks), L);
  inv_perm_weighted_sum_kernel<T, kVec, NB, NR><<<grid, kSumThreads, 0,
                                                  stream>>>(
      static_cast<const T*>(yf), static_cast<const T*>(yr), wf, wr, inv,
      rev_rows, static_cast<T*>(out), L, n, nb, nr);
  return static_cast<int>(cudaGetLastError());
}

// the 16-byte instance where every plane starts 16-byte aligned, the
// compile-time instance for the main path's 6 + 4 streams
template <typename T>
int by_width(const void* yf, const void* yr, const float* wf,
             const float* wr, const int* inv, const int* rev_rows, void* out,
             int L, long long n, int nb, int nr, cudaStream_t stream) {
  constexpr int kV = vct::Vec16<T>::kN;
  const bool wide = n % kV == 0 && vct::aligned16(yf) &&
                    (nr == 0 || vct::aligned16(yr)) && vct::aligned16(out);
  const bool main = nb == 6 && nr == 4;
  if (wide && main)
    return launch_sum<T, kV, 6, 4>(yf, yr, wf, wr, inv, rev_rows, out, L, n,
                                   nb, nr, stream);
  if (wide)
    return launch_sum<T, kV, -1, -1>(yf, yr, wf, wr, inv, rev_rows, out, L,
                                     n, nb, nr, stream);
  if (main)
    return launch_sum<T, 1, 6, 4>(yf, yr, wf, wr, inv, rev_rows, out, L, n,
                                  nb, nr, stream);
  return launch_sum<T, 1, -1, -1>(yf, yr, wf, wr, inv, rev_rows, out, L, n,
                                  nb, nr, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return by_taps<float>(u, cw, cb, orders, rev_rows, fwd, rev, L, d, b, nb,
                          nr, k, st);
  if (dtype == vct::kBF16)
    return by_taps<__nv_bfloat16>(u, cw, cb, orders, rev_rows, fwd, rev, L, d,
                                  b, nb, nr, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vct_inv_perm_weighted_sum(int dtype, const void* yf,
                                         const void* yr, const float* wf,
                                         const float* wr, const int* inv,
                                         const int* rev_rows, void* out,
                                         int L, int d, int b, int nb, int nr,
                                         void* stream) {
  if (nb < 1 || nr < 0 || nr > nb || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0 || d == 0 || b == 0) return 0;
  const long long n = static_cast<long long>(d) * b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return by_width<float>(yf, yr, wf, wr, inv, rev_rows, out, L, n, nb, nr,
                           st);
  if (dtype == vct::kBF16)
    return by_width<__nv_bfloat16>(yf, yr, wf, wr, inv, rev_rows, out, L, n,
                                   nb, nr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
