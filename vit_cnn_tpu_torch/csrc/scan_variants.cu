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
// (b, t, d) element, ~7 bytes of traffic in bf16), so the exp rate: at
// serving stage 1 (6 x 7,588 sequences, L 81, d 72, n 16) 4.25 G exps,
// 1.012 ms at the special-function units' ~4.2e12 exp/s.
//
// Design: the layout's advantage is the broadcast. Threads run along d of
// one sequence: thread k of a block owns channels kR .. kR + R - 1 of
// sequence k / ceil(d / R) (R = 2 channels a thread in bf16, 1 in
// float32, where 2 leave it short of registers), so B_t and C_t
// are the same for every thread of a sequence and each read of them
// serves R channels. Per channel and step that leaves n MUFU.EX2 (A is
// pre-scaled by log2 e once, so each exp is one ex2.approx), ~4n FMA-pipe
// ops and a few 16-byte shared loads: under the ~8n instructions an SM
// issues while its special-function units take the n exps, so the exps,
// not the issue rate, bound it (K1, lane-major, spends ~2n per-lane loads
// of B and C a channel-step and is issue bound).
// - A block holds `seqs` whole sequences: the smallest block of 128 or
//   256 threads whose lanes are at least 90% busy (d 128: 2 sequences, 128
//   threads; d 72: 7, 252 of 256), at least one sequence. With ~128
//   registers a thread two blocks of 256 fit an SM, where one of 288
//   would be alone. The
//   ragged batch edge, channels past d and lanes past seqs x ceil(d / R)
//   are masked in the kernel.
// - B and C of the block's sequences are staged per chunk of 8 steps in
//   bf16, 4 in float32 (kChunkBytes of u a channel)
//   into shared memory as [seq][step][16] raw values (T), each sequence's
//   rows padded by 16 bytes so that the 2-3 sequences a warp spans read
//   different banks. Where n = 16 and B, C are 16-byte aligned, one
//   sequence's chunk is steps x 16 contiguous values in device memory and
//   moves by 16-byte cp.async copies; otherwise value by value, zero past
//   n. Two buffers: the next chunk's copies are in flight while this one
//   computes (one barrier a chunk). The thread-to-word maps divide by
//   compile-time powers of two only.
// - Each step reads B_t and C_t as 16-byte broadcasts: every lane of a
//   sequence reads the same words.
// - u and dt are loaded a chunk ahead of use into registers and kept
//   raw (bf16 pairs where d is even and the pointers aligned; else R
//   scalars, as K1 does) until consumed; y is stored the same way.
// - The output sum runs in two partial sums (even and odd states), to
//   halve its dependent chain.
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ablation
// scan_bm, each step a copy of this file with that step undone, timed beside
// the committed form; serving stage 1, bf16): the first design (one channel a
// thread, precise expf, u and dt loaded at their step, B and C staged value by
// value with a division each) took 4.10 ms; this form 1.81 (55.8% of the
// bound), below K1's 2.16 on the same sequences in their lane-major layout, and
// 1.76 in float32 (K1 2.26). expf instead of ex2.approx costs 46%; u and dt
// loaded at their step 12%; one staging buffer 4%; one channel a thread in bf16
// 43% (twice the B and C reads a channel); in float32, where 2 channels a
// thread are short of registers, one is as fast and 4-step chunks are 17%
// faster than 2 (8 would spill under the 64-register cap of 1,024-thread
// blocks); 4-step chunks in bf16 4%. Blocks of 256 threads instead of 128 at
// d = 128 cost 8%. What holds it at 56% of the exp bound is not measured (no
// profiler of stalls on the card); with ~124 registers a thread an SM keeps 16
// warps, few for the latency of each step's chains.
#include "common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace {

constexpr int kMaxN = 16;
constexpr int kMaxD = 1024;
// the design constants (each one a step of its ablation in PERF.md)
constexpr int kRBytes = 4;         // u (dt, y) bytes a thread a step
constexpr int kChunkBytes = 16;    // u (and dt) bytes a channel a buffer
constexpr int kMinThreads = 128;      // threads a block, tried first
constexpr int kTargetThreads = 256;   // threads a block, at most
constexpr int kMaxSeqs = 32;
constexpr int kGroup = 8;              // states a read of B and C serves

// channels a thread: 2 in bf16 (one packed pair), 1 in float32, so that
// the state and the u and dt loaded a chunk ahead take the same registers
// in both
template <typename T>
__host__ __device__ constexpr int channels() {
  return kRBytes / static_cast<int>(sizeof(T)) > 1
             ? kRBytes / static_cast<int>(sizeof(T))
             : 1;
}

// steps of B and C a staging buffer: 8 in bf16, 4 in float32, whose one
// channel a thread (up to 1,024 threads a block, so at most 64 registers)
// would spill u and dt held 8 steps ahead
template <typename T>
__host__ __device__ constexpr int chunk_steps() {
  return kChunkBytes / static_cast<int>(sizeof(T));
}

// T values of one staged sequence: a chunk's rows of 16, padded by 16 bytes
template <typename T>
__host__ __device__ constexpr int seq_stride() {
  return chunk_steps<T>() * kMaxN + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
size_t staged_bytes(int seqs) {
  return sizeof(T) * 2 * 2 * seqs * seq_stride<T>();   // B, C; 2 buffers
}

// R raw values of one tensor at one step: one packed word where kPairs
template <typename T, int R, bool kPairs>
struct Raw {
  using P = typename vct::PairOf<T>::type;
  static constexpr bool kPacked = kPairs && R == 2;
  std::conditional_t<kPacked, P, T[R]> v;

  __device__ __forceinline__ void load(const T* p, int valid) {
    if constexpr (kPacked) {
      v = *reinterpret_cast<const P*>(p);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = r < valid ? p[r] : vct::from_f32<T>(0.f);
    }
  }
  __device__ __forceinline__ void get(float (&x)[R]) const {
    if constexpr (kPacked) {
      const float2 f = vct::PairOf<T>::unpack(v);
      x[0] = f.x;
      x[1] = f.y;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = vct::to_f32(v[r]);
    }
  }
};

// kGroup staged values of T at p (16-byte aligned) as float32
template <typename T>
__device__ __forceinline__ void read_group(const T* p, float (&x)[kGroup]) {
  constexpr int kN = vct::Vec16<T>::kN;
#pragma unroll
  for (int w = 0; w < kGroup / kN; ++w)
    vct::Vec16<T>::unpack(reinterpret_cast<const uint4*>(p)[w], x + w * kN);
}

// Stage B and C of steps [c0, c0 + tc) of the block's sequences into one
// buffer (sB, sC: [seqs][seq_stride]). kBulk: n = 16, 16-byte cp.async
// copies (the caller waits); else plain loads, zero past n and tc.
template <typename T, bool kBulk>
__device__ __forceinline__ void stage_chunk(T* sB, T* sC, const T* Bm,
                                            const T* Cm, long long first,
                                            int seqs, int b, int L, int n,
                                            int c0, int tc) {
  constexpr int kS = seq_stride<T>(), kChunk = chunk_steps<T>();
  if constexpr (kBulk) {
    constexpr int kWords = kChunk * kMaxN * sizeof(T) / 16;  // a sequence
    constexpr int kStepWords = kMaxN * sizeof(T) / 16;
#pragma unroll
    for (int tensor = 0; tensor < 2; ++tensor)
      for (int idx = threadIdx.x; idx < seqs * kWords; idx += blockDim.x) {
        const int s = idx / kWords, w = idx % kWords;
        const long long bb = first + s;
        if (bb >= b || w >= tc * kStepWords) continue;
        const size_t off = (static_cast<size_t>(bb) * L + c0) * kMaxN;
        const T* src = (tensor ? Cm : Bm) + off;
        T* dst = (tensor ? sC : sB) + s * kS;
        vct::cp_async<16>(reinterpret_cast<uint4*>(dst) + w,
                          reinterpret_cast<const uint4*>(src) + w);
      }
  } else {
    constexpr int kPer = kChunk * kMaxN;
    for (int idx = threadIdx.x; idx < seqs * kPer; idx += blockDim.x) {
      const int s = idx / kPer, e = idx % kPer;
      const int tt = e / kMaxN, i = e % kMaxN;
      const long long bb = first + s;
      T bv = vct::from_f32<T>(0.f), cv = bv;
      if (bb < b && tt < tc && i < n) {
        const size_t off = (static_cast<size_t>(bb) * L + c0 + tt) * n + i;
        bv = Bm[off];
        cv = Cm[off];
      }
      sB[s * kS + e] = bv;
      sC[s * kS + e] = cv;
    }
  }
}

template <typename T, int R, bool kPairs, bool kBulk>
__global__ void __launch_bounds__(kMaxD / R)
scan_batch_major_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                        const float* __restrict__ A,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const float* __restrict__ Dv, T* __restrict__ y,
                        int L, int d, int n, int b, int seqs) {
  constexpr int kS = seq_stride<T>(), kChunk = chunk_steps<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);        // [2][seqs][kS]
  T* sC = sB + 2 * seqs * kS;

  const int per_seq = (d + R - 1) / R;           // threads a sequence
  const int sl = threadIdx.x / per_seq;
  const int d0 = (threadIdx.x - sl * per_seq) * R;
  const long long first = static_cast<long long>(blockIdx.x) * seqs;
  const long long bi = first + sl;
  const bool active = sl < seqs && bi < b;
  const int valid = active ? min(R, d - d0) : 0;

  float a[R][kMaxN], h[R][kMaxN], dv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dv[r] = r < valid ? Dv[d0 + r] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) {
      a[r][i] =
          (r < valid && i < n) ? A[(d0 + r) * n + i] * vct::kLog2e : 0.f;
      h[r][i] = 0.f;
    }
  }
  const size_t base = active ? (static_cast<size_t>(bi) * L) * d + d0 : 0;
  const T* us = u + base;
  const T* dts = dt + base;
  T* ys = y + base;

  // u and dt of the first chunk (then of the next, as each step consumes)
  Raw<T, R, kPairs> ru[kChunk], rdt[kChunk];
  if (active)
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt)
      if (tt < L) {
        ru[tt].load(us + static_cast<size_t>(tt) * d, valid);
        rdt[tt].load(dts + static_cast<size_t>(tt) * d, valid);
      }

  const int chunks = (L + kChunk - 1) / kChunk;
  stage_chunk<T, kBulk>(sB, sC, Bm, Cm, first, seqs, b, L, n, 0,
                        min(kChunk, L));
  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * kChunk, tc = min(kChunk, L - c0);
    const int buf = c & 1;
    vct::cp_async_wait_all();
    __syncthreads();   // chunk c visible; chunk c - 1's buffer free
    if (c + 1 < chunks) {
      const int nb = (c + 1) & 1;
      stage_chunk<T, kBulk>(sB + nb * seqs * kS, sC + nb * seqs * kS, Bm,
                            Cm, first, seqs, b, L, n, c0 + kChunk,
                            min(kChunk, L - c0 - kChunk));
    }
    if (!active) continue;
    const T* cB = sB + (buf * seqs + sl) * kS;
    const T* cC = sC + (buf * seqs + sl) * kS;
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt >= tc) break;
      const size_t off = static_cast<size_t>(c0 + tt) * d;
      const Raw<T, R, kPairs> xu = ru[tt], xdt = rdt[tt];
      if (c0 + tt + kChunk < L) {                // a chunk ahead of use
        ru[tt].load(us + off + static_cast<size_t>(kChunk) * d, valid);
        rdt[tt].load(dts + off + static_cast<size_t>(kChunk) * d, valid);
      }
      float uv[R], dtv[R], du[R], acc[R][2];
      xu.get(uv);
      xdt.get(dtv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        du[r] = dtv[r] * uv[r];
        acc[r][0] = acc[r][1] = 0.f;
      }
#pragma unroll
      for (int i0 = 0; i0 < kMaxN; i0 += kGroup) {
        if (!kBulk && i0 >= n) break;
        float bv[kGroup], cv[kGroup];
        read_group(cB + tt * kMaxN + i0, bv);
        read_group(cC + tt * kMaxN + i0, cv);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int i = i0 + j;
          if (!kBulk && i >= n) break;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float x = dtv[r] * a[r][i];
            const float e = vct::ex2_approx(x);
            h[r][i] = fmaf(e, h[r][i], du[r] * bv[j]);
            acc[r][i & 1] = fmaf(cv[j], h[r][i], acc[r][i & 1]);
          }
        }
      }
      float out[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        out[r] = acc[r][0] + acc[r][1] + dv[r] * uv[r];
      if constexpr (Raw<T, R, kPairs>::kPacked) {
        vct::store_pair<T, true>(ys + off, out[0], out[1], true);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < valid) ys[off + r] = vct::from_f32<T>(out[r]);
      }
    }
  }
}

template <typename T, bool kPairs, bool kBulk>
int launch_batch_major(const void* u, const void* dt, const float* A,
                       const void* B, const void* C, const float* D, void* y,
                       int L, int d, int n, int b, cudaStream_t stream) {
  // the smallest block of whole sequences, from kMinThreads up to
  // kTargetThreads threads, whose lanes are at least 90% busy
  constexpr int R = channels<T>();
  const int per_seq = (d + R - 1) / R;
  int seqs = 1, threads = 32;
  for (int target = kMinThreads; target <= kTargetThreads; target *= 2) {
    seqs = target / per_seq;
    seqs = seqs < 1 ? 1 : seqs > kMaxSeqs ? kMaxSeqs : seqs;
    threads = (seqs * per_seq + 31) / 32 * 32;
    if (10 * seqs * per_seq >= 9 * threads) break;
  }
  const size_t smem = staged_bytes<T>(seqs);
  const long long blocks = (static_cast<long long>(b) + seqs - 1) / seqs;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = scan_batch_major_kernel<T, R, kPairs, kBulk>;
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), L, d, n, b, seqs);
  return static_cast<int>(cudaGetLastError());
}

// kPairs: 2 channels a thread, d even and u, dt, y aligned for a pair of
// T; kBulk: n = 16 and B, C 16-byte aligned
template <typename T>
int batch_major_by_fit(const void* u, const void* dt, const float* A,
                       const void* B, const void* C, const float* D, void* y,
                       int L, int d, int n, int b, cudaStream_t st) {
  const uintptr_t pair = 2 * sizeof(T);
  const bool pairs = channels<T>() == 2 && d % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(u) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(dt) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(y) % pair == 0;
  const bool bulk = n == kMaxN && vct::aligned16(B) && vct::aligned16(C);
  if (pairs && bulk)
    return launch_batch_major<T, true, true>(u, dt, A, B, C, D, y, L, d, n,
                                             b, st);
  if (pairs)
    return launch_batch_major<T, true, false>(u, dt, A, B, C, D, y, L, d, n,
                                              b, st);
  if (bulk)
    return launch_batch_major<T, false, true>(u, dt, A, B, C, D, y, L, d, n,
                                              b, st);
  return launch_batch_major<T, false, false>(u, dt, A, B, C, D, y, L, d, n,
                                             b, st);
}

}  // namespace

extern "C" int vct_selective_scan_batch_major(int dtype, const void* u,
                                              const void* dt, const float* A,
                                              const void* B, const void* C,
                                              const float* D, void* y, int L,
                                              int d, int n, int b,
                                              void* stream) {
  if (n < 1 || n > kMaxN || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0 || d == 0 || b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return batch_major_by_fit<float>(u, dt, A, B, C, D, y, L, d, n, b, st);
  if (dtype == vct::kBF16)
    return batch_major_by_fit<__nv_bfloat16>(u, dt, A, B, C, D, y, L, d, n,
                                             b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
