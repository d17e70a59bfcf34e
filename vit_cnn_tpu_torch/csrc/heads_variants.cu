// V3 and V4: two other formulations of K8's head-last attention, without
// the residual:
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] * scale)
//                   v[b, j, h, :]
// with q, k, v, o contiguous (B, n, h, hd).
//
// They replace the tuning probes perf/mhst_attn_variants.py `kern_a`,
// `kern_b`, `kern_c`, `kern_f`, `kern_g`, `kern_e` and perf/mhst_attn_vpu.py
// `kern_h`, `kern_g`, which tried, at MHST's pooled-attention shape (16
// heads of 4, n = 65), the other ways of computing K8's function:
// - V3 (`vct_heads_attention_mma`), the matrix-unit formulations, on the
//   tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums):
//   * per head (F): Q.K^T with hd zero-padded to depth 16, P.V with hd
//     padded to a multiple of 8, bf16 operands with float32 sums.
//   * masked (G, the shipped TPU kernel): for each head h, full-width dots
//     over C = h * hd against K with the other heads' channels zeroed, and
//     P_h . (V with the other heads zeroed) summed over the heads into one
//     (n, C) accumulator, as `kern_g` does. It does C / hd times the
//     per-head form's Q.K^T work.
//   P is rounded to bf16 before P.V, as F and G round it. The MMA and
//   online-softmax helpers are csrc/mma.cuh's, shared with K8 and K9.
// - V4 (`vct_heads_attention_outer`), the vector-unit formulations, on the
//   CUDA cores in float32: H's scores as hd rank-1 updates (a q column
//   times a k row per channel), C's broadcast-multiply-sum and E's
//   per-channel product with a one-hot group sum all add the per-channel
//   products q_c k_c of one head; here that sum happens in registers.
//   A and B (per-head dots on inputs cast to float32, float32 P for P.V;
//   A's lane concatenate and B's direct stores are one store on the card)
//   are V4's arithmetic too, not V3's bf16 operands.
//
// What bounds them on the H100: per head and batch row they read 3 n hd
// values and write n hd, and take n^2 exps. At the probe's shape (4,096 x
// 65 tokens, 16 heads of 4, bf16) that is 136 MB (41 us at 3.35 TB/s)
// against 277 M exps (66 us at the special-function units' ~4.2e12 exp/s):
// exp bound once the scores stay on chip. At 4 heads of 16 the bytes win.
//
// Design.
// - V3: one block of 8 warps per batch row. The block stages q and k of all
//   heads as bf16 rows padded to C + 8 and v transposed, (C, n + 8), with
//   n padded to a multiple of 16 and the pad zeroed; the pads put the 8
//   rows or columns a fragment load touches in 8 different bank groups.
//   A warp takes a 16-row query tile (per head: of one head; masked: of all
//   heads), keeps Q's A fragment in registers, and walks 16-key tiles with
//   an online softmax: two m16n8k16 products give the tile's scores in the
//   C-fragment layout, which is the A-fragment layout of P for P.V once
//   rounded to bf16 (no trip through shared memory). Padded keys score
//   -inf. Each row's max and sum reduce over the 4 lanes that hold it.
// - V4: one block per batch row, its K and V staged in shared memory as
//   float32 by 16-byte loads (converted as stored). A thread owns R query
//   rows of one head (R = 8 at HD = 4, 4 at HD = 8, 3 at HD = 16, 2 at 32;
//   HD: hd rounded up to 4, 8, 16 or 32), consecutive threads on
//   consecutive heads, so a warp's reads of a K or V row fall on distinct
//   banks or broadcast, and its q loads from device memory are one
//   contiguous row, read as vectors of hd values and pre-scaled by
//   scale * log2(e) so that each P is one ex2.approx. Where HD <= 8 a
//   first pass over the staged keys takes each row's exact maximum (hd
//   FMAs a score) and the second accumulates P and P.V with no rescale;
//   where HD >= 16 one pass rescales every row once per tile of 4 keys,
//   with no branch. Scores, P and P.V are float32. Each K and V row read
//   from shared memory serves R query rows; the block's threads are sized
//   to the row's h x ceil(n / R) tasks.
//   At MHST's pooled band (16 heads of 4, bf16) the exps bound it at
//   0.122 ms, and ~17 issued instructions a score take ~0.33 ms at the
//   card's instruction rate. Measured there on an H100 (NVIDIA H100
//   80GB HBM3, 700 W; tools/kernel_ablation.py outer, each step against
//   the committed form): the first design, one block a row with K and V
//   as float32 loaded one 2-byte value at a time, q read as scalars and a
//   rescale behind a branch every 4 keys, took 2.83 ms; this form 0.44.
//   The exact-max first pass is worth 13% (0.50 with the online form);
//   staging float32 12% (0.50 with K and V kept bf16 and converted at
//   each read: registers, not shared memory, bound the resident blocks);
//   one block a row 18% (with K and V staged bf16: 0.61 with a persistent
//   grid of resident blocks that overlapped the next row's cp.async copy
//   with this row's compute, 0.50 without; the card's other resident
//   blocks already hide a block's staging); R = 4 instead of 8 at HD = 4
//   changes nothing (0.44). At hd = 16 the 32 FMAs a score hold it at
//   0.54-0.59 ms at the ViT band (SDPA 0.55) and 2.0-2.1 at the
//   SpectralFormer band (SDPA 1.6), 2-2.6x the tensor-core kernels'; there
//   R = 3 (169 registers) is 7-10% faster than R = 4 (221, one block of 5
//   warps an SM) and R = 2 (more K and V reads a score), and 8 keys a
//   rescale instead of 4 do not help.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;
constexpr int kMmaWarps = 8;
constexpr int kMmaMaxHd = 16;
constexpr int kMmaMaxC = 256;
constexpr int kMaskedMaxC = 128;         // the masked accumulator: C / 2 regs
constexpr int kMaxN = 512;
constexpr int kOuterMaxThreads = 256;
constexpr int kOuterMaxHd = 32;
// V4's design constants (each one a step of its ablation in PERF.md)
constexpr int kOuterTile = 4;            // keys a rescale of the online form
constexpr int kExactMaxHd = 8;           // HD <= this: two passes, exact max
constexpr int kRowsHd4 = 8;              // query rows a thread at HD = 4
constexpr int kRowsHd16 = 3;             // query rows a thread at HD = 16

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

size_t mma_smem(int n, int C) {
  const size_t np = pad16(n);
  return sizeof(__nv_bfloat16) * (2 * np * (C + 8) + C * (np + 8));
}

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// V4: bytes of a batch row's K and V staged in shared memory as float32,
// each tensor's rows padded to 16 bytes
size_t outer_smem(int n, int C) {
  return 2 * round16(static_cast<size_t>(n) * C * sizeof(float));
}

// V4: query rows a thread at head width HD
__host__ __device__ constexpr int outer_rows(int HD) {
  return HD <= 4 ? kRowsHd4 : HD <= 8 ? 4 : HD <= 16 ? kRowsHd16 : 2;
}

// a 16-byte word of T values stored at p as float32
template <typename T>
__device__ __forceinline__ void store_word(float* p, const uint4& w) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<uint4*>(p) = w;
  } else {                                    // 8 bf16 values: 32 bytes
    float x[8];
    vct::Vec16<T>::unpack(w, x);
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// HD values of a head's row at p as float32: where kFull (hd == HD, and
// HD values of T aligned at p), as 8- or 16-byte vectors; else hd scalar
// loads, and zeros past hd
template <typename T, int HD, bool kFull>
__device__ __forceinline__ void load_row(const T* p, int hd,
                                         float (&x)[HD]) {
  constexpr int kBytes = HD * sizeof(T);
  if constexpr (kFull && kBytes >= 16) {
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w)
      vct::Vec16<T>::unpack(reinterpret_cast<const uint4*>(p)[w],
                            x + w * vct::Vec16<T>::kN);
  } else if constexpr (kFull) {               // 4 bf16 values: 8 bytes
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = vct::Vec16<T>::two(w.x), b = vct::Vec16<T>::two(w.y);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < HD; ++c) x[c] = c < hd ? vct::to_f32(p[c]) : 0.f;
  }
}

// x * inv stored as a head's row at p, as load_row reads it
template <typename T, int HD, bool kFull>
__device__ __forceinline__ void store_row(T* p, int hd, const float (&x)[HD],
                                          float inv) {
  constexpr int kBytes = HD * sizeof(T);
  float y[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) y[c] = x[c] * inv;
  if constexpr (kFull && kBytes >= 16) {
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w)
      reinterpret_cast<uint4*>(p)[w] =
          vct::Vec16<T>::pack(y + w * vct::Vec16<T>::kN);
  } else if constexpr (kFull) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        vct::Vec16<T>::word(y[0], y[1]), vct::Vec16<T>::word(y[2], y[3]));
  } else {
#pragma unroll
    for (int c = 0; c < HD; ++c)
      if (c < hd) p[c] = vct::from_f32<T>(y[c]);
  }
}

template <bool kMasked>
__global__ void __launch_bounds__(32 * kMmaWarps)
heads_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int n, int h, int hd,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = h * hd, cs = C + 8;
  const int np = pad16(n), vs = np + 8;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + np * cs;
  __nv_bfloat16* sVt = sK + np * cs;          // [C][vs]
  const long long row0 = static_cast<long long>(blockIdx.x) * n * C;

  // stage q, k (row-major) and v (transposed) in bf16 pairs; zero the pads
  const int half_c = C / 2;
  for (int idx = threadIdx.x; idx < np * half_c; idx += blockDim.x) {
    const int j = idx / half_c, c = 2 * (idx - j * half_c);
    uint32_t qv = 0, kv = 0;
    __nv_bfloat162 vv = __floats2bfloat162_rn(0.f, 0.f);
    if (j < n) {
      const long long src = row0 + static_cast<long long>(j) * C + c;
      qv = vct::pair(q + src);
      kv = vct::pair(k + src);
      vv = *reinterpret_cast<const __nv_bfloat162*>(v + src);
    }
    *reinterpret_cast<uint32_t*>(sQ + j * cs + c) = qv;
    *reinterpret_cast<uint32_t*>(sK + j * cs + c) = kv;
    sVt[c * vs + j] = vv.x;
    sVt[(c + 1) * vs + j] = vv.y;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = np / 16;

  if (!kMasked) {
    for (int task = warp; task < h * tiles; task += kMmaWarps) {
      const int head = task / tiles, q0 = (task - head * tiles) * 16;
      const int c0 = head * hd;
      const bool lo = 2 * t < hd, hi = 8 + 2 * t < hd;
      uint32_t qa[4];
      qa[0] = lo ? vct::pair(sQ + (q0 + g) * cs + c0 + 2 * t) : 0u;
      qa[1] = lo ? vct::pair(sQ + (q0 + g + 8) * cs + c0 + 2 * t) : 0u;
      qa[2] = hi ? vct::pair(sQ + (q0 + g) * cs + c0 + 8 + 2 * t) : 0u;
      qa[3] = hi ? vct::pair(sQ + (q0 + g + 8) * cs + c0 + 8 + 2 * t) : 0u;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float acc[2][4] = {};
      for (int kt = 0; kt < tiles; ++kt) {
        const int k0 = 16 * kt;
        float s[2][4] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const __nv_bfloat16* kr = sK + (k0 + 8 * half + g) * cs + c0;
          vct::mma(s[half], qa, lo ? vct::pair(kr + 2 * t) : 0u,
                   hi ? vct::pair(kr + 8 + 2 * t) : 0u);
        }
        float alpha[2];
        uint32_t pa[4];
        vct::softmax_tile(s, k0, n, q0 + 8 < n, scale_log2, m, l, alpha,
                          pa);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (8 * nt >= hd) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
          const int ch = 8 * nt + g;
          const __nv_bfloat16* vr = sVt + (c0 + ch) * vs + k0;
          vct::mma(acc[nt], pa, ch < hd ? vct::pair(vr + 2 * t) : 0u,
                   ch < hd ? vct::pair(vr + 8 + 2 * t) : 0u);
        }
      }
      const float inv[2] = {1.f / vct::quad_sum(l[0]),
                            1.f / vct::quad_sum(l[1])};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col >= hd) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + g + 8 * r;
          if (row < n)
            *reinterpret_cast<uint32_t*>(
                o + row0 + static_cast<long long>(row) * C + c0 + col) =
                vct::pack(acc[nt][2 * r] * inv[r],
                          acc[nt][2 * r + 1] * inv[r]);
        }
      }
    }
    return;
  }

  // masked: a warp takes one 16-row query tile for all heads
  constexpr int kSteps = kMaskedMaxC / 16;    // k16 steps of Q.K^T over C
  constexpr int kTiles = kMaskedMaxC / 8;     // n8 tiles of the output
  const int steps = C / 16, ntiles = C / 8;
  for (int task = warp; task < tiles; task += kMmaWarps) {
    const int q0 = 16 * task;
    uint32_t qa[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const bool on = ks < steps;
      const int c = 16 * ks + 2 * t;
      qa[ks][0] = on ? vct::pair(sQ + (q0 + g) * cs + c) : 0u;
      qa[ks][1] = on ? vct::pair(sQ + (q0 + g + 8) * cs + c) : 0u;
      qa[ks][2] = on ? vct::pair(sQ + (q0 + g) * cs + c + 8) : 0u;
      qa[ks][3] = on ? vct::pair(sQ + (q0 + g + 8) * cs + c + 8) : 0u;
    }
    float acc[kTiles][4] = {};
    for (int head = 0; head < h; ++head) {
      // this head's channels [lo, hi); hd is even, so a pair never straddles
      const int lo = head * hd, hi = lo + hd;
      const auto mine = [lo, hi](int c) { return c >= lo && c < hi; };
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int kt = 0; kt < tiles; ++kt) {
        const int k0 = 16 * kt;
        float s[2][4] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const __nv_bfloat16* kr = sK + (k0 + 8 * half + g) * cs;
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            if (ks >= steps) continue;
            const int c = 16 * ks + 2 * t;
            vct::mma(s[half], qa[ks], mine(c) ? vct::pair(kr + c) : 0u,
                     mine(c + 8) ? vct::pair(kr + c + 8) : 0u);
          }
        }
        float alpha[2];
        uint32_t pa[4];
        vct::softmax_tile(s, k0, n, q0 + 8 < n, scale_log2, m, l, alpha,
                          pa);
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
          if (nt >= ntiles) continue;
          if (mine(8 * nt + 2 * t))            // this head's output columns
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
          const int ch = 8 * nt + g;
          const __nv_bfloat16* vr = sVt + ch * vs + k0;
          vct::mma(acc[nt], pa, mine(ch) ? vct::pair(vr + 2 * t) : 0u,
                   mine(ch) ? vct::pair(vr + 8 + 2 * t) : 0u);
        }
      }
      const float inv[2] = {1.f / vct::quad_sum(l[0]),
                            1.f / vct::quad_sum(l[1])};
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
        if (nt < ntiles && mine(8 * nt + 2 * t))
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= inv[e >> 1];
    }
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      if (nt >= ntiles) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row < n)
          *reinterpret_cast<uint32_t*>(
              o + row0 + static_cast<long long>(row) * C + 8 * nt + 2 * t) =
              vct::pack(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    }
  }
}

// V4: one block per batch row. K and V of the row staged as float32 in
// shared memory, [K | V], each n x C values padded to 16 bytes, by
// 16-byte loads where `vec16`, else value by value. kFull: hd == HD and
// q, o aligned for HD-value vectors.
template <typename T, int HD, bool kFull>
__global__ void __launch_bounds__(kOuterMaxThreads)
heads_outer_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int n, int h,
                   int hd, float scale_log2, int vec16) {
  constexpr int R = outer_rows(HD);
  constexpr int kT = kOuterTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = h * hd;
  const size_t nc = static_cast<size_t>(n) * C;
  const size_t region = round16(nc * sizeof(float));
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = reinterpret_cast<float*>(smem_raw + region);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * nc;

  if (vec16) {
    constexpr int kN = vct::Vec16<T>::kN;        // values a 16-byte word
    const int words = static_cast<int>(nc / kN);
    const uint4* gk = reinterpret_cast<const uint4*>(k + row0);
    const uint4* gv = reinterpret_cast<const uint4*>(v + row0);
#pragma unroll 4
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      const uint4 a = gk[w], b = gv[w];
      store_word<T>(sK + w * kN, a);
      store_word<T>(sV + w * kN, b);
    }
  } else {
    for (size_t i = threadIdx.x; i < nc; i += blockDim.x) {
      sK[i] = vct::to_f32(k[row0 + i]);
      sV[i] = vct::to_f32(v[row0 + i]);
    }
  }
  __syncthreads();

  const T* qb = q + row0;
  T* ob = o + row0;
  const int groups = (n + R - 1) / R;
  for (int task = threadIdx.x; task < h * groups; task += blockDim.x) {
    const int g = task / h, head = task - g * h;
    const int c0 = head * hd, i0 = g * R;
    // rows past n repeat row n - 1 and are not stored
    float qr[R][HD];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      load_row<T, HD, kFull>(
          qb + static_cast<size_t>(min(i0 + r, n - 1)) * C + c0, hd, qr[r]);
#pragma unroll
      for (int c = 0; c < HD; ++c) qr[r][c] *= scale_log2;
    }
    float m[R], l[R], acc[R][HD];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[r][c] = 0.f;
    }
    if constexpr (HD <= kExactMaxHd) {
      // pass 1: each row's exact maximum (base-2 scores)
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float kv[HD];
        load_row<float, HD, kFull>(sK + j * C + c0, hd, kv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) x = fmaf(qr[r][c], kv[c], x);
          m[r] = fmaxf(m[r], x);
        }
      }
      // pass 2: P = 2^(s - m) and P.V, no rescale
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float kv[HD], vv[HD];
        load_row<float, HD, kFull>(sK + j * C + c0, hd, kv);
        load_row<float, HD, kFull>(sV + j * C + c0, hd, vv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = -m[r];
#pragma unroll
          for (int c = 0; c < HD; ++c) x = fmaf(qr[r][c], kv[c], x);
          const float p = vct::ex2_approx(x);
          l[r] += p;
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    } else {
      // one pass; every row rescaled once per tile of kT keys
      auto tile = [&](int j0, auto masked) {
        constexpr bool kMask = decltype(masked)::value;   // keys past n
        float sc[R][kT];
#pragma unroll
        for (int jj = 0; jj < kT; ++jj) {
          const int j = kMask ? min(j0 + jj, n - 1) : j0 + jj;
          float kv[HD];
          load_row<float, HD, kFull>(sK + j * C + c0, hd, kv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float x = 0.f;
#pragma unroll
            for (int c = 0; c < HD; ++c) x = fmaf(qr[r][c], kv[c], x);
            sc[r][jj] = kMask && j0 + jj >= n ? -INFINITY : x;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float mt = m[r];
#pragma unroll
          for (int jj = 0; jj < kT; ++jj) mt = fmaxf(mt, sc[r][jj]);
          const float alpha = vct::ex2_approx(m[r] - mt);
          l[r] *= alpha;
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[r][c] *= alpha;
          m[r] = mt;
        }
#pragma unroll
        for (int jj = 0; jj < kT; ++jj) {
          const int j = kMask ? min(j0 + jj, n - 1) : j0 + jj;
          float vv[HD];
          load_row<float, HD, kFull>(sV + j * C + c0, hd, vv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = vct::ex2_approx(sc[r][jj] - m[r]);
            l[r] += p;
#pragma unroll
            for (int c = 0; c < HD; ++c)
              acc[r][c] = fmaf(p, vv[c], acc[r][c]);
          }
        }
      };
      int j0 = 0;
      for (; j0 + kT <= n; j0 += kT) tile(j0, std::false_type());
      if (j0 < n) tile(j0, std::true_type());
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r < n)
        store_row<T, HD, kFull>(ob + static_cast<size_t>(i0 + r) * C + c0,
                                hd, acc[r], 1.f / l[r]);
  }
}

template <bool kMasked>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int n, int h, int hd, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem(n, h * hd);
  cudaError_t err = vct::allow_smem(heads_mma_kernel<kMasked>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_mma_kernel<kMasked><<<B, 32 * kMmaWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n, h, hd, scale * vct::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, bool kFull>
int launch_outer(const void* q, const void* k, const void* v, void* o, int B,
                 int n, int h, int hd, float scale, cudaStream_t stream) {
  const int C = h * hd;
  const size_t smem = outer_smem(n, C);
  const auto kernel = heads_outer_kernel<T, HD, kFull>;
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // threads sized to the row's tasks, in as few rounds as 256 allow
  constexpr int R = outer_rows(HD);
  const int tasks = h * ((n + R - 1) / R);
  const int rounds = (tasks + kOuterMaxThreads - 1) / kOuterMaxThreads;
  const int threads = ((tasks + rounds - 1) / rounds + 31) / 32 * 32;
  const int vec16 = static_cast<size_t>(n) * C * sizeof(T) % 16 == 0 &&
                    vct::aligned16(k) && vct::aligned16(v);
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, h, hd,
      scale * vct::kLog2e, vec16);
  return static_cast<int>(cudaGetLastError());
}

// kFull where hd == HD and q and o hold whole HD-value vectors (K and V
// rows are aligned in shared memory by construction)
template <typename T, int HD>
int outer_by_fit(const void* q, const void* k, const void* v, void* o,
                 int B, int n, int h, int hd, float scale, cudaStream_t st) {
  const size_t vec = std::min<size_t>(16, HD * sizeof(T));
  if (hd == HD && reinterpret_cast<uintptr_t>(q) % vec == 0 &&
      reinterpret_cast<uintptr_t>(o) % vec == 0)
    return launch_outer<T, HD, true>(q, k, v, o, B, n, h, hd, scale, st);
  return launch_outer<T, HD, false>(q, k, v, o, B, n, h, hd, scale, st);
}

// HD: the register width of a head, the least of 4, 8, 16, 32 >= hd
template <typename T>
int outer_by_hd(const void* q, const void* k, const void* v, void* o, int B,
                int n, int h, int hd, float scale, cudaStream_t st) {
  if (hd <= 4) return outer_by_fit<T, 4>(q, k, v, o, B, n, h, hd, scale, st);
  if (hd <= 8) return outer_by_fit<T, 8>(q, k, v, o, B, n, h, hd, scale, st);
  if (hd <= 16)
    return outer_by_fit<T, 16>(q, k, v, o, B, n, h, hd, scale, st);
  return outer_by_fit<T, 32>(q, k, v, o, B, n, h, hd, scale, st);
}

}  // namespace

// V3: bf16 only; hd even and <= 16, h * hd <= 256 (masked: a multiple of
// 16 and <= 128), n <= 512, and the staged rows within one block's shared
// memory; anything else is cudaErrorInvalidValue
extern "C" int vct_heads_attention_mma(const void* q, const void* k,
                                       const void* v, void* o, int B, int n,
                                       int h, int hd, float scale, int masked,
                                       void* stream) {
  const int C = h * hd;
  if (n < 1 || n > kMaxN || h < 1 || hd < 2 || hd > kMmaMaxHd || hd % 2 ||
      C > kMmaMaxC || mma_smem(n, C) > kMaxSmem ||
      (masked && (C % 16 || C > kMaskedMaxC)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return masked ? launch_mma<true>(q, k, v, o, B, n, h, hd, scale, st)
                : launch_mma<false>(q, k, v, o, B, n, h, hd, scale, st);
}

// V4: float32 or bf16; hd <= 32, h * hd <= 256, n <= 512, and K and V of a
// batch row within one block's shared memory
extern "C" int vct_heads_attention_outer(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, int B, int n, int h, int hd,
                                         float scale, void* stream) {
  if (n < 1 || n > kMaxN || h < 1 || hd < 1 || hd > kOuterMaxHd ||
      h * hd > kMmaMaxC || outer_smem(n, h * hd) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return outer_by_hd<float>(q, k, v, o, B, n, h, hd, scale, st);
  if (dtype == vct::kBF16)
    return outer_by_hd<__nv_bfloat16>(q, k, v, o, B, n, h, hd, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
