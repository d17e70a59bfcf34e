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
// - V4: one block per batch row; K and V of all heads in shared memory as
//   float32. A thread owns R = 32 / HD query rows of one head (HD: hd
//   rounded up to 4, 8, 16 or 32) with their q, output sums, maxima and
//   sums in registers. Per chunk of kKeys keys it reads each k_j once,
//   adds q_c k_jc to R scores per channel c (hd rank-1 updates), rescales
//   its sums only when a row's maximum grows, then reads each v_j once.
//   This is the "several query rows per thread" that K8 leaves for later:
//   each K and V row read from shared memory serves R rows.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

namespace {

constexpr size_t kMaxSmem = 232448;
constexpr int kMmaWarps = 8;
constexpr int kMmaMaxHd = 16;
constexpr int kMmaMaxC = 256;
constexpr int kMaskedMaxC = 128;         // the masked accumulator: C / 2 regs
constexpr int kMaxN = 512;
constexpr int kOuterMaxThreads = 256;
constexpr int kOuterMaxHd = 32;
constexpr int kKeys = 4;                 // V4: keys per chunk

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

size_t mma_smem(int n, int C) {
  const size_t np = pad16(n);
  return sizeof(__nv_bfloat16) * (2 * np * (C + 8) + C * (np + 8));
}

size_t outer_smem(int n, int C) {
  return sizeof(float) * 2 * static_cast<size_t>(n) * C;
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

template <typename T, int HD>
__global__ void __launch_bounds__(kOuterMaxThreads)
heads_outer_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int n, int h,
                   int hd, float scale) {
  constexpr int R = 32 / HD;                 // query rows per thread
  extern __shared__ float smem[];
  const int C = h * hd;
  float* sK = smem;                          // [n][C]
  float* sV = smem + n * C;
  const long long row0 = static_cast<long long>(blockIdx.x) * n * C;
  for (int idx = threadIdx.x; idx < n * C; idx += blockDim.x) {
    sK[idx] = vct::to_f32(k[row0 + idx]);
    sV[idx] = vct::to_f32(v[row0 + idx]);
  }
  __syncthreads();

  const int groups = (n + R - 1) / R;
  for (int task = threadIdx.x; task < h * groups; task += blockDim.x) {
    const int head = task / groups, r0 = (task - head * groups) * R;
    const int c0 = head * hd;
    float qr[R][HD], acc[R][HD], m[R], l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r0 + r;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        qr[r][c] = (i < n && c < hd)
                       ? vct::to_f32(q[row0 + static_cast<long long>(i) * C +
                                       c0 + c])
                       : 0.f;
        acc[r][c] = 0.f;
      }
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    for (int j0 = 0; j0 < n; j0 += kKeys) {
      float s[R][kKeys] = {};
      // hd rank-1 updates: score (r, jj) += q[r][c] * k[j0 + jj][c]
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        if (c >= hd) continue;
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) {
          const float kv = j0 + jj < n ? sK[(j0 + jj) * C + c0 + c] : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) s[r][jj] = fmaf(qr[r][c], kv, s[r][jj]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) {
          s[r][jj] = j0 + jj < n ? s[r][jj] * scale : -INFINITY;
          mx = fmaxf(mx, s[r][jj]);
        }
        if (mx > m[r]) {                       // rescale only on a new max
          const float alpha = __expf(m[r] - mx);
          l[r] *= alpha;
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[r][c] *= alpha;
          m[r] = mx;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        if (j0 + jj >= n) continue;
        float vv[HD];
#pragma unroll
        for (int c = 0; c < HD; ++c)
          vv[c] = c < hd ? sV[(j0 + jj) * C + c0 + c] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = __expf(s[r][jj] - m[r]);
          l[r] += p;
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r0 + r;
      if (i >= n) continue;
      const float inv = 1.f / l[r];
      T* dst = o + row0 + static_cast<long long>(i) * C + c0;
#pragma unroll
      for (int c = 0; c < HD; ++c)
        if (c < hd) dst[c] = vct::from_f32<T>(acc[r][c] * inv);
    }
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

template <typename T, int HD>
int launch_outer(const void* q, const void* k, const void* v, void* o, int B,
                 int n, int h, int hd, float scale, cudaStream_t stream) {
  const size_t smem = outer_smem(n, h * hd);
  cudaError_t err = vct::allow_smem(heads_outer_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tasks = h * ((n + 32 / HD - 1) / (32 / HD));
  const int warps = (tasks + 31) / 32;
  const int threads = warps * 32 < kOuterMaxThreads ? warps * 32
                                                    : kOuterMaxThreads;
  heads_outer_kernel<T, HD><<<B, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, h, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// HD: the register width of a head, the least of 4, 8, 16, 32 >= hd
template <typename T>
int outer_by_hd(const void* q, const void* k, const void* v, void* o, int B,
                int n, int h, int hd, float scale, cudaStream_t st) {
  if (hd <= 4) return launch_outer<T, 4>(q, k, v, o, B, n, h, hd, scale, st);
  if (hd <= 8) return launch_outer<T, 8>(q, k, v, o, B, n, h, hd, scale, st);
  if (hd <= 16)
    return launch_outer<T, 16>(q, k, v, o, B, n, h, hd, scale, st);
  return launch_outer<T, 32>(q, k, v, o, B, n, h, hd, scale, st);
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

// V4: float32 or bf16; hd <= 32, h * hd <= 256, n <= 512, and K and V in
// float32 within one block's shared memory
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
