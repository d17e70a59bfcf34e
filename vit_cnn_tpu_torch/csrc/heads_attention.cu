// K8 and K9: head-last attention over many small heads.
//
// K8 replaces the Pallas TPU kernel built by vit_cnn_tpu/ops/attention.py
// `_make_heads_kernel` (launched by `_pallas_attention_heads`):
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] * scale)
//                   v[b, j, h, :]   (+ q[b, i, h, :] for i >= 1 if residual)
// with q, k, v (B, n, h, hd). Every ViT of the transformer zoo calls it at 4
// heads of 16: n = 65 (MHST, GLT_Net), 146 (SpectralFormer), 145 (S2EFT).
//
// K9 replaces `_make_pooled_kernel` (launched by `_pallas_pooled`), MHST's
// pooled-attention tail: q, k and v (B, n, c = h * hd) are each normalised
// per (token, head) group of hd channels (flax LayerNorm's formula: fast
// variance E[x^2] - E[x]^2 clipped at 0, eps 1e-5, (hd,) scale and bias
// shared by the heads), rounded to the input dtype as the Pallas kernel
// does, then attended as in K8 with the residual on the normalised q. MHST
// runs it at n = 65, 16 heads of 4. On the TPU this kernel is gated off
// because the TPU compiler miscompiled it; here it is the path.
//
// What bounds them on the H100: per head and batch row they read 3 n hd
// values and write n hd, and take n^2 exps and 4 n^2 hd FLOPs. At the MHST
// shapes in bf16 that is 252.6 MB moved per band of 7,592 windows (75 us at
// 3.35 TB/s) against 128.3 M exps for K8 (31 us at the special-function
// units' ~4.2e12 exp/s) and 513.2 M for K9 (122 us): K8 is memory bound,
// K9 exp bound, once the scores stay on chip. They never leave the SM here.
//
// bf16, on the tensor cores (the path: the zoo serves in bf16).
// - The TPU kernels round the normalised P to the input dtype before P.V
//   (vit_cnn_tpu/ops/attention.py:131, :352), so P.V with a bf16 P and
//   float32 sums on mma.sync m16n8k16 is the reference's own arithmetic.
// - One block of 8 warps takes one batch row and a group of heads: as many
//   as fit in shared memory (smem_bf16; all of them at every zoo shape, two
//   of 32 at n = 512), spread evenly over the row's blocks. The wrapper
//   plans the group (ops/attention.py `_heads_group`, the same formula).
// - Staging: q, k and v of the group as bf16 token rows, each head at a
//   column offset that is a multiple of 8 (hd padded to HDP = 8, 16, 24 or
//   32 with zeros, so odd hd works), rows padded to an odd number of 16-byte
//   units (row_stride) so that the 8 rows one ldmatrix reads fall in 8
//   different bank groups, and n padded to a multiple of 16 with zero rows.
//   K8 copies q, k, v (strided views of the fused qkv projection in the ViT)
//   with cp.async, 16 bytes at a time where hd, the strides and the
//   pointers allow. K9 reads its contiguous rows one (token, head) group per
//   thread (neighbouring threads on neighbouring groups, as wide as hd
//   allows: 8 bytes at hd = 4), normalises the group in float32 registers
//   (flax's formula; the TPU kernel's statistics are float32 too) and
//   stores it rounded to bf16, zero-padded, straight into the same layout.
// - attend(), the one core of both: a warp takes (head, 16-query tile)
//   tasks. Q's A fragment stays in registers; per 16-key tile, Q.K^T is
//   HDP / 16 m16n8k16 products (and one m16n8k8 for HDP = 8 or 24) per
//   8-key half, with K's B fragments from ldmatrix; the online softmax
//   (vct::softmax_tile) scales by scale * log2 e and takes exp2 (one
//   MUFU.EX2, ex2.approx.ftz: the exps are K9's bound), padded
//   keys score -inf, and the score C fragment, rounded to bf16, is P's A
//   fragment (P never goes through shared memory); V stays row-major and
//   gives P.V's B fragments through ldmatrix.trans, HDP / 8 n8 tiles. The
//   output is scaled by 1 / l, gets the residual from the staged q (for K9
//   the normalised, rounded q) and is stored as bf16 pairs (single values
//   for odd hd).
// - Exps of padding are skipped where a whole 8-key half or the tile's 8
//   upper rows are padding; the rest of the padded tile is computed. At
//   n = 65 a head takes 72 x 72 exps: 80 x 80 padded, 65 x 65 real.
// - Not wgmma: its 64-row tile would pad one head's 65 queries to 128, and
//   one head is only 4 to 16 channels deep; mma.sync's 16-row tiles waste
//   less. Not measured here; a later change may.
//
// float32, on the CUDA cores (tensor cores would take float32 only as TF32,
// outside float32's tolerance):
// - K8: one block of 8 warps per (batch row, head). Q, K and V of that head
//   are staged in shared memory as float32 rows padded to an odd width
//   (hd | 1), so lanes that read one channel of 32 different keys hit 32
//   different banks. q, k and v may be strided views of a fused qkv
//   projection (unit channel stride, head stride hd).
// - K9: one block per batch row, all heads: the block reads q, k and v rows
//   whole (coalesced), normalises each (token, head) group in registers in
//   float64 (see pooled_kernel) and writes the rounded result into the same
//   padded per-head layout.
// - Both: one warp per (head, query row). Lanes take keys j = lane + 32 m;
//   each score is an hd-long dot from registers and shared memory into a
//   per-warp score row; softmax subtracts the row max, in float32. For P.V
//   the warp splits into 32 / hd groups of hd lanes (when hd divides 32),
//   each summing every (32 / hd)-th key for its channel, then the groups
//   reduce with shuffles. The output row is scaled by 1 / sum, gets the
//   residual, and is stored once.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 512;
constexpr int kMaxHd = 32;
constexpr int kMaxC = 256;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int padded(int hd) { return hd | 1; }

inline size_t smem_bytes(int n, int heads, int hd) {
  return sizeof(float) *
         (3 * static_cast<size_t>(heads) * n * padded(hd) + kWarps * n);
}

// One warp computes output row r of one head. sq, sk, sv: that head's
// [n][hds] rows; sp: this warp's n scores; out: o[b, r, head, 0].
template <typename T, int HD>
__device__ void attend_row(const float* sq, const float* sk, const float* sv,
                           float* sp, int n, int hd, int hds, int r,
                           float scale, bool residual, T* out) {
  const int lane = threadIdx.x & 31;
  float qv[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) qv[c] = c < hd ? sq[r * hds + c] : 0.f;

  float mloc = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float* kr = sk + j * hds;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < HD; ++c)
      if (c < hd) s += qv[c] * kr[c];
    s *= scale;
    sp[j] = s;
    mloc = fmaxf(mloc, s);
  }
  const float m = vct::warp_max(mloc);
  float lsum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(sp[j] - m);
    sp[j] = e;
    lsum += e;
  }
  const float inv = 1.f / vct::warp_sum(lsum);
  __syncwarp();

  const int groups = (32 % hd == 0) ? 32 / hd : 1;
  const int g = lane / hd, c = lane - g * hd;
  float acc = 0.f;
  if (g < groups)
    for (int j = g; j < n; j += groups) acc += sp[j] * sv[j * hds + c];
  if (groups > 1)
    for (int off = hd; off < 32; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane < hd) {
    float o = acc * inv;
    if (residual && r >= 1) o += sq[r * hds + lane];
    out[lane] = vct::from_f32<T>(o);
  }
  __syncwarp();                        // sp is rewritten for the next row
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
heads_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int n, int h, int hd,
             long long sb, long long sn, float scale, int residual) {
  extern __shared__ float smem[];
  const int hds = padded(hd);
  float* sq = smem;
  float* sk = sq + n * hds;
  float* sv = sk + n * hds;
  float* sp = sv + n * hds;
  const long long b = blockIdx.x / h;
  const int head = blockIdx.x - static_cast<int>(b) * h;
  const long long base = b * sb + static_cast<long long>(head) * hd;
  for (int idx = threadIdx.x; idx < n * hd; idx += kThreads) {
    const int j = idx / hd, c = idx - j * hd;
    const long long src = base + j * sn + c;
    sq[j * hds + c] = vct::to_f32(q[src]);
    sk[j * hds + c] = vct::to_f32(k[src]);
    sv[j * hds + c] = vct::to_f32(v[src]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int C = h * hd;
  for (int r = warp; r < n; r += kWarps)
    attend_row<T, HD>(sq, sk, sv, sp + warp * n, n, hd, hds, r, scale,
                      residual != 0,
                      o + (b * n + r) * C + static_cast<long long>(head) * hd);
}

// ln: [6][hd] float32 = scale_q, bias_q, scale_k, bias_k, scale_v, bias_v
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
pooled_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ ln,
              T* __restrict__ o, int n, int h, int hd, float scale,
              int residual) {
  extern __shared__ float smem[];
  const int hds = padded(hd);
  const int C = h * hd;
  const int per = h * n * hds;         // floats of one tensor, all heads
  float* sp = smem + 3 * per;
  const long long row0 = static_cast<long long>(blockIdx.x) * n * C;
  const double inv_hd = 1.0 / hd;
  for (int t = 0; t < 3; ++t) {
    const T* x = (t == 0 ? q : t == 1 ? k : v) + row0;
    const float* gamma = ln + 2 * t * hd;
    const float* beta = gamma + hd;
    float* dst = smem + t * per;
    for (int grp = threadIdx.x; grp < n * h; grp += kThreads) {
      const int j = grp / h, head = grp - j * h;
      const T* src = x + static_cast<long long>(j) * C + head * hd;
      // The fast variance E[x^2] - E[x]^2 cancels in float32 for a group
      // whose mean is large beside its spread (mean -1.12, variance 3.8e-4
      // loses ~1e-3 of its normalised values, in any float32 summation
      // order), so the statistics and the normalisation run in float64:
      // the same formula, exact to float32 before the final rounding.
      double xv[HD];
      double s = 0.0, s2 = 0.0;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        xv[c] = c < hd ? static_cast<double>(vct::to_f32(src[c])) : 0.0;
        s += xv[c];
        s2 += xv[c] * xv[c];
      }
      const double mu = s * inv_hd;
      const double var = fmax(s2 * inv_hd - mu * mu, 0.0);
      const double rs = 1.0 / sqrt(var + 1e-5);
      float* d = dst + (head * n + j) * hds;
#pragma unroll
      for (int c = 0; c < HD; ++c)
        if (c < hd)
          d[c] = vct::to_f32(vct::from_f32<T>(static_cast<float>(
              (xv[c] - mu) * rs * gamma[c] + beta[c])));
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  for (int pair = warp; pair < h * n; pair += kWarps) {
    const int head = pair / n, r = pair - head * n;
    const int hoff = head * n * hds;
    attend_row<T, HD>(smem + hoff, smem + per + hoff, smem + 2 * per + hoff,
                      sp + warp * n, n, hd, hds, r, scale, residual != 0,
                      o + row0 + static_cast<long long>(r) * C + head * hd);
  }
}

template <typename T, int HD>
int launch_heads(const void* q, const void* k, const void* v, void* o, int B,
                 int n, int h, int hd, long long sb, long long sn,
                 float scale, int residual, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, 1, hd);
  cudaError_t err = vct::allow_smem(heads_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_kernel<T, HD><<<static_cast<unsigned>(B) * h, kThreads, smem,
                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, h, hd, sb, sn, scale,
      residual);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_pooled(const void* q, const void* k, const void* v,
                  const float* ln, void* o, int B, int n, int h, int hd,
                  float scale, int residual, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, h, hd);
  cudaError_t err = vct::allow_smem(pooled_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_kernel<T, HD><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ln, static_cast<T*>(o), n, h, hd, scale,
      residual);
  return static_cast<int>(cudaGetLastError());
}

// HD: the register width of a head, the least of 4, 8, 16, 32 >= hd
template <typename T>
int heads_by_hd(const void* q, const void* k, const void* v, void* o, int B,
                int n, int h, int hd, long long sb, long long sn, float scale,
                int residual, cudaStream_t st) {
  if (hd <= 4)
    return launch_heads<T, 4>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                              residual, st);
  if (hd <= 8)
    return launch_heads<T, 8>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                              residual, st);
  if (hd <= 16)
    return launch_heads<T, 16>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                               residual, st);
  return launch_heads<T, 32>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                             residual, st);
}

template <typename T>
int pooled_by_hd(const void* q, const void* k, const void* v,
                 const float* ln, void* o, int B, int n, int h, int hd,
                 float scale, int residual, cudaStream_t st) {
  if (hd <= 4)
    return launch_pooled<T, 4>(q, k, v, ln, o, B, n, h, hd, scale, residual,
                               st);
  if (hd <= 8)
    return launch_pooled<T, 8>(q, k, v, ln, o, B, n, h, hd, scale, residual,
                               st);
  if (hd <= 16)
    return launch_pooled<T, 16>(q, k, v, ln, o, B, n, h, hd, scale,
                                residual, st);
  return launch_pooled<T, 32>(q, k, v, ln, o, B, n, h, hd, scale, residual,
                              st);
}

// ---- bf16 on the tensor cores ---------------------------------------------

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int pad8(int hd) { return (hd + 7) / 8 * 8; }

// bf16 elements per staged token row of `heads` heads hdp wide: a multiple
// of 8 whose eighth is odd, so the 8 rows one ldmatrix reads start in 8
// different 16-byte bank groups
__host__ __device__ inline int row_stride(int heads, int hdp) {
  const int w = heads * hdp;
  return (w / 8) % 2 ? w : w + 8;
}

// one block's staged q, k and v (ops/attention.py `_heads_smem`)
inline size_t smem_bf16(int n, int heads, int hd) {
  return sizeof(__nv_bfloat16) * 3 * static_cast<size_t>(pad16(n)) *
         row_stride(heads, pad8(hd));
}

// zeroes the pad rows [n, pad16(n)) of a staged tensor
__device__ void zero_pad_rows(__nv_bfloat16* s, int n, int rs) {
  uint4* d = reinterpret_cast<uint4*>(s + n * rs);
  const int count = (pad16(n) - n) * rs / 8;
  for (int i = threadIdx.x; i < count; i += kThreads)
    d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// K8's staging of one tensor: rows j < n of the block's G heads (x points
// at token 0 of its first head, token stride sn) into s[j rs + hl HDP + c],
// by cp.async copies of w elements (w divides hd, the strides and the
// pointers' alignment; w = 1: plain copies); zeroes the pad columns
// [hd, HDP) of each head and the pad rows. The caller waits for the copies.
template <int HDP>
__device__ void stage_rows(__nv_bfloat16* s, const __nv_bfloat16* x,
                           long long sn, int n, int G, int hd, int rs,
                           int w) {
  const int per = G * hd / w;                // copies per token
  for (int idx = threadIdx.x; idx < n * per; idx += kThreads) {
    const int j = idx / per, i = (idx - j * per) * w;
    const int hl = i / hd;
    __nv_bfloat16* d = s + j * rs + hl * HDP + (i - hl * hd);
    const __nv_bfloat16* src = x + j * sn + i;
    switch (w) {
      case 8: vct::cp_async<16>(d, src); break;
      case 4: vct::cp_async<8>(d, src); break;
      case 2: vct::cp_async<4>(d, src); break;
      default: *d = *src;
    }
  }
  if (hd < HDP)
    for (int idx = threadIdx.x; idx < n * G; idx += kThreads) {
      const int j = idx / G, hl = idx - j * G;
      __nv_bfloat16* d = s + j * rs + hl * HDP;
      for (int c = hd; c < HDP; ++c) d[c] = __float2bfloat16(0.f);
    }
  zero_pad_rows(s, n, rs);
}

// K9: one (token, head) group's hd values as bf16 pairs, zero beyond hd,
// by loads of w elements
template <int HDP>
__device__ __forceinline__ void load_group(uint32_t (&r)[HDP / 2],
                                           const __nv_bfloat16* src, int hd,
                                           int w) {
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) r[i] = 0u;
  if (w == 8) {
#pragma unroll
    for (int c = 0; c < HDP; c += 8)
      if (c < hd) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + c);
        r[c / 2] = u.x, r[c / 2 + 1] = u.y, r[c / 2 + 2] = u.z;
        r[c / 2 + 3] = u.w;
      }
  } else if (w == 4) {
#pragma unroll
    for (int c = 0; c < HDP; c += 4)
      if (c < hd) {
        const uint2 u = *reinterpret_cast<const uint2*>(src + c);
        r[c / 2] = u.x, r[c / 2 + 1] = u.y;
      }
  } else if (w == 2) {
#pragma unroll
    for (int c = 0; c < HDP; c += 2)
      if (c < hd) r[c / 2] = vct::pair(src + c);
  } else {
#pragma unroll
    for (int c = 0; c < HDP; ++c)
      if (c < hd)
        r[c / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(src[c]))
                    << (16 * (c & 1));
  }
}

// K9: flax's LayerNorm of one group (float32 statistics, fast variance
// clipped at 0, eps 1e-5; ln = its (hd,) scale then bias), rounded to bf16
// and stored with its zero padding as HDP / 8 16-byte rows into d
template <int HDP>
__device__ __forceinline__ void ln_store(const uint32_t (&r)[HDP / 2],
                                         const float* __restrict__ ln,
                                         int hd, __nv_bfloat16* d) {
  float x[HDP];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&r[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
    s += f.x + f.y;
    s2 += f.x * f.x + f.y * f.y;
  }
  const float mu = s / hd;
  const float rstd = rsqrtf(fmaxf(s2 / hd - mu * mu, 0.f) + 1e-5f);
  uint32_t y[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * i + e;
      v[e] = c < hd ? (x[c] - mu) * rstd * __ldg(ln + c) + __ldg(ln + hd + c)
                    : 0.f;
    }
    y[i] = vct::pack(v[0], v[1]);
  }
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i)
    reinterpret_cast<uint4*>(d)[i] =
        make_uint4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}

// The core of K8 and K9 in bf16, run by the whole block once q, k and v of
// its G heads are staged (sQ, sK, sV: pad16(n) rows of rs, head hl at
// column hl HDP): o points at (token 0, first head of the group) of a
// contiguous output with C channels per token.
template <int HDP>
__device__ void attend(const __nv_bfloat16* sQ, const __nv_bfloat16* sK,
                       const __nv_bfloat16* sV, int rs, int n, int G, int hd,
                       float scale_log2, bool residual, __nv_bfloat16* o,
                       int C) {
  constexpr int KS = HDP / 16;               // k16 steps of Q.K^T
  constexpr bool kK8 = HDP % 16 != 0;        // and one k8 step
  constexpr int NT = HDP / 8;                // n8 tiles of P.V
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  // the row and column each lane addresses for ldmatrix: x4 of A (and of
  // V transposed), x4 of K, and x2 (lanes 0-15 count)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int b_col = 8 * ((lane >> 3) & 1);
  const int tiles = pad16(n) / 16;
  for (int task = warp; task < G * tiles; task += kWarps) {
    const int hl = task / tiles, q0 = (task - hl * tiles) * 16;
    const int c0 = hl * HDP;
    const bool upper = q0 + 8 < n;           // rows q0 + 8.. hold a query
    uint32_t qa[KS > 0 ? KS : 1][4], qr[2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      vct::ldsm_x4(qa[ks], sQ + (q0 + a_row) * rs + c0 + 16 * ks + a_col);
    if (kK8) vct::ldsm_x2(qr, sQ + (q0 + a_row) * rs + c0 + 16 * KS);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[NT][4] = {};
    for (int k0 = 0; k0 < n; k0 += 16) {
      float s[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        vct::ldsm_x4(kb, sK + (k0 + b_row) * rs + c0 + 16 * ks + b_col);
        vct::mma(s[0], qa[ks], kb[0], kb[1]);
        vct::mma(s[1], qa[ks], kb[2], kb[3]);
      }
      if (kK8) {
        uint32_t kb[2];
        vct::ldsm_x2(kb, sK + (k0 + a_row) * rs + c0 + 16 * KS);
        vct::mma_k8(s[0], qr, kb[0]);
        vct::mma_k8(s[1], qr, kb[1]);
      }
      float alpha[2];
      uint32_t pa[4];
      vct::softmax_tile(s, k0, n, upper, scale_log2, m, l, alpha, pa);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t vb[4];
        vct::ldsm_x4_t(vb, sV + (k0 + a_row) * rs + c0 + 8 * nt + a_col);
        vct::mma(acc[nt], pa, vb[0], vb[1]);
        vct::mma(acc[nt + 1], pa, vb[2], vb[3]);
      }
      if (NT % 2) {
        uint32_t vb[2];
        vct::ldsm_x2_t(vb, sV + (k0 + a_row) * rs + c0 + 8 * (NT - 1));
        vct::mma(acc[NT - 1], pa, vb[0], vb[1]);
      }
    }
    const float inv[2] = {1.f / vct::quad_sum(l[0]),
                          upper ? 1.f / vct::quad_sum(l[1]) : 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + (lane >> 2) + 8 * r;
        if (row >= n) continue;
        float v0 = acc[nt][2 * r] * inv[r], v1 = acc[nt][2 * r + 1] * inv[r];
        if (residual && row >= 1) {
          const float2 qv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sQ + row * rs + c0 +
                                                       col));
          v0 += qv.x;
          v1 += qv.y;
        }
        __nv_bfloat16* dst = o + static_cast<long long>(row) * C + hl * hd +
                             col;
        if (hd % 2 == 0) {
          *reinterpret_cast<uint32_t*>(dst) = vct::pack(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < hd) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// The block's batch row b, first head g0 and heads G of a grid of
// B x ceil(h / group) blocks
struct Group {
  long long b;
  int g0, G;
};

__device__ __forceinline__ Group block_group(int h, int group) {
  const int groups = (h + group - 1) / group;
  Group gr;
  gr.b = blockIdx.x / groups;
  gr.g0 = static_cast<int>(blockIdx.x - gr.b * groups) * group;
  gr.G = min(group, h - gr.g0);
  return gr;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
heads_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int n, int h, int hd,
                  int group, long long sb, long long sn, float scale_log2,
                  int residual, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group gr = block_group(h, group);
  const int rs = row_stride(gr.G, HDP), per = pad16(n) * rs;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const long long in0 = gr.b * sb + static_cast<long long>(gr.g0) * hd;
  stage_rows<HDP>(sQ, q + in0, sn, n, gr.G, hd, rs, w);
  stage_rows<HDP>(sQ + per, k + in0, sn, n, gr.G, hd, rs, w);
  stage_rows<HDP>(sQ + 2 * per, v + in0, sn, n, gr.G, hd, rs, w);
  vct::cp_async_wait_all();
  __syncthreads();
  const int C = h * hd;
  const long long out0 = gr.b * n * C + static_cast<long long>(gr.g0) * hd;
  attend<HDP>(sQ, sQ + per, sQ + 2 * per, rs, n, gr.G, hd, scale_log2,
              residual != 0, o + out0, C);
}

// ln: [6][hd] float32 = scale_q, bias_q, scale_k, bias_k, scale_v, bias_v
template <int HDP>
__global__ void __launch_bounds__(kThreads)
pooled_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ ln, __nv_bfloat16* __restrict__ o,
                   int n, int h, int hd, int group, float scale_log2,
                   int residual, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group gr = block_group(h, group);
  const int rs = row_stride(gr.G, HDP), per = pad16(n) * rs, C = h * hd;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const long long base = gr.b * n * C + static_cast<long long>(gr.g0) * hd;
  const __nv_bfloat16* src[3] = {q + base, k + base, v + base};
  for (int idx = threadIdx.x; idx < n * gr.G; idx += kThreads) {
    const int j = idx / gr.G, hl = idx - j * gr.G;
    const long long off = static_cast<long long>(j) * C + hl * hd;
    uint32_t raw[3][HDP / 2];
#pragma unroll
    for (int x = 0; x < 3; ++x) load_group<HDP>(raw[x], src[x] + off, hd, w);
#pragma unroll
    for (int x = 0; x < 3; ++x)
      ln_store<HDP>(raw[x], ln + 2 * x * hd, hd,
                    sQ + x * per + j * rs + hl * HDP);
  }
  for (int x = 0; x < 3; ++x) zero_pad_rows(sQ + x * per, n, rs);
  __syncthreads();
  attend<HDP>(sQ, sQ + per, sQ + 2 * per, rs, n, gr.G, hd, scale_log2,
              residual != 0, o + base, C);
}

// the widest copy (8, 4, 2 or 1 elements) that hd, the strides and every
// pointer allow
int copy_width(int hd, long long sb, long long sn,
               std::initializer_list<const void*> ptrs) {
  for (int w = 8; w > 1; w /= 2) {
    bool ok = hd % w == 0 && sb % w == 0 && sn % w == 0;
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % (2 * w) == 0;
    if (ok) return w;
  }
  return 1;
}

template <int HDP>
int launch_heads_bf16(const void* q, const void* k, const void* v, void* o,
                      int B, int n, int h, int hd, int group, long long sb,
                      long long sn, float scale, int residual,
                      cudaStream_t stream) {
  const size_t smem = smem_bf16(n, group, hd);
  cudaError_t err = vct::allow_smem(heads_kernel_bf16<HDP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>(B) * ((h + group - 1) / group);
  heads_kernel_bf16<HDP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n, h, hd, group, sb, sn, scale * vct::kLog2e, residual,
      copy_width(hd, sb, sn, {q, k, v}));
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_pooled_bf16(const void* q, const void* k, const void* v,
                       const float* ln, void* o, int B, int n, int h, int hd,
                       int group, float scale, int residual,
                       cudaStream_t stream) {
  const size_t smem = smem_bf16(n, group, hd);
  cudaError_t err = vct::allow_smem(pooled_kernel_bf16<HDP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>(B) * ((h + group - 1) / group);
  const long long C = static_cast<long long>(h) * hd;
  pooled_kernel_bf16<HDP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ln,
      static_cast<__nv_bfloat16*>(o), n, h, hd, group, scale * vct::kLog2e,
      residual, copy_width(hd, n * C, C, {q, k, v}));
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int n, int h, int hd) {
  return n >= 1 && n <= kMaxN && hd >= 1 && hd <= kMaxHd && h >= 1 &&
         h * hd <= kMaxC;
}

// the heads per block each instance takes: float32 K8 one and float32 K9
// all h (their layouts are fixed), bf16 any group whose staging fits
bool group_ok(int dtype, int n, int h, int hd, int group, bool pooled,
              int B) {
  if (static_cast<long long>(B) * ((h + group - 1) / group) > 2147483647LL)
    return false;
  if (dtype == vct::kF32)
    return group == (pooled ? h : 1) && smem_bytes(n, group, hd) <= kMaxSmem;
  if (dtype == vct::kBF16)
    return group >= 1 && group <= h && smem_bf16(n, group, hd) <= kMaxSmem;
  return false;
}

}  // namespace

// group: heads per block (ops/attention.py `_heads_group`)
extern "C" int vct_heads_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int n,
                                   int h, int hd, long long sb, long long sn,
                                   float scale, int residual, int group,
                                   void* stream) {
  if (!shape_ok(n, h, hd) || group < 1 ||
      !group_ok(dtype, n, h, hd, group, false, B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return heads_by_hd<float>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                              residual, st);
  switch (pad8(hd)) {
    case 8:
      return launch_heads_bf16<8>(q, k, v, o, B, n, h, hd, group, sb, sn,
                                 scale, residual, st);
    case 16:
      return launch_heads_bf16<16>(q, k, v, o, B, n, h, hd, group, sb, sn,
                                  scale, residual, st);
    case 24:
      return launch_heads_bf16<24>(q, k, v, o, B, n, h, hd, group, sb, sn,
                                  scale, residual, st);
    default:
      return launch_heads_bf16<32>(q, k, v, o, B, n, h, hd, group, sb, sn,
                                  scale, residual, st);
  }
}

extern "C" int vct_pooled_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* ln, void* o,
                                    int B, int n, int h, int hd, float scale,
                                    int residual, int group, void* stream) {
  if (!shape_ok(n, h, hd) || group < 1 ||
      !group_ok(dtype, n, h, hd, group, true, B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lnf = static_cast<const float*>(ln);
  if (dtype == vct::kF32)
    return pooled_by_hd<float>(q, k, v, lnf, o, B, n, h, hd, scale, residual,
                               st);
  switch (pad8(hd)) {
    case 8:
      return launch_pooled_bf16<8>(q, k, v, lnf, o, B, n, h, hd, group, scale,
                                  residual, st);
    case 16:
      return launch_pooled_bf16<16>(q, k, v, lnf, o, B, n, h, hd, group,
                                   scale, residual, st);
    case 24:
      return launch_pooled_bf16<24>(q, k, v, lnf, o, B, n, h, hd, group,
                                   scale, residual, st);
    default:
      return launch_pooled_bf16<32>(q, k, v, lnf, o, B, n, h, hd, group,
                                   scale, residual, st);
  }
}
