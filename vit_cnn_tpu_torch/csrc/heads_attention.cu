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
// shared by the heads; the statistics in float64, see below), rounded to
// the input dtype as the Pallas kernel does, then attended as in K8 with
// the residual on the normalised q. MHST runs it at n = 65, 16 heads of 4.
// On the TPU this kernel is gated off because the TPU compiler miscompiled
// it; here it is the path.
//
// What bounds them on the H100: per head and batch row they read 3 n hd
// values and write n hd, and take n^2 exps and 4 n^2 hd FLOPs. At the MHST
// shapes in bf16 that is 252.6 MB moved per band of 7,592 windows (75 us at
// 3.35 TB/s) against 128.3 M exps for K8 (31 us at the special-function
// units' ~4.2e12 exp/s) and 513.2 M for K9 (122 us): K8 is memory bound,
// K9 exp bound, once the scores stay on chip. They never leave the SM here.
//
// Design (a first, simple version; the TPU's lane-masked full-width dots
// are an MXU trick and are not carried over):
// - K8: one block of 8 warps per (batch row, head). Q, K and V of that head
//   are staged in shared memory as float32 rows padded to an odd width
//   (hd | 1), so lanes that read one channel of 32 different keys hit 32
//   different banks. q, k and v may be strided views of a fused qkv
//   projection (unit channel stride, head stride hd).
// - K9: one block per batch row, all heads: the block reads q, k and v rows
//   whole (coalesced), normalises each (token, head) group in registers and
//   writes the rounded result into the same padded per-head layout.
// - Both: one warp per (head, query row). Lanes take keys j = lane + 32 m;
//   each score is an hd-long dot from registers and shared memory into a
//   per-warp score row; softmax subtracts the row max, in float32. For P.V
//   the warp splits into 32 / hd groups of hd lanes (when hd divides 32),
//   each summing every (32 / hd)-th key for its channel, then the groups
//   reduce with shuffles. The output row is scaled by 1 / sum, gets the
//   residual, and is stored once in the input dtype.
// Not here: tensor cores for Q.K^T and P.V, and several query rows per
// thread to reuse each K row read from shared memory. Both are measured
// beside K8 as the variants V3 and V4 (csrc/heads_variants.cu,
// tools/heads_attn_variants.py; PERF.md has the times).
#include "common.cuh"

#include <math.h>

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

bool shape_ok(int n, int h, int hd) {
  return n >= 1 && n <= kMaxN && hd >= 1 && hd <= kMaxHd && h >= 1 &&
         h * hd <= kMaxC;
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

}  // namespace

extern "C" int vct_heads_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int n,
                                   int h, int hd, long long sb, long long sn,
                                   float scale, int residual, void* stream) {
  if (!shape_ok(n, h, hd) || smem_bytes(n, 1, hd) > kMaxSmem ||
      static_cast<long long>(B) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return heads_by_hd<float>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                              residual, st);
  if (dtype == vct::kBF16)
    return heads_by_hd<__nv_bfloat16>(q, k, v, o, B, n, h, hd, sb, sn, scale,
                                      residual, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vct_pooled_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* ln, void* o,
                                    int B, int n, int h, int hd, float scale,
                                    int residual, void* stream) {
  if (!shape_ok(n, h, hd) || smem_bytes(n, h, hd) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lnf = static_cast<const float*>(ln);
  if (dtype == vct::kF32)
    return pooled_by_hd<float>(q, k, v, lnf, o, B, n, h, hd, scale, residual,
                               st);
  if (dtype == vct::kBF16)
    return pooled_by_hd<__nv_bfloat16>(q, k, v, lnf, o, B, n, h, hd, scale,
                                       residual, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
