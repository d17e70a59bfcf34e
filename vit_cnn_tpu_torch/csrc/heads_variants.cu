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
//   tensor cores (mma.sync m16n8k16 and m16n8k8, and wgmma at hd = 16;
//   bf16 operands, float32 sums):
//   * per head (F): Q.K^T over the head's channels (a window of 8-channel
//     units, Q zeroed outside the head), P.V over the window's n8 tiles.
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
// - V3 (redesigned for Hopper): a block of as many warps as the row's tasks
//   need in the fewest rounds of at most 8 ((head, 16-query tile) tasks for F,
//   tile-major so that the mostly-padding last tiles share the last round;
//   16-query tiles for G), registers held to 24 resident warps an SM for F
//   (<= 80: above, blocks of 8 warps fall from 3 an SM to 2) and 16 for G. A
//   block stages a batch row's q, k and v as bf16 token rows, each padded to an
//   odd number of 16-byte units (so the 8 rows an ldmatrix reads fall in 8
//   different bank groups), n padded to a multiple of 16 with zero rows: where
//   every token row is a multiple of 16 bytes and aligned, warp 0 issues one
//   TMA bulk copy per token row, completed on an mbarrier (else a warp a row
//   copies 4-byte words or single values). Where two blocks of two stages fit
//   an SM (n = 65, not 146), the grid is persistent: a block walks rows with
//   the next row's copies in flight in a second stage. Q's and K's fragments
//   come from ldmatrix; V stays row-major and gives P.V's B fragments by
//   ldmatrix.trans. A head's channels sit in a window of 8, 16 or 24 channels
//   from the 8-aligned column below it (so every ldmatrix row is 16-byte
//   aligned for any even hd); Q's and K's fragment words are zeroed outside the
//   head (a neighbouring head's inf or NaN adds exact zeros, as the per-head
//   plain version never reads it), and a window of 8 (hd <= 8, aligned) takes
//   Q.K^T as one m16n8k8 product instead of a k16 one that is half zeros. The
//   score C fragment, rounded to bf16, is P's A fragment (P never goes through
//   shared memory). F over at most 5 key tiles (n <= 80) keeps all its scores
//   in registers and takes each row's exact maximum before the exps: one FFMA
//   and one MUFU a score, no rescale (kExactTiles); longer rows and G use the
//   online softmax (vct::softmax_tile, which skips the exps of all-padding key
//   halves and rows). G keeps the (16, C) float32 accumulator across heads, its
//   registers sized to C (4 or 8 k16 steps), skips its k16 steps and n8 tiles
//   that hold none of head h's channels, and adds each n8 tile's P_h . V to
//   head h's columns only. At hd = 16, C = 64 and n <= 160, F goes to a wgmma
//   form (heads_wgmma_kernel): Q.K^T as one warpgroup product per head and
//   64-query tile over the keys padded to 8, K read by wgmma from a
//   128-byte-swizzled copy, 1 or 2 warpgroups a block, whichever keeps more
//   warps resident. What bounds V3: at 16 heads of 4 the exps (0.122 ms at
//   MHST's pooled band, with 72 x 72 exps a head ~0.15); at 4 heads of 16 the
//   bytes (0.075 and 0.170 ms at the ViT and SpectralFormer bands). Measured on
//   an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ablation.py mma, each
//   step a copy of this file with that step undone, timed beside the committed
//   form and the first design in one call), bf16, F: the first design (one
//   8-warp block a row, 4-byte staging with V transposed value by value, 32-bit
//   fragment loads, every k16 step and key tile computed) took
//   0.749 / 0.280 / 0.909 ms at the pooled, ViT and SpectralFormer bands; this
//   form 0.595 / 0.198 / 0.646 (20.5% / 38.1% / 26.3% of the bound), below K8
//   (0.753 / 0.300 / 0.769). Zeroing K's fragment words outside the head as
//   well as Q's costs F 0-3% (0.587 -> 0.606 at the pooled band, the same at
//   hd = 16, in one call) and G's taking each tile's P_h . V apart nothing
//   (1.449 -> 1.452). Without each step: one block a row instead of the
//   ring +13% / +11% at the probe and the pooled band (G +8% / +8% / +25% at
//   n = 65; at n = 146 a forced ring, one 138 KB block an SM, made G 2.2x
//   slower); the online softmax instead of the exact maximum +25% / +23%; a k16
//   Q.K^T instead of m16n8k8 at hd = 4 +8% / +9%; mma.sync instead of wgmma at
//   hd = 16 +43% / +54% (0.283 / 0.992; the first design's mma.sync
//   0.280 / 0.909); one warpgroup a block at n = 146 +15% (the same at n = 65);
//   G without its skip of the other heads' steps and tiles +15-27%. Measured
//   and not kept: 16-byte cp.async instead of TMA row copies (F 1-2% faster at
//   hd = 4, G 8-12% slower); skipping the products (F 2-5% slower) and, in the
//   exact form and wgmma, the exps (F 0-5% slower: the branches cost more than
//   the padding's exps) of all-padding key halves and rows. G takes
//   1.426 / 0.493 / 1.775 ms (7.183 / 2.087 / 7.509 in the first design),
//   2.4-2.7x F.
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
#include "hopper.cuh"
#include "mma.cuh"

#include <math.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;      // a block
constexpr size_t kSmSmem = 233472;       // an SM (228 KB)
constexpr int kMmaMaxHd = 16;
constexpr int kMmaMaxC = 256;
constexpr int kMaskedMaxC = 128;         // the masked accumulator: C / 2 regs
constexpr int kMaxN = 512;
constexpr int kMmaSlack = 16;            // elements a window reads past a row
constexpr int kWgmmaMaxN = 160;          // wgmma scores in registers
constexpr int kWgmmaMaxGroups = 2;       // warpgroups a wgmma block, max
constexpr int kOuterMaxThreads = 256;
constexpr int kOuterMaxHd = 32;
// V3's design constants (each one a step of its ablation in PERF.md)
constexpr int kMmaMaxWarps = 8;          // F: warps a block, at most
constexpr int kMaskedMaxWarps = 8;       // G: the same
constexpr int kMmaWarpsPerSm = 24;       // F: resident warps ptxas plans
constexpr int kMaskedWarpsPerSm = 16;    // G: the same (registers <= 128)
constexpr int kExactTiles = 5;           // F: key tiles of the exact max
// V4's design constants (each one a step of its ablation in PERF.md)
constexpr int kOuterTile = 4;            // keys a rescale of the online form
constexpr int kExactMaxHd = 8;           // HD <= this: two passes, exact max
constexpr int kRowsHd4 = 8;              // query rows a thread at HD = 4
constexpr int kRowsHd16 = 3;             // query rows a thread at HD = 16

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

// ---- V3: the tensor cores ---------------------------------------------------

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// bytes of one staged batch row: q, k, v as pad16(n) token rows of cs
// bf16 each, kMmaSlack values for the fragment windows that reach past the
// last row, and the row's mbarrier
__host__ __device__ inline size_t mma_stage_bytes(int n, int cs) {
  return sizeof(__nv_bfloat16) * (3 * pad16(n) * cs + kMmaSlack) +
         sizeof(uint64_t);
}

// bf16 elements of a staged token row: C rounded up to 8, then to an odd
// number of 16-byte units, so that the 8 rows an ldmatrix reads start in 8
// different bank groups; where that leaves a batch row over one block's
// shared memory, C rounded up to 8 (the first design's shapes all fit)
__host__ __device__ inline int mma_stride(int n, int C) {
  const int w = (C + 7) / 8 * 8;
  const int odd = (w / 8) % 2 ? w : w + 8;
  return mma_stage_bytes(n, odd) <= kMaxSmem ? odd : w;
}

// bf16 elements of one staged batch row, its mbarrier not counted
__host__ __device__ inline int mma_stage_elems(int n, int C) {
  return 3 * pad16(n) * mma_stride(n, C) + kMmaSlack;
}

// bytes of a V3 block: `stages` staged batch rows and their mbarriers
size_t mma_smem(int n, int C, int stages) {
  return stages * mma_stage_bytes(n, mma_stride(n, C));
}

// the row and column each lane addresses for ldmatrix: x4 of an A tile (and
// of V transposed), x4 of two K halves; x2 reads the addresses of lanes
// 0-15
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x & 31;
    a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
    a_col = 8 * (lane >> 4);
    b_row = (lane & 7) + 8 * (lane >> 4);
    b_col = 8 * ((lane >> 3) & 1);
  }
};

// Zeroes what the row copies never write: columns [C, cs) of rows < n,
// the pad rows [n, np) and the slack. Warp per row: no division.
__device__ void zero_stage(__nv_bfloat16* s, int n, int C, int cs, int np) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const __nv_bfloat16 z = __float2bfloat16(0.f);
  for (int t = 0; t < 3; ++t)
    for (int j = warp; j < np; j += warps)
      for (int c = (j < n ? C : 0) + lane; c < cs; c += 32)
        s[(t * np + j) * cs + c] = z;
  if (threadIdx.x < kMmaSlack) s[3 * np * cs + threadIdx.x] = z;
}

// How a batch row reaches shared memory: one TMA bulk copy per token row,
// or plain loads
enum Staging : int { kPlain = 0, kBulkRows = 1 };

// Stages batch row `row` of q, k, v (n tokens of C) into s (three [np][cs]
// blocks). kBulkRows: warp 0 issues one TMA bulk copy per token row (C x 2
// bytes, a multiple of 16; 16-byte aligned), completed on `bar`, which
// expects all 3 n C x 2 bytes; the caller waits on it. kPlain: a warp per
// token row copies 4-byte words (`words`: q, k, v 4-byte aligned) or
// single values; the caller's barrier completes it.
template <int kStage>
__device__ __forceinline__ void stage_row(__nv_bfloat16* s, uint64_t* bar,
                                          const __nv_bfloat16* q,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v,
                                          long long row, int n, int C,
                                          int cs, int np, int words) {
  const size_t src0 = static_cast<size_t>(row) * n * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kStage == kBulkRows) {
    if (warp != 0) return;
    if (lane == 0) vct::mbar_expect_tx(bar, 3u * n * C * 2);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat16* x = (t == 0 ? q : t == 1 ? k : v) + src0;
      for (int j = lane; j < n; j += 32)
        vct::bulk_copy(s + (t * np + j) * cs, x + static_cast<size_t>(j) * C,
                       C * 2, bar);
    }
  } else {
    const int warps = blockDim.x >> 5;
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat16* x = (t == 0 ? q : t == 1 ? k : v) + src0;
      for (int j = warp; j < n; j += warps) {
        const __nv_bfloat16* src = x + static_cast<size_t>(j) * C;
        __nv_bfloat16* dst = s + (t * np + j) * cs;
        if (words)
          for (int c = 2 * lane; c < C; c += 64)
            *reinterpret_cast<uint32_t*>(dst + c) = vct::pair(src + c);
        else
          for (int c = lane; c < C; c += 32) dst[c] = src[c];
      }
    }
  }
}

// Scores of keys k0 .. k0 + 15 for a warp's 16 query rows over a window of
// W x 8 channels from `base`: a k16 product for its first 16 channels and
// a k8 product for an odd eighth (qa, qr: Q's fragments, zero outside the
// head). km masks K's fragment words to the head as Q's are: channels 2t,
// 8 + 2t of the k16 step and 2t of the k8 one (t = lane % 4), so that a
// neighbouring head's channels, inf or NaN included, add exact zeros.
template <int W>
__device__ __forceinline__ void qk_tile(float (&s)[2][4],
                                        const uint32_t (&qa)[4],
                                        const uint32_t (&qr)[2],
                                        const uint32_t (&km)[3],
                                        const __nv_bfloat16* sK, int cs,
                                        int k0, int base, const Lanes& ln) {
  if constexpr (W >= 2) {
    uint32_t kb[4];
    vct::ldsm_x4(kb, sK + (k0 + ln.b_row) * cs + base + ln.b_col);
    vct::mma(s[0], qa, kb[0] & km[0], kb[1] & km[1]);
    vct::mma(s[1], qa, kb[2] & km[0], kb[3] & km[1]);
  }
  if constexpr (W % 2 == 1) {
    uint32_t kb[2];
    vct::ldsm_x2(kb, sK + (k0 + ln.a_row) * cs + base + 16 * (W / 2));
    vct::mma_k8(s[0], qr, kb[0] & km[2]);
    vct::mma_k8(s[1], qr, kb[1] & km[2]);
  }
}

// P.V of keys k0 .. k0 + 15 into the window's W n8 tiles: V row-major,
// its B fragments by ldmatrix.trans
template <int W>
__device__ __forceinline__ void pv_tile(float (&acc)[W][4],
                                        const uint32_t (&pa)[4],
                                        const __nv_bfloat16* sV, int cs,
                                        int k0, int base, const Lanes& ln) {
#pragma unroll
  for (int nt = 0; nt + 1 < W; nt += 2) {
    uint32_t vb[4];
    vct::ldsm_x4_t(vb, sV + (k0 + ln.a_row) * cs + base + 8 * nt + ln.a_col);
    vct::mma(acc[nt], pa, vb[0], vb[1]);
    vct::mma(acc[nt + 1], pa, vb[2], vb[3]);
  }
  if constexpr (W % 2 == 1) {
    uint32_t vb[2];
    vct::ldsm_x2_t(vb, sV + (k0 + ln.a_row) * cs + base + 8 * (W - 1));
    vct::mma(acc[W - 1], pa, vb[0], vb[1]);
  }
}

// the head window of channels [c0, c0 + hd): 8-channel units from c0
// rounded down to 8
__host__ __device__ inline int window(int c0, int hd) {
  return ((c0 & 7) + hd + 7) / 8;
}

// F: one (head, 16-query tile) task. The head's channels [c0, c0 + hd) lie
// in a window of W x 8 channels from base = c0 rounded down to 8, so every
// ldmatrix row is 16-byte aligned whatever hd is; Q's and K's fragments are
// zeroed outside the head, which zeroes the other channels' products, and
// only the head's output columns are stored. KT > 0 (n <= 16 KT): all scores
// stay in registers, each row's exact maximum first, then the exps and
// P.V with no rescale; KT = 0: the online softmax a 16-key tile at a time.
template <int W, int KT>
__device__ void head_task(const __nv_bfloat16* sQ, const __nv_bfloat16* sK,
                          const __nv_bfloat16* sV, int cs, int n, int c0,
                          int hd, int q0, float scale_log2,
                          __nv_bfloat16* o, int C) {
  const Lanes ln;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int base = c0 & ~7, off = c0 - base;
  const bool upper = q0 + 8 < n;             // rows q0 + 8.. hold a query
  const auto in_head = [off, hd](int col) {
    return col >= off && col < off + hd;
  };
  // hd and off are even: a pair of channels is all in the head or all out
  const uint32_t km[3] = {in_head(2 * t) ? ~0u : 0u,
                          in_head(8 + 2 * t) ? ~0u : 0u,
                          in_head(16 * (W / 2) + 2 * t) ? ~0u : 0u};
  uint32_t qa[4] = {0u, 0u, 0u, 0u}, qr[2] = {0u, 0u};
  if constexpr (W >= 2) {
    vct::ldsm_x4(qa, sQ + (q0 + ln.a_row) * cs + base + ln.a_col);
    qa[0] &= km[0];
    qa[1] &= km[0];
    qa[2] &= km[1];
    qa[3] &= km[1];
  }
  if constexpr (W % 2 == 1) {
    vct::ldsm_x2(qr, sQ + (q0 + ln.a_row) * cs + base + 16 * (W / 2));
    qr[0] &= km[2];
    qr[1] &= km[2];
  }
  const int tiles = (n + 15) / 16;
  float acc[W][4] = {};
  float l[2] = {0.f, 0.f};
  if constexpr (KT > 0) {
    float s[KT][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      if (kt < tiles)
        qk_tile<W>(s[kt], qa, qr, km, sK, cs, 16 * kt, base, ln);
    // each row's maximum raw score (scale > 0), padded keys -inf; then
    // P = 2^(s scale_log2 - max scale_log2), one FFMA and one MUFU a score
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt >= tiles) break;
      if (16 * kt + 16 > n)                    // the tile holding key n - 1
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (16 * kt + 8 * half + 2 * t + (e & 1) >= n)
              s[kt][half][e] = -INFINITY;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[kt][half][e]);
    }
    mx[0] = -vct::quad_max(mx[0]) * scale_log2;
    mx[1] = upper ? -vct::quad_max(mx[1]) * scale_log2 : 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt >= tiles) break;
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[half][e] = vct::exp2_approx(
              fmaf(s[kt][half][e], scale_log2, mx[e >> 1]));
          l[e >> 1] += p[half][e];
        }
      }
      const uint32_t pa[4] = {vct::pack(p[0][0], p[0][1]),
                              vct::pack(p[0][2], p[0][3]),
                              vct::pack(p[1][0], p[1][1]),
                              vct::pack(p[1][2], p[1][3])};
      pv_tile<W>(acc, pa, sV, cs, 16 * kt, base, ln);
    }
  } else {
    float m[2] = {-INFINITY, -INFINITY};
    for (int k0 = 0; k0 < n; k0 += 16) {
      float s[2][4] = {};
      qk_tile<W>(s, qa, qr, km, sK, cs, k0, base, ln);
      float alpha[2];
      uint32_t pa[4];
      vct::softmax_tile(s, k0, n, upper, scale_log2, m, l, alpha, pa);
#pragma unroll
      for (int nt = 0; nt < W; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
      pv_tile<W>(acc, pa, sV, cs, k0, base, ln);
    }
  }
  const float inv[2] = {1.f / vct::quad_sum(l[0]),
                        upper ? 1.f / vct::quad_sum(l[1]) : 0.f};
#pragma unroll
  for (int nt = 0; nt < W; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (!in_head(col)) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row < n)
        *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(row) * C +
                                     base + col) =
            vct::pack(acc[nt][2 * r] * inv[r], acc[nt][2 * r + 1] * inv[r]);
    }
  }
}

// G: one 16-query tile for all heads (C a multiple of 16, <= 16 KS). For each
// head h, full-width dots over C against K with the other heads' channels
// zeroed (Q's and K's fragment words zeroed there), the online softmax,
// and P_h . (V with the other heads zeroed) added into the one (16, C)
// float32 accumulator: each n8 tile's P_h . V is taken apart and only its
// head-h columns are added (rescaled accumulator plus product), the same
// sums as adding the zeros, except that no other head's columns see P_h,
// NaN or not. After the last key tile the head-h columns are normalised.
// The k16 steps of Q.K^T and the n8 tiles of P.V that hold none of head
// h's channels (they add exact zeros) are skipped.
template <int KS>
__device__ void masked_task(const __nv_bfloat16* sQ, const __nv_bfloat16* sK,
                            const __nv_bfloat16* sV, int cs, int n, int h,
                            int hd, int q0, float scale_log2,
                            __nv_bfloat16* o, int C) {
  constexpr int kSteps = KS;                  // k16 steps of Q.K^T over C
  constexpr int kTiles = 2 * KS;              // n8 tiles of the output
  const Lanes ln;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int steps = C / 16, ntiles = C / 8;
  const bool upper = q0 + 8 < n;
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    if (ks < steps)
      vct::ldsm_x4(qa[ks], sQ + (q0 + ln.a_row) * cs + 16 * ks + ln.a_col);
  float acc[kTiles][4] = {};
  for (int head = 0; head < h; ++head) {
    // this head's channels [lo, hi); hd is even, so a pair never straddles
    const int lo = head * hd, hi = lo + hd;
    const auto mine = [lo, hi](int c) { return c >= lo && c < hi; };
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += 16) {
      float s[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (ks >= steps || 16 * ks + 16 <= lo || 16 * ks >= hi) continue;
        const int c = 16 * ks + 2 * t;
        const uint32_t mlo = mine(c) ? ~0u : 0u, mhi = mine(c + 8) ? ~0u : 0u;
        const uint32_t a[4] = {qa[ks][0] & mlo, qa[ks][1] & mlo,
                               qa[ks][2] & mhi, qa[ks][3] & mhi};
        uint32_t kb[4];
        vct::ldsm_x4(kb, sK + (k0 + ln.b_row) * cs + 16 * ks + ln.b_col);
        vct::mma(s[0], a, kb[0] & mlo, kb[1] & mhi);
        vct::mma(s[1], a, kb[2] & mlo, kb[3] & mhi);
      }
      float alpha[2];
      uint32_t pa[4];
      vct::softmax_tile(s, k0, n, upper, scale_log2, m, l, alpha, pa);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        if (nt >= ntiles || 8 * nt + 8 <= lo || 8 * nt >= hi) continue;
        uint32_t vb[2];
        vct::ldsm_x2_t(vb, sV + (k0 + ln.a_row) * cs + 8 * nt);
        float d[4] = {};
        vct::mma(d, pa, vb[0], vb[1]);
        if (mine(8 * nt + 2 * t))              // this head's output columns
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[nt][e] = fmaf(acc[nt][e], alpha[e >> 1], d[e]);
      }
    }
    const float inv[2] = {1.f / vct::quad_sum(l[0]),
                          upper ? 1.f / vct::quad_sum(l[1]) : 0.f};
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
        *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(row) * C +
                                     8 * nt + 2 * t) =
            vct::pack(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// V3 (mma.sync): a grid of blocks, each walking batch rows blockIdx.x,
// blockIdx.x + gridDim.x, ...: with `stages` = 2 (a persistent grid of
// resident blocks) the next row's copies are in flight while this row
// computes; with 1 (a block a row, grid = B) the loop runs once. Warps take
// the row's tasks: (head, 16-query tile) for F, 16-query tiles for G. WMAX:
// F's widest head window (in 8s), or G's k16 steps over C: the registers
// are sized to the shape, not to the widest one the kernel takes.
template <bool kMasked, int kStage, int KT, int WMAX>
__global__ void __launch_bounds__(
    32 * (kMasked ? kMaskedMaxWarps : kMmaMaxWarps),
    kMasked ? kMaskedWarpsPerSm / kMaskedMaxWarps
            : kMmaWarpsPerSm / kMmaMaxWarps)
heads_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, long long B, int n, int h,
                 int hd, float scale_log2, int stages, int words) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = h * hd, cs = mma_stride(n, C), np = pad16(n);
  const int elems = mma_stage_elems(n, C);
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem_raw + sizeof(__nv_bfloat16) * stages * elems);
  for (int st = 0; st < stages; ++st)
    zero_stage(stage0 + st * elems, n, C, cs, np);
  if (kStage == kBulkRows && threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) vct::mbar_init(bars + st, 1);
    vct::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int tiles = np / 16;
  long long row = blockIdx.x;
  if (row < B)
    stage_row<kStage>(stage0, bars, q, k, v, row, n, C, cs, np, words);
  for (int it = 0; row < B; ++it, row += gridDim.x) {
    const int st = stages == 2 ? (it & 1) : 0;
    const long long next = row + gridDim.x;
    if (stages == 2 && next < B)
      stage_row<kStage>(stage0 + (st ^ 1) * elems, bars + (st ^ 1), q, k, v,
                      next, n, C, cs, np, words);
    if (kStage == kBulkRows)
      vct::mbar_wait(bars + st, (it / stages) & 1);
    else
      __syncthreads();
    const __nv_bfloat16* sQ = stage0 + st * elems;
    const __nv_bfloat16* sK = sQ + np * cs;
    const __nv_bfloat16* sV = sK + np * cs;
    __nv_bfloat16* orow = o + static_cast<size_t>(row) * n * C;
    if constexpr (kMasked) {
      for (int task = warp; task < tiles; task += warps)
        masked_task<WMAX>(sQ, sK, sV, cs, n, h, hd, 16 * task, scale_log2,
                          orow, C);
    } else {
      // tile-major: the last (often mostly padding) tiles of the heads
      // fall in the last round, spread over the warps
      for (int task = warp; task < h * tiles; task += warps) {
        const int tile = task / h, head = task - tile * h, q0 = 16 * tile;
        const int c0 = head * hd;
        const int w = window(c0, hd);
        if (WMAX == 1 || w == 1)
          head_task<1, KT>(sQ, sK, sV, cs, n, c0, hd, q0, scale_log2, orow,
                           C);
        else if (WMAX == 2 || w == 2)
          head_task<(WMAX < 2 ? WMAX : 2), KT>(sQ, sK, sV, cs, n, c0, hd,
                                               q0, scale_log2, orow, C);
        else
          head_task<WMAX, KT>(sQ, sK, sV, cs, n, c0, hd, q0, scale_log2, orow,
                              C);
      }
    }
    __syncthreads();                           // this stage's reads done
  }
}

// ---- V3 on wgmma (hd = 16, C = 64) ----------------------------------------

// element (r, 8 c8 + i) of a [rows][64] bf16 block in the 128-byte swizzle:
// the 16-byte chunk c8 of row r lives at chunk c8 ^ (r % 8)
__device__ __forceinline__ const __nv_bfloat16* swz(const __nv_bfloat16* s,
                                                    int r, int c8) {
  return s + r * 64 + ((c8 ^ (r & 7)) << 3);
}

// The scores of a warpgroup's 64 query rows against keys [0, 8 ng) of one
// head (16 channels at byte 32 head of each K row): one m64n64k16 per 64
// keys and one m64n8k16 per remaining 8, K from the swizzled shared
// memory, Q's A fragment from registers. Waits for the products.
template <int NGB>
__device__ __forceinline__ void wgmma_scores(float (&s)[NGB][4],
                                             const uint32_t (&qa)[4],
                                             const __nv_bfloat16* sK,
                                             int head, int ng) {
  const auto desc = [&](int group) {
    return vct::sw128_desc(sK + group * 8 * 64) + 2 * head;
  };
#pragma unroll
  for (int j = 0; j < NGB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) vct::fence_operand(s[j][e]);
  vct::wgmma_fence();
  if constexpr (NGB >= 8)
    if (ng >= 8) vct::wgmma_n64<0>(s, qa, desc(0), 0);
  if constexpr (NGB >= 16)
    if (ng >= 16) vct::wgmma_n64<8>(s, qa, desc(8), 0);
#pragma unroll
  for (int j = 0; j < NGB; ++j)
    if (j >= ng / 8 * 8 && j < ng) vct::wgmma_n8(s[j], qa, desc(j), 0);
  vct::wgmma_commit();
  vct::wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NGB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) vct::fence_operand(s[j][e]);
}

// V3's F at hd = 16 and C = 64 on wgmma: one block of GROUPS warpgroups
// per batch row; q, k, v staged by 16-byte cp.async copies into
// [pad16(n)][64] blocks in the 128-byte swizzle (the layout wgmma reads K
// from), pad rows zeroed. A warpgroup takes (head, 64-query tile) tasks:
// Q.K^T is one wgmma product per head and tile over the keys padded to 8
// (wgmma_scores), all scores in registers; then each warp holds 16 query
// rows in mma.sync's C layout, takes each row's exact maximum, the exps
// and P.V on mma.sync (V's B fragments by ldmatrix.trans: wgmma would read
// V at 16 channels in a swizzle the 64-channel rows do not have). Warps
// whose 16 rows are all padding only join the product.
template <int NGB, int GROUPS>
__global__ void __launch_bounds__(128 * GROUPS)
heads_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int n, int h,
                   float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  constexpr int C = 64;
  const int np = pad16(n);
  const size_t src0 = static_cast<size_t>(blockIdx.x) * n * C;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const __nv_bfloat16* x = (t == 0 ? q : t == 1 ? k : v) + src0;
    __nv_bfloat16* dst = s + t * np * C;
    for (int idx = threadIdx.x; idx < np * 8; idx += blockDim.x) {
      const int j = idx >> 3, c8 = idx & 7;
      __nv_bfloat16* d = dst + j * C + ((c8 ^ (j & 7)) << 3);
      if (j < n)
        vct::cp_async<16>(d, x + j * C + 8 * c8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  vct::cp_async_wait_all();
  vct::fence_proxy_async();
  __syncthreads();

  const __nv_bfloat16* sQ = s;
  const __nv_bfloat16* sK = s + np * C;
  const __nv_bfloat16* sV = sK + np * C;
  __nv_bfloat16* orow = o + src0;
  const Lanes ln;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wi = warp & 3, t = lane & 3, g = lane >> 2;
  const int ng = (n + 7) / 8, mtiles = (n + 63) / 64;
  // tile-major, so that the warpgroups share the mostly-padding last tiles
  for (int task = wg; task < h * mtiles; task += GROUPS) {
    const int mtile = task / h, head = task - mtile * h;
    const int q0 = 64 * mtile + 16 * wi;
    const bool live = q0 < n, upper = q0 + 8 < n;
    uint32_t qa[4] = {0u, 0u, 0u, 0u};
    if (live)
      vct::ldsm_x4(qa, swz(sQ, q0 + ln.a_row, 2 * head + (lane >> 4)));
    float sc[NGB][4] = {};
    wgmma_scores<NGB>(sc, qa, sK, head, ng);
    if (!live) continue;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NGB; ++j) {
      if (j >= ng) break;                      // groups past 8 ng: no keys
      if (8 * j + 8 > n)                       // the group holding key n - 1
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= n) sc[j][e] = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
    mx[0] = -vct::quad_max(mx[0]) * scale_log2;
    mx[1] = upper ? -vct::quad_max(mx[1]) * scale_log2 : 0.f;
    float l[2] = {0.f, 0.f}, acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < (NGB + 1) / 2; ++kk) {
      if (2 * kk >= ng) break;
      float p[2][4] = {};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (2 * kk + half >= NGB || 2 * kk + half >= ng) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[half][e] = vct::exp2_approx(
              fmaf(sc[2 * kk + half][e], scale_log2, mx[e >> 1]));
          l[e >> 1] += p[half][e];
        }
      }
      const uint32_t pa[4] = {vct::pack(p[0][0], p[0][1]),
                              vct::pack(p[0][2], p[0][3]),
                              vct::pack(p[1][0], p[1][1]),
                              vct::pack(p[1][2], p[1][3])};
      uint32_t vb[4];
      vct::ldsm_x4_t(vb, swz(sV, 16 * kk + ln.a_row,
                             2 * head + (ln.a_col >> 3)));
      vct::mma(acc[0], pa, vb[0], vb[1]);
      vct::mma(acc[1], pa, vb[2], vb[3]);
    }
    const float inv[2] = {1.f / vct::quad_sum(l[0]),
                          upper ? 1.f / vct::quad_sum(l[1]) : 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row < n)
          *reinterpret_cast<uint32_t*>(orow + static_cast<size_t>(row) * C +
                                       16 * head + 8 * nt + 2 * t) =
              vct::pack(acc[nt][2 * r] * inv[r], acc[nt][2 * r + 1] * inv[r]);
      }
  }
}

// bytes of a wgmma block: q, k, v as [pad16(n)][64] bf16 and 1,024 for
// aligning the swizzle atoms
size_t wgmma_smem(int n) {
  return 3 * sizeof(__nv_bfloat16) * pad16(n) * 64 + 1024;
}

bool takes_wgmma(const void* q, const void* k, const void* v, int n, int h,
                 int hd, int masked) {
  return !masked && hd == 16 && h == 4 && n <= kWgmmaMaxN &&
         vct::aligned16(q) && vct::aligned16(k) && vct::aligned16(v);
}

// the warpgroups a block (1 .. kWgmmaMaxGroups) that keep the most warps
// resident, the fewest on a tie: more, smaller blocks overlap one row's
// staging with other rows' products (at n = 65 one group: 0.205 against
// 0.226 ms for two, 6 blocks of 1 an SM beside 3 of 2; at n = 146 two:
// 0.646 against 0.742, where shared memory holds 1-group blocks to 3)
template <int NGB, int GROUPS>
int launch_wgmma_as(const void* q, const void* k, const void* v, void* o,
                    int B, int n, int h, float scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem(n);
  const auto kernel = heads_wgmma_kernel<NGB, GROUPS>;
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 128 * GROUPS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n, h, scale * vct::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int NGB>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int n, int h, float scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem(n);
  const auto one = heads_wgmma_kernel<NGB, 1>;
  const auto two = heads_wgmma_kernel<NGB, 2>;
  int one_blocks = 0, two_blocks = 0;
  cudaError_t err = vct::allow_smem(one, smem);
  if (err == cudaSuccess) err = vct::allow_smem(two, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&one_blocks, one,
                                                        128, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&two_blocks, two,
                                                        256, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kWgmmaMaxGroups > 1 && 2 * two_blocks > one_blocks
             ? launch_wgmma_as<NGB, 2>(q, k, v, o, B, n, h, scale, stream)
             : launch_wgmma_as<NGB, 1>(q, k, v, o, B, n, h, scale, stream);
}

template <bool kMasked, int kStage, int KT, int WMAX>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int n, int h, int hd, float scale, int words,
               cudaStream_t stream) {
  const auto kernel = heads_mma_kernel<kMasked, kStage, KT, WMAX>;
  const int C = h * hd, tiles = pad16(n) / 16;
  const int tasks = kMasked ? tiles : h * tiles;
  const int cap = kMasked ? kMaskedMaxWarps : kMmaMaxWarps;
  const int rounds = (tasks + cap - 1) / cap;
  const int threads = 32 * ((tasks + rounds - 1) / rounds);
  int stages = 1;
  long long grid = B;
  // the ring where two blocks of two stages fit an SM (at n = 146 one
  // block of 138 KB an SM loses to three of one stage)
  if (2 * mma_smem(n, C, 2) <= kSmSmem) {
    stages = 2;
    cudaError_t err = vct::allow_smem(kernel, mma_smem(n, C, 2));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, mma_smem(n, C, 2));
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = std::min<long long>(B, std::max(1, per_sm * sms));
  }
  const size_t smem = mma_smem(n, C, stages);
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      B, n, h, hd, scale * vct::kLog2e, stages, words);
  return static_cast<int>(cudaGetLastError());
}

// WMAX for the shape: F's widest head window, or G's k16 steps (4 up to
// C = 64, else 8)
template <bool kMasked, int kStage, int KT>
int mma_by_width(const void* q, const void* k, const void* v, void* o, int B,
                 int n, int h, int hd, float scale, int words,
                 cudaStream_t st) {
  if (kMasked)
    return h * hd <= 64
               ? launch_mma<true, kStage, 0, 4>(q, k, v, o, B, n, h, hd, scale,
                                              words, st)
               : launch_mma<true, kStage, 0, 8>(q, k, v, o, B, n, h, hd, scale,
                                              words, st);
  int w = 1;
  for (int head = 0; head < h; ++head)
    w = std::max(w, window(head * hd, hd));
  if (w == 1)
    return launch_mma<false, kStage, KT, 1>(q, k, v, o, B, n, h, hd, scale,
                                          words, st);
  if (w == 2)
    return launch_mma<false, kStage, KT, 2>(q, k, v, o, B, n, h, hd, scale,
                                          words, st);
  return launch_mma<false, kStage, KT, 3>(q, k, v, o, B, n, h, hd, scale,
                                        words, st);
}

// the staging route (TMA bulk copies where every token row is 16 bytes
// wide and aligned, else plain loads) and the softmax form (KT: key tiles
// in registers)
template <bool kMasked, int KT>
int mma_by_staging(const void* q, const void* k, const void* v, void* o,
                   int B, int n, int h, int hd, float scale,
                   cudaStream_t st) {
  const bool rows16 = (h * hd) % 8 == 0 && vct::aligned16(q) &&
                      vct::aligned16(k) && vct::aligned16(v);
  const auto aligned4 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 4 == 0;
  };
  const int words = aligned4(q) && aligned4(k) && aligned4(v);
  if (rows16)
    return mma_by_width<kMasked, kBulkRows, KT>(q, k, v, o, B, n, h, hd,
                                                scale, words, st);
  return mma_by_width<kMasked, kPlain, KT>(q, k, v, o, B, n, h, hd, scale,
                                           words, st);
}

template <bool kMasked>
int mma_by_fit(const void* q, const void* k, const void* v, void* o, int B,
               int n, int h, int hd, float scale, cudaStream_t st) {
  if (!kMasked && pad16(n) / 16 <= kExactTiles)
    return mma_by_staging<false, kExactTiles>(q, k, v, o, B, n, h, hd, scale,
                                              st);
  return mma_by_staging<kMasked, 0>(q, k, v, o, B, n, h, hd, scale, st);
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
// 16 and <= 128), n <= 512, and a staged batch row within one block's
// shared memory; anything else is cudaErrorInvalidValue
extern "C" int vct_heads_attention_mma(const void* q, const void* k,
                                       const void* v, void* o, int B, int n,
                                       int h, int hd, float scale, int masked,
                                       void* stream) {
  const int C = h * hd;
  if (n < 1 || n > kMaxN || h < 1 || hd < 2 || hd > kMmaMaxHd || hd % 2 ||
      C > kMmaMaxC || mma_smem(n, C, 1) > kMaxSmem ||
      (masked && (C % 16 || C > kMaskedMaxC)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (takes_wgmma(q, k, v, n, h, hd, masked))
    return n <= 80 ? launch_wgmma<10>(q, k, v, o, B, n, h, scale, st)
                   : launch_wgmma<20>(q, k, v, o, B, n, h, scale, st);
  return masked ? mma_by_fit<true>(q, k, v, o, B, n, h, hd, scale, st)
                : mma_by_fit<false>(q, k, v, o, B, n, h, hd, scale, st);
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
