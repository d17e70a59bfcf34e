// K4: small-sequence attention, softmax(q k^T * scale) v per group.
//
// Replaces the Pallas TPU kernel built by vit_cnn_tpu/ops/attention.py
// `_make_kernel` (launched by `_pallas_attention`). q is (G, Lq, dh), k and
// v are (G, Lk, dh), with G the folded batch (and heads). The flagship's
// NonLocal block calls it at (Lq, Lk, dh) = (49, 9, 128) and (25, 4, 72)
// with scale 1.0 and G = windows per band.
//
// What bounds it on the H100: per group it reads Lq*dh + 2*Lk*dh values
// and writes Lq*dh, and does 4*Lq*Lk*dh FLOPs: about 7.6 FLOPs per byte
// in bf16 at the larger shape, far below the tensor cores' ~295 and below
// even the CUDA cores' float32 ridge (67e12 / 3.35e12 = 20), so it is
// memory bound once the scores stay on chip. The scores never leave the
// SM.
//
// The first K4 (kept as the generic instance, `attention_kernel`) took one
// group a block: it staged k and v as float32 with 2-byte loads behind two
// barriers, then each warp walked query rows one at a time, each row
// Lk serial 5-shuffle warp sums, a precise expf and an IEEE division,
// storing 2 bytes a lane: a few KB in flight an SM, ~0.5 TB/s.
//
// The tiled instance (`attention_tile_kernel`; dh % 8 == 0, Lk <= 16,
// q, k, v and o 16-byte aligned: the flagship's shapes):
// - A block takes a tile of groups, as many as fit 12,288 float32 values
//   of k and v (5 groups at (49, 9, 128), 21 at (25, 4, 72)). Every
//   thread issues all its 16-byte loads of the tile's k and v (6 in bf16,
//   12 in float32) before converting any, then stores them in shared
//   memory as float32, k scaled by scale * log2 e, each key row permuted
//   so that neighbouring threads read neighbouring 16 bytes. One barrier
//   a block; 2 resident blocks an SM overlap one block's staging with the
//   other's rows.
// - A q row is split into 8-channel slices over P = 2^p neighbouring
//   threads (16 at dh 128 and at dh 72, where 7 hold zeros). A thread
//   takes two rows of one group at a time, so each k and v value it reads
//   from shared memory serves both: shared-memory reads (4 B a lane a
//   clock an SM) bounded the one-row form (0.19 ms against 0.14 at (49,
//   9, 128) in bf16). It loads each row slice with one 16-byte load (two
//   in float32), the next pass's rows one pass ahead, forms its Lk
//   partial dot products a row in registers (Lk fixed at compile time
//   for 9 and 4) and sums them across the row's threads with xor-shuffles
//   interleaved over the keys: log2 P dependent steps, not Lk serial warp
//   sums.
// - The softmax stays in float32 registers (`ex2.approx`, one reciprocal
//   a row), P is not rounded, and the thread stores its 8 outputs of a
//   row of P.V with one 16-byte store.
// Shapes outside that domain (Lk > 16, dh not a multiple of 8,
// misaligned views) take the generic instance; nothing falls back to the
// plain version.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxLk = 64;
constexpr int kMaxDh = 256;
constexpr int kPerLane = kMaxDh / 32;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int G, int Lq,
                 int Lk, int dh, float scale) {
  extern __shared__ float smem[];
  float* sk = smem;                    // [Lk][dh]
  float* sv = sk + Lk * dh;            // [Lk][dh]
  float* sp = sv + Lk * dh;            // [warps][kMaxLk] scores, then probs
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* myp = sp + warp * kMaxLk;

  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    __syncthreads();                   // previous group's k/v reads done
    const size_t kv0 = static_cast<size_t>(g) * Lk * dh;
    for (int idx = threadIdx.x; idx < Lk * dh; idx += 32 * kWarps) {
      sk[idx] = vct::to_f32(k[kv0 + idx]);
      sv[idx] = vct::to_f32(v[kv0 + idx]);
    }
    __syncthreads();

    for (int r = warp; r < Lq; r += kWarps) {
      const size_t q0 = (static_cast<size_t>(g) * Lq + r) * dh;
      float qv[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + 32 * i;
        qv[i] = c < dh ? vct::to_f32(q[q0 + c]) : 0.f;
      }
      for (int j = 0; j < Lk; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < dh) part += qv[i] * sk[j * dh + c];
        }
        part = vct::warp_sum(part);
        if (lane == 0) myp[j] = part * scale;
      }
      __syncwarp();
      const float s0 = lane < Lk ? myp[lane] : -INFINITY;
      const float s1 = lane + 32 < Lk ? myp[lane + 32] : -INFINITY;
      const float m = vct::warp_max(fmaxf(s0, s1));
      const float e0 = lane < Lk ? expf(s0 - m) : 0.f;
      const float e1 = lane + 32 < Lk ? expf(s1 - m) : 0.f;
      const float sum = vct::warp_sum(e0 + e1);
      __syncwarp();
      if (lane < Lk) myp[lane] = e0 / sum;
      if (lane + 32 < Lk) myp[lane + 32] = e1 / sum;
      __syncwarp();
      for (int c = lane; c < dh; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < Lk; ++j) acc += myp[j] * sv[j * dh + c];
        o[q0 + c] = vct::from_f32<T>(acc);
      }
      __syncwarp();                    // probs read before the next row
    }
  }
}

template <typename T>
int launch_generic(const void* q, const void* k, const void* v, void* o, int G,
           int Lq, int Lk, int dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * Lk * dh + kWarps * kMaxLk);
  cudaError_t err = vct::allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = G < 65535 ? G : 65535;
  attention_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), G, Lq, Lk, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the tiled instance: dh % 8 == 0, Lk <= 16, 16-byte aligned ----

constexpr int kTileThreads = 256;
constexpr int kTileFloats = 12288;  // staged k and v of a tile, float32
constexpr int kSlice = 8;           // channels a thread owns
constexpr int kTileBlocks = 2;      // resident blocks an SM (<= 128 registers)
constexpr int kRows = 2;            // q rows a thread takes at a time
constexpr int kFastMaxLk = 16;

// The block's tile of groups: k and v of `ng` groups in float32, each
// key row permuted so that the thread that owns channels [8s, 8s + 8)
// finds its two float4 at 4s and 4s + dh / 2: neighbouring
// threads read neighbouring 16 bytes, with no bank conflicts.
__device__ __forceinline__ int permuted(int ch, int dh) {
  return (ch % kSlice) / 4 * (dh / (kSlice / 4)) + ch / kSlice * 4 + (ch & 3);
}

// LK: keys per group, or 0 for any Lk <= kFastMaxLk read at run time.
// A row of q is taken by P = 2^lanes_log2 neighbouring threads, each
// owning 8 channels (threads past dh / 8 hold zeros) of kRows rows of one
// group: they form the Lk partial dot products, sum them with
// xor-shuffles interleaved over the keys, take the softmax in float32
// registers and store 8 outputs a row.
template <typename T, int LK>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
attention_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int G,
                      int Lq, int Lk_rt, int dh, int tile, int lanes_log2,
                      float scale_log2e) {
  using V16 = vct::Vec16<T>;
  constexpr int kN = V16::kN;                       // values per 16 bytes
  constexpr int kChunks = kTileFloats / kN / kTileThreads;
  constexpr int KM = LK > 0 ? LK : kFastMaxLk;
  const int Lk = LK > 0 ? LK : Lk_rt;
  __shared__ __align__(16) float skv[kTileFloats];

  const int g0 = blockIdx.x * tile;
  const int ng = min(tile, G - g0);
  const int per = Lk * dh;                          // k (or v) values a group
  const int m = ng * per / kN;                      // 16-byte chunks of k

  // stage: every chunk of k and v of the tile in flight, then converted
  uint4 raw[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int idx = threadIdx.x + c * kTileThreads;
    if (idx < 2 * m) {
      const T* src = idx < m ? k : v;
      raw[c] = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(g0) * per +
          static_cast<size_t>(idx < m ? idx : idx - m) * kN);
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int idx = threadIdx.x + c * kTileThreads;
    if (idx < 2 * m) {
      const int tensor = idx < m ? 0 : 1;
      const int x = (idx - tensor * m) * kN;        // value in the tile
      const int g = x / per;
      const int j = (x - g * per) / dh;
      const int ch = x - g * per - j * dh;
      float val[kN];
      V16::unpack(raw[c], val);
      if (tensor == 0) {                            // scale * log2 e into k
#pragma unroll
        for (int e = 0; e < kN; ++e) val[e] *= scale_log2e;
      }
      float* dst = skv + ((g * 2 + tensor) * Lk + j) * dh;
#pragma unroll
      for (int h = 0; h < kN / 4; ++h)
        *reinterpret_cast<float4*>(dst + permuted(ch + 4 * h, dh)) =
            make_float4(val[4 * h], val[4 * h + 1], val[4 * h + 2],
                        val[4 * h + 3]);
    }
  }
  __syncthreads();

  constexpr int kQuads = kSlice / 4;                // float4 a slice of a row
  const int P = 1 << lanes_log2;
  const int units = kTileThreads >> lanes_log2;
  const int s = threadIdx.x & (P - 1);
  const int unit = threadIdx.x >> lanes_log2;
  const int S = dh / kSlice;
  const int stride = dh / kQuads;                   // between a thread's quads
  const bool lane_on = s < S;
  const int off = min(s, S - 1) * 4;
  // a unit takes a set of kRows rows of one group a pass, so that every
  // k and v value it reads from shared memory serves kRows rows
  const int sets = (Lq + kRows - 1) / kRows;
  const int passes = (ng * sets + units - 1) / units;
  const T* qt = q + static_cast<size_t>(g0) * Lq * dh + s * kSlice;
  T* ot = o + static_cast<size_t>(g0) * Lq * dh + s * kSlice;

  // kSlice channels of a q row as raw 16-byte words
  constexpr int kWords = kSlice / kN;
  auto row_on = [&](int g, int row) {
    return lane_on && g < ng && row < Lq;
  };
  auto load_q = [&](int g, int row0, uint4 (&w)[kRows][kWords]) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const T* src = qt + (static_cast<size_t>(g) * Lq + row0 + rr) * dh;
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[rr][i] = row_on(g, row0 + rr)
                       ? *reinterpret_cast<const uint4*>(src + i * kN)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  int g = unit / sets, set = unit - g * sets;       // this pass's rows
  uint4 qn[kRows][kWords];
  load_q(g, set * kRows, qn);
  for (int pass = 0; pass < passes; ++pass) {
    float qf[kRows][kSlice];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int w = 0; w < kWords; ++w) V16::unpack(qn[rr][w], qf[rr] + w * kN);
    int gn = g, setn = set;                         // the next pass's rows
    for (setn += units; setn >= sets; setn -= sets) ++gn;
    load_q(gn, setn * kRows, qn);
    const float* kg = skv + min(g, ng - 1) * 2 * per + off;
    const float* vg = kg + per;

    float sc[kRows][KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) sc[rr][j] = 0.f;
      if (LK > 0 || j < Lk) {
#pragma unroll
        for (int h = 0; h < kQuads; ++h) {
          const float4 a =
              *reinterpret_cast<const float4*>(kg + j * dh + h * stride);
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            const float* x = qf[rr] + 4 * h;
            float acc = fmaf(x[0], a.x, sc[rr][j]);
            acc = fmaf(x[1], a.y, acc);
            acc = fmaf(x[2], a.z, acc);
            sc[rr][j] = fmaf(x[3], a.w, acc);
          }
        }
      }
    }
    for (int x = P >> 1; x > 0; x >>= 1) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
        for (int j = 0; j < KM; ++j)
          sc[rr][j] += __shfl_xor_sync(0xffffffffu, sc[rr][j], x);
    }
    float inv[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float mx = sc[rr][0];
#pragma unroll
      for (int j = 1; j < KM; ++j)
        if (LK > 0 || j < Lk) mx = fmaxf(mx, sc[rr][j]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        sc[rr][j] = (LK > 0 || j < Lk) ? vct::ex2_approx(sc[rr][j] - mx) : 0.f;
        sum += sc[rr][j];
      }
      inv[rr] = __fdividef(1.f, sum);
    }
    float out[kRows][kSlice];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int c = 0; c < kSlice; ++c) out[rr][c] = 0.f;
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (LK > 0 || j < Lk) {
#pragma unroll
        for (int h = 0; h < kQuads; ++h) {
          const float4 a =
              *reinterpret_cast<const float4*>(vg + j * dh + h * stride);
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            const float p = sc[rr][j];
            float* y = out[rr] + 4 * h;
            y[0] = fmaf(p, a.x, y[0]);
            y[1] = fmaf(p, a.y, y[1]);
            y[2] = fmaf(p, a.z, y[2]);
            y[3] = fmaf(p, a.w, y[3]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = set * kRows + rr;
#pragma unroll
      for (int c = 0; c < kSlice; ++c) out[rr][c] *= inv[rr];
      if (row_on(g, row)) {
        T* dst = ot + (static_cast<size_t>(g) * Lq + row) * dh;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          *reinterpret_cast<uint4*>(dst + w * kN) = V16::pack(out[rr] + w * kN);
      }
    }
    g = gn;
    set = setn;
  }
}

template <typename T, int LK>
int launch_tile(const void* q, const void* k, const void* v, void* o, int G,
                int Lq, int Lk, int dh, float scale, cudaStream_t stream) {
  const int fit = kTileFloats / (2 * Lk * dh);    // groups a tile holds
  const int tile = G < fit ? G : fit;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < dh / kSlice) ++lanes_log2;
  const long long blocks = (static_cast<long long>(G) + tile - 1) / tile;
  attention_tile_kernel<T, LK><<<static_cast<unsigned>(blocks),
                                 kTileThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), G, Lq, Lk, dh, tile,
      lanes_log2, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int G,
           int Lq, int Lk, int dh, float scale, cudaStream_t stream) {
  const bool tiled = dh % 8 == 0 && Lk <= kFastMaxLk && vct::aligned16(q) &&
                     vct::aligned16(k) && vct::aligned16(v) &&
                     vct::aligned16(o);
  if (tiled && Lk == 9)
    return launch_tile<T, 9>(q, k, v, o, G, Lq, Lk, dh, scale, stream);
  if (tiled && Lk == 4)
    return launch_tile<T, 4>(q, k, v, o, G, Lq, Lk, dh, scale, stream);
  if (tiled)
    return launch_tile<T, 0>(q, k, v, o, G, Lq, Lk, dh, scale, stream);
  return launch_generic<T>(q, k, v, o, G, Lq, Lk, dh, scale, stream);
}

}  // namespace

extern "C" int vct_attention(int dtype, const void* q, const void* k,
                             const void* v, void* o, int G, int Lq, int Lk,
                             int dh, float scale, void* stream) {
  if (Lk < 1 || Lk > kMaxLk || dh < 1 || dh > kMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || Lq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return launch<float>(q, k, v, o, G, Lq, Lk, dh, scale, st);
  if (dtype == vct::kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, G, Lq, Lk, dh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
