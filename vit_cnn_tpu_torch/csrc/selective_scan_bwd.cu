// K5: selective-scan backward (the adjoint of K1), lane-major layout.
//
// Replaces the Pallas TPU kernel vit_cnn_tpu/ops/selective_scan.py
// `_scan_bwd_kernel` (launched by `_pallas_backward`). For the forward
//   h_t = dA_t * h_{t-1} + (dt_t * u_t) * B_t,   dA_t = exp(dt_t * A[d])
//   y_t = C_t . h_t + D[d] * u_t
// and the output cotangent g, the adjoint state runs against the scan
// direction:
//   lam_t = C_t * g_t + dA_{t+1} * lam_{t+1}
// and gives, per element,
//   du_t  = dt_t * S_t + D * g_t,        S_t = sum_i lam_t[i] B_t[i]
//   ddt_t = u_t * S_t + sum_i lam_t[i] h_{t-1}[i] dA_t[i] A[i]
//   dB_t  = sum_d lam_t * dt_t * u_t,    dC_t = sum_d h_t * g_t
// and, summed over streams, time and batch,
//   dA = sum lam_t * h_{t-1} * dA_t * dt_t,   dD = sum g_t * u_t.
//
// Layout as K1: u, dt, g, du, ddt are (ns, L, d, b); B, C, dB, dC are
// (ns, L, n, b); A (d, n) and D (d,) float32; b innermost. All arithmetic
// is float32.
//
// What bounds it on the H100: per (t, d, b) element and state entry it
// takes 3 exps (the forward, its recompute and the adjoint's dA_t) and
// ~16 FP32 instructions, so its arithmetic is bound by the special-
// function units at 3x the forward's 16-exp bound. Its float32 scratch
// moves more bytes than its inputs and outputs: at the flagship's first
// train launch, (6, 81, 72, 1024), 566 MB of chunk states written and
// read back and 573 MB of dB / dC partials written and summed, against
// 0.42 GB of bf16 inputs and outputs. Measured on the H100 (PERF.md),
// the kernel without its scratch traffic takes about two thirds of its
// time: the traffic does not overlap with the arithmetic.
//
// Design (the first K5 ran one channel a thread, loaded B and C as
// 16 scalar global loads a step in each of its three passes, took each
// exp as __expf, waited on memory at every step and summed dB and dC over
// the block with two barriers a step: 9.2 ms at that launch):
// - K1's tile: a thread owns R = 2 channels of one sequence, a block is 4
//   warps x 32 sequences (8 channels), and B and C are staged once per
//   block as float32 [step][lane][20] rows read with 128-bit loads, each
//   staged value serving the thread's R channels. Staging runs a chunk
//   ahead (double buffer, one barrier a chunk); u, dt and g are read a
//   chunk ahead too, and every loaded value stays as loaded until used.
// - Every exp is one ex2.approx: A is pre-scaled by log2(e) in shared
//   memory, and sum_i q[i] A[i] is taken against the scaled A and
//   multiplied by ln 2 once.
// - Sweep 1 runs the forward and keeps h at the start of every kChunk-step
//   chunk (but the first, which is 0) in float32 scratch, laid out per
//   block so each thread's 8 float4 are coalesced 128-bit accesses.
// - Sweep 2 walks the chunks against the scan direction: it recomputes h
//   through the chunk into shared memory (h_t after each step; 64 KB for
//   4 steps of 128 threads x 32 states), then runs the adjoint through
//   it, last step first. The dA and ddt terms take dA_t h_{t-1} as
//   h_t - dt_t u_t B_t, and dC_t = sum_d h_t g_t comes from the same h_t,
//   so the adjoint needs no other state and sweep 1 sums nothing. The
//   next chunk's first state (into h, free during the adjoint), u, dt and
//   g are read while the adjoint runs.
// - Cross-channel sums once per chunk: a thread adds its R channels in
//   registers and leaves 16 dB and 16 dC sums a step in the state slot
//   the adjoint step has just read; after the chunk's barrier each thread
//   adds the 4 warps' sums of one quad of states, in a fixed order, and
//   writes one float4 partial per (block row, t, quad, b).
//   sum_quads_kernel then adds the block rows in a fixed order into dB
//   and dC. dA and dD stay in registers over the whole scan and are
//   summed over the block's lanes with warp shuffles into per-block
//   partials (sum_partials). No atomics: every gradient is the same from
//   run to run.
// - 107 KB of shared memory a block: two blocks (8 warps) per SM, whose
//   255 registers a thread hold h, mu, the dA sums and two chunks of u,
//   dt and g without spills.
// - n < 16 runs the 16-wide loop on zeros (A, B and C staged as 0), as K1.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;                 // sequences per block
constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kR = 2;                      // channels per thread
constexpr int kChannels = kWarps * kR;     // channels per block
constexpr int kMaxN = 16;                  // largest state size compiled in
constexpr int kQuads = kR * kMaxN / 4;     // float4 of a thread's states
constexpr int kRow = 20;                   // floats per staged (step, lane)
constexpr int kChunk = 4;                  // steps per chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kWarps * 4 == kMaxN, "one warp per quad of states");

// dynamic shared memory: the chunk's states [kChunk][kQuads][kThreads]
// float4; staged B and C [2 buffers][2][kChunk][kLanes][kRow]; A of the
// block's channels [kChannels][kMaxN]
constexpr size_t kStateFloats = size_t(kChunk) * kQuads * kThreads * 4;
constexpr size_t kStageFloats = size_t(2) * 2 * kChunk * kLanes * kRow;
constexpr size_t kSmemBytes =
    sizeof(float) * (kStateFloats + kStageFloats + kChannels * kMaxN);

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

struct Work {            // carve of the float32 workspace
  float4* bounds;        // chunks' first states, per block
  float4 *pB, *pC;       // dB, dC partials [ns][block row][L][4][b] float4
  float *pA, *pD;
};

inline int n_chunks(int L) { return (L + kChunk - 1) / kChunk; }
inline size_t lane_blocks(int b) { return (b + kLanes - 1) / kLanes; }
inline size_t channel_blocks(int d) {
  return (d + kChannels - 1) / kChannels;
}

inline size_t bound_floats(int ns, int L, int d, int b) {
  return static_cast<size_t>(ns) * (n_chunks(L) - 1) * channel_blocks(d) *
         lane_blocks(b) * kQuads * kThreads * 4;
}

inline Work carve(float* w, int ns, int L, int d, int n, int b) {
  const size_t plane =          // float4
      static_cast<size_t>(ns) * channel_blocks(d) * L * 4 * b;
  Work out;
  out.bounds = reinterpret_cast<float4*>(w);
  out.pB = reinterpret_cast<float4*>(w + bound_floats(ns, L, d, b));
  out.pC = out.pB + plane;
  out.pA = reinterpret_cast<float*>(out.pC + plane);
  out.pD = out.pA + static_cast<size_t>(ns) * lane_blocks(b) * d * n;
  return out;
}

inline size_t work_floats(int ns, int L, int d, int n, int b) {
  return bound_floats(ns, L, d, b) +
         2 * static_cast<size_t>(ns) * channel_blocks(d) * L * kMaxN * b +
         static_cast<size_t>(ns) * lane_blocks(b) * d * (n + 1);
}

// Second pass of dB and dC: out[s][t][4 q + e][b] is the sum over the
// partial planes p, in order, of part[s][p][t][q][b] component e
// (blockIdx.z 0: dB, 1: dC); one thread per (t, q, b).
template <typename T>
__global__ void sum_quads_kernel(const float4* __restrict__ pB,
                                 const float4* __restrict__ pC,
                                 T* __restrict__ dB, T* __restrict__ dC,
                                 int parts, int L, int n, int b) {
  const long long m = static_cast<long long>(L) * 4 * b;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int q = static_cast<int>((j / b) % 4);
  if (4 * q >= n) return;
  const size_t s = blockIdx.y;
  const float4* src = (blockIdx.z ? pC : pB) + s * parts * m + j;
  float4 acc = src[0];
  for (int p = 1; p < parts; ++p) add4(acc, src[static_cast<size_t>(p) * m]);
  const long long t = j / (4LL * b), bb = j % b;
  T* out = (blockIdx.z ? dC : dB) + ((s * L + t) * n + 4 * q) * b + bb;
  const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int e = 0; e < 4 && 4 * q + e < n; ++e)
    out[static_cast<size_t>(e) * b] = vct::from_f32<T>(v[e]);
}

// kPair: b is even, so B and C are staged two lanes a load (as K1)
template <typename T, bool kPair>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          const float* __restrict__ Dv,
                          const T* __restrict__ g, T* __restrict__ du,
                          T* __restrict__ ddt, Work w, int L, int d, int n,
                          int b, int reverse) {
  using P = typename vct::PairOf<T>::type;
  extern __shared__ __align__(16) float smem[];
  float4* const sH = reinterpret_cast<float4*>(smem);
  float* const sBC = smem + kStateFloats;
  float* const sA = sBC + kStageFloats;
  constexpr int kStep = kLanes * kRow;       // floats per staged step
  constexpr int kMat = kChunk * kStep;       // floats of B (or C) a buffer
  constexpr int kBuf = 2 * kMat;             // floats per buffer
  constexpr int kSlot = kQuads * kThreads;   // float4 per state slot

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int b0 = blockIdx.x * kLanes;
  const int bi = b0 + lane;
  const int c0 = blockIdx.y * kChannels;     // the block's channels
  const int cr = warp * kR;                  // the thread's, in them
  const size_t s = blockIdx.z;
  const int nch = (L + kChunk - 1) / kChunk;
  const int last = nch - 1;

  const size_t step_d = static_cast<size_t>(d) * b * sizeof(T);
  const size_t step_n = static_cast<size_t>(n) * b * sizeof(T);
  const char* u_s = reinterpret_cast<const char*>(u) + s * L * step_d;
  const char* dt_s = reinterpret_cast<const char*>(dt) + s * L * step_d;
  const char* g_s = reinterpret_cast<const char*>(g) + s * L * step_d;
  char* du_s = reinterpret_cast<char*>(du) + s * L * step_d;
  char* ddt_s = reinterpret_cast<char*>(ddt) + s * L * step_d;
  const size_t plane = static_cast<size_t>(L) * 4 * b;   // float4
  float4* const pB = w.pB + (s * gridDim.y + blockIdx.y) * plane;
  float4* const pC = w.pC + (s * gridDim.y + blockIdx.y) * plane;

  for (int idx = tid; idx < kChannels * kMaxN; idx += kThreads) {
    const int c = idx / kMaxN, i = idx % kMaxN;
    sA[idx] = (c0 + c < d && i < n) ? A[(c0 + c) * n + i] * kLog2e : 0.f;
  }

  // A masked lane or channel loads a valid element and uses it as 0.
  bool ok[kR];
  size_t col[kR];          // byte offset of this thread's channels in a step
  float dv[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int di = c0 + cr + r;
    ok[r] = bi < b && di < d;
    col[r] = (static_cast<size_t>(min(di, d - 1)) * b + min(bi, b - 1)) *
             sizeof(T);
    dv[r] = di < d ? Dv[di] : 0.f;
  }

  // Staging, as K1: thread tid takes B (tid < 64) or C, lanes 2 m and
  // 2 m + 1 (m = tid % 16), entries i0 .. i0 + 3 (i0 = 4 ((tid / 16) % 4));
  // entries past n load entry n - 1 and are staged as 0.
  const int m = tid % 16;
  const int i0 = 4 * ((tid / 16) % 4);
  const bool stages_B = tid < 64;          // warp-uniform
  const char* src_s = reinterpret_cast<const char*>(stages_B ? Bm : Cm) +
                      s * L * step_n;
  unsigned src[4][2];
  bool keep[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = min(i0 + e, n - 1);
    const int l0 = kPair ? min(b0 + 2 * m, b - 2) : min(b0 + 2 * m, b - 1);
    const int l1 = min(b0 + 2 * m + 1, b - 1);
    src[e][0] = static_cast<unsigned>((row * b + l0) * sizeof(T));
    src[e][1] = static_cast<unsigned>((row * b + l1) * sizeof(T));
    keep[e] = i0 + e < n;
  }
  float* const stage = sBC + (stages_B ? 0 : kMat) + 2 * m * kRow + i0;

  auto token = [&](int pos) { return reverse ? L - 1 - pos : pos; };
  // staged values as loaded, two lanes a word (kPair) or one, until they
  // are stored: splitting a bf16 pair right after its load waits there
  struct Held {
    P pair[4];
    T one[4][2];
  };
  auto load_stage = [&](int pos, Held& v) {
    const char* p = src_s + static_cast<size_t>(token(pos)) * step_n;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kPair) {
        v.pair[e] = *reinterpret_cast<const P*>(p + src[e][0]);
      } else {
        v.one[e][0] = *reinterpret_cast<const T*>(p + src[e][0]);
        v.one[e][1] = *reinterpret_cast<const T*>(p + src[e][1]);
      }
    }
  };
  auto store_stage = [&](int buf, int k, const Held& v) {
    float q[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f;
      if constexpr (kPair)
        f = vct::PairOf<T>::unpack(v.pair[e]);
      else
        f = make_float2(vct::to_f32(v.one[e][0]), vct::to_f32(v.one[e][1]));
      q[0][e] = keep[e] ? f.x : 0.f;
      q[1][e] = keep[e] ? f.y : 0.f;
    }
    float* dst = stage + buf * kBuf + k * kStep;
    *reinterpret_cast<float4*>(dst) =
        make_float4(q[0][0], q[0][1], q[0][2], q[0][3]);
    *reinterpret_cast<float4*>(dst + kRow) =
        make_float4(q[1][0], q[1][1], q[1][2], q[1][3]);
  };
  // this thread's values of u, dt or g (`src`) in the chunk starting at
  // `base`, as loaded: they are read a chunk ahead
  auto load_rows = [&](const char* src, int base, T (&x)[kChunk][kR]) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (base + k >= L) break;
      const size_t off = static_cast<size_t>(token(base + k)) * step_d;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        x[k][r] = *reinterpret_cast<const T*>(src + off + col[r]);
    }
  };
  auto used = [&](int r, T x) { return ok[r] ? vct::to_f32(x) : 0.f; };
  // the first state of chunk cc > 0, this thread's 8 float4
  auto bound_of = [&](int cc) {
    return w.bounds +
           (((s * last + (cc - 1)) * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x) * kSlot + tid;
  };
  // One chunk's cross-channel sums. State slot k holds every thread's 16
  // dB sums of step k as quads 0..3 and its 16 dC sums as quads 4..7;
  // thread (warp q, lane l) adds the 4 warps' quads q and 4 + q at lane l,
  // in a fixed order, into the partial planes.
  auto reduce = [&](int p0, int tc) {
    const int i = 4 * warp;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k >= tc) break;
      const float4* p = sH + k * kSlot + warp * kThreads + lane;
      float4 vb = p[0], vc = p[4 * kThreads];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) {
        add4(vb, p[ww * kLanes]);
        add4(vc, p[4 * kThreads + ww * kLanes]);
      }
      if (bi < b && i < n) {
        const size_t o =
            (static_cast<size_t>(token(p0 + k)) * 4 + warp) * b + bi;
        pB[o] = vb;
        pC[o] = vc;
      }
    }
  };

  float h[kR][kMaxN];
  // h = the first state of chunk cc: 0, or this thread's 8 float4 of it
  auto load_bound = [&](int cc) {
    if (cc == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int i = 0; i < kMaxN; ++i) h[r][i] = 0.f;
      return;
    }
    const float4* p = bound_of(cc);
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const float4 x = p[q * kThreads];
      float* y = &h[q / 4][4 * (q % 4)];
      y[0] = x.x;
      y[1] = x.y;
      y[2] = x.z;
      y[3] = x.w;
    }
  };

  // one step of the forward from the staged B row `sb`
  auto advance = [&](const float* sb, const float (&dtv)[kR],
                     const float (&dtu)[kR]) {
#pragma unroll
    for (int q = 0; q < kMaxN / 4; ++q) {
      const float4 b4 = *reinterpret_cast<const float4*>(sb + 4 * q);
      const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(&sA[(cr + r) * kMaxN + 4 * q]);
        const float aq[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[r][4 * q + e] = fmaf(vct::ex2_approx(dtv[r] * aq[e]),
                                 h[r][4 * q + e], dtu[r] * bq[e]);
      }
    }
  };
  // h as this thread's 8 float4 at dst[q * kThreads]
  auto store_h = [&](float4* dst) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const float* x = &h[q / 4][4 * (q % 4)];
      dst[q * kThreads] = make_float4(x[0], x[1], x[2], x[3]);
    }
  };

  // ---- sweep 1: the forward, keeping each chunk's first state ----
  load_bound(0);
  if (stages_B)
    for (int k = 0; k < min(kChunk, L); ++k) {
      Held v;
      load_stage(k, v);
      store_stage(0, k, v);
    }
  T su[kChunk][kR], sdt[kChunk][kR];        // the chunk's u and dt
  load_rows(u_s, 0, su);
  load_rows(dt_s, 0, sdt);
  __syncthreads();

  for (int c = 0, buf = 0; c < nch; ++c, buf ^= 1) {
    const int base = c * kChunk;
    const int tc = min(kChunk, L - base);
    const int tn = max(0, min(kChunk, L - base - kChunk));  // next chunk
    if (c > 0) store_h(bound_of(c));
    T nu[kChunk][kR], ndt[kChunk][kR];     // the next chunk's
    load_rows(u_s, base + kChunk, nu);
    load_rows(dt_s, base + kChunk, ndt);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k >= tc) break;
      const int pos = base + k;
      Held v;
      if (stages_B && k < tn) load_stage(pos + kChunk, v);
      float dtv[kR], dtu[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        dtv[r] = used(r, sdt[k][r]);
        dtu[r] = dtv[r] * used(r, su[k][r]);
      }
      advance(sBC + buf * kBuf + k * kStep + lane * kRow, dtv, dtu);
      if (stages_B && k < tn) store_stage(buf ^ 1, k, v);
    }
    __syncthreads();   // next chunk staged; this chunk's reads done
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        su[k][r] = nu[k][r];
        sdt[k][r] = ndt[k][r];
      }
  }

  // Sweep 2's first chunk (the last in scan order), B and C, into buffer
  // 0: every read of sweep 1's buffers came before its last barrier.
  for (int k = 0; k < L - last * kChunk; ++k) {
    Held v;
    load_stage(last * kChunk + k, v);
    store_stage(0, k, v);
  }
  load_bound(last);
  T uc[kChunk][kR], dtc[kChunk][kR], gc[kChunk][kR];   // the chunk's u, dt, g
  load_rows(u_s, last * kChunk, uc);
  load_rows(dt_s, last * kChunk, dtc);
  load_rows(g_s, last * kChunk, gc);
  __syncthreads();

  // ---- sweep 2: chunks against the scan direction ----
  float mu[kR][kMaxN], gA[kR][kMaxN], gD[kR];   // mu = dA_{t+1} lam_{t+1}
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    gD[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) mu[r][i] = gA[r][i] = 0.f;
  }
  for (int c = last, buf = 0; c >= 0; --c, buf ^= 1) {
    const int base = c * kChunk;
    const int tc = min(kChunk, L - base);
    // the previous chunk's sums, left in its state slots
    if (c < last) reduce(base + kChunk, min(kChunk, L - base - kChunk));
    __syncthreads();

    const float* sb0 = sBC + buf * kBuf + lane * kRow;
    // recompute: slot k holds h after step k
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k >= tc) break;
      float dtv[kR], dtu[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        dtv[r] = used(r, dtc[k][r]);
        dtu[r] = dtv[r] * used(r, uc[k][r]);
      }
      advance(sb0 + k * kStep, dtv, dtu);
      store_h(sH + k * kSlot + tid);
    }
    // h is free until the next chunk: its first state, u, dt and g are
    // read during the adjoint
    T nu[kChunk][kR], ndt[kChunk][kR], ng[kChunk][kR];   // next chunk's
    if (c > 0) {
      load_bound(c - 1);
      load_rows(u_s, base - kChunk, nu);
      load_rows(dt_s, base - kChunk, ndt);
      load_rows(g_s, base - kChunk, ng);
    }

    // adjoint through the chunk, last step first, staging the next chunk
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      if (k >= tc) continue;
      Held v;
      if (c > 0) load_stage(base - kChunk + k, v);
      float uv[kR], dtv[kR], gv[kR], dtu[kR], S[kR], Tt[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        uv[r] = used(r, uc[k][r]);
        dtv[r] = used(r, dtc[k][r]);
        gv[r] = used(r, gc[k][r]);
        dtu[r] = dtv[r] * uv[r];
        S[r] = Tt[r] = 0.f;
      }
      // slot k: h_t of state quad q of channel r at quad 4 r + q; each
      // pair of quads, once read, takes the step's dB and dC sums
      float4* hs = sH + k * kSlot + tid;
      const float* sb = sb0 + k * kStep;
      const float* sc = sb + kMat;
#pragma unroll
      for (int q = 0; q < kMaxN / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(sb + 4 * q);
        const float4 c4 = *reinterpret_cast<const float4*>(sc + 4 * q);
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
        float aq[kR][4], ht[kR][4], db[4], dc[4];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&sA[(cr + r) * kMaxN + 4 * q]);
          aq[r][0] = a4.x;
          aq[r][1] = a4.y;
          aq[r][2] = a4.z;
          aq[r][3] = a4.w;
          const float4 h4 = hs[(4 * r + q) * kThreads];
          ht[r][0] = h4.x;
          ht[r][1] = h4.y;
          ht[r][2] = h4.z;
          ht[r][3] = h4.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          db[e] = dc[e] = 0.f;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float lam = fmaf(cq[e], gv[r], mu[r][i]);
            S[r] = fmaf(lam, bq[e], S[r]);
            // lam h_{t-1} dA_t, with dA_t h_{t-1} = h_t - dt_t u_t B_t
            const float qv = lam * fmaf(-dtu[r], bq[e], ht[r][e]);
            mu[r][i] = lam * vct::ex2_approx(dtv[r] * aq[r][e]);
            Tt[r] = fmaf(qv, aq[r][e], Tt[r]);
            gA[r][i] = fmaf(qv, dtv[r], gA[r][i]);
            db[e] = fmaf(lam, dtu[r], db[e]);
            dc[e] = fmaf(ht[r][e], gv[r], dc[e]);
          }
        }
        hs[q * kThreads] = make_float4(db[0], db[1], db[2], db[3]);
        hs[(4 + q) * kThreads] = make_float4(dc[0], dc[1], dc[2], dc[3]);
      }
      const size_t off = static_cast<size_t>(token(base + k)) * step_d;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        gD[r] = fmaf(gv[r], uv[r], gD[r]);
        if (ok[r]) {
          *reinterpret_cast<T*>(ddt_s + off + col[r]) =
              vct::from_f32<T>(fmaf(uv[r], S[r], Tt[r] * kLn2));
          *reinterpret_cast<T*>(du_s + off + col[r]) =
              vct::from_f32<T>(fmaf(dtv[r], S[r], dv[r] * gv[r]));
        }
      }
      if (c > 0) store_stage(buf ^ 1, k, v);
    }
    // a ragged chunk (the last, first here) stages the rest of the next
    if (c > 0)
      for (int k = tc; k < kChunk; ++k) {
        Held v;
        load_stage(base - kChunk + k, v);
        store_stage(buf ^ 1, k, v);
      }
    __syncthreads();   // next chunk staged; this chunk's sums complete
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        uc[k][r] = nu[k][r];
        dtc[k][r] = ndt[k][r];
        gc[k][r] = ng[k][r];
      }
  }
  reduce(0, min(kChunk, L));

  // dA, dD: sum over the block's 32 lanes
  const size_t blk = s * gridDim.x + blockIdx.x;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int di = c0 + cr + r;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) {
      const float v = vct::warp_sum(gA[r][i]);
      if (lane == 0 && di < d && i < n) w.pA[(blk * d + di) * n + i] = v;
    }
    const float vd = vct::warp_sum(gD[r]);
    if (lane == 0 && di < d) w.pD[blk * d + di] = vd;
  }
}

template <typename T>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, const void* g, void* du, void* ddt,
           void* dB, void* dC, float* dA, float* dD, float* work, int ns,
           int L, int d, int n, int b, int reverse, cudaStream_t stream) {
  const auto kernel = b % 2 == 0 ? selective_scan_bwd_kernel<T, true>
                                 : selective_scan_bwd_kernel<T, false>;
  cudaError_t err = vct::allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Work w = carve(work, ns, L, d, n, b);
  dim3 block(kLanes, kWarps);
  dim3 grid(lane_blocks(b), channel_blocks(d), ns);
  kernel<<<grid, block, kSmemBytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<const T*>(g), static_cast<T*>(du), static_cast<T*>(ddt), w,
      L, d, n, b, reverse);
  const long long m = static_cast<long long>(L) * 4 * b;
  sum_quads_kernel<T><<<dim3(static_cast<unsigned>((m + 255) / 256), ns, 2),
                        256, 0, stream>>>(w.pB, w.pC, static_cast<T*>(dB),
                                          static_cast<T*>(dC), grid.y, L, n,
                                          b);
  vct::sum_partials<float>(w.pA, dA, 1, ns * grid.x,
                           static_cast<long long>(d) * n, stream);
  vct::sum_partials<float>(w.pD, dD, 1, ns * grid.x, d, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 elements of the workspace vct_selective_scan_bwd needs
extern "C" long long vct_selective_scan_bwd_workspace(int ns, int L, int d,
                                                      int n, int b) {
  return static_cast<long long>(work_floats(ns, L, d, n, b));
}

extern "C" int vct_selective_scan_bwd(int dtype, const void* u, const void* dt,
                                      const float* A, const void* B,
                                      const void* C, const float* D,
                                      const void* g, void* du, void* ddt,
                                      void* dB, void* dC, float* dA, float* dD,
                                      float* work, int ns, int L, int d, int n,
                                      int b, int reverse, void* stream) {
  if (n < 1 || n > kMaxN || ns > 65535 || channel_blocks(d) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns == 0 || L == 0 || d == 0 || b == 0) {   // nothing to sum: zeros
    cudaMemsetAsync(dA, 0, sizeof(float) * d * n, st);
    cudaMemsetAsync(dD, 0, sizeof(float) * d, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == vct::kF32)
    return launch<float>(u, dt, A, B, C, D, g, du, ddt, dB, dC, dA, dD, work,
                         ns, L, d, n, b, reverse, st);
  if (dtype == vct::kBF16)
    return launch<__nv_bfloat16>(u, dt, A, B, C, D, g, du, ddt, dB, dC, dA,
                                 dD, work, ns, L, d, n, b, reverse, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
