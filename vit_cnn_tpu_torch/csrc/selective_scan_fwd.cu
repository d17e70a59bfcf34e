// K1: selective-scan forward (Mamba-1 recurrence), lane-major layout,
// and V1, the grid of K1's own design.
//
// K1 replaces the Pallas TPU kernel vit_cnn_tpu/ops/selective_scan.py
// `_scan_kernel` (launched by `_pallas_forward`). V1 replaces the tuning
// probe perf/scan_sweep.py `_kernel_lanemajor` (launched by
// `scan_lanemajor_pre`), which swept that TPU kernel's tile and time
// chunk. Both compute, per stream s, channel d and sequence b:
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = C_t . h_t + D[d] * u_t
// over t = 0..L-1, or L-1..0 when `reverse` is set, with the n-wide state
// in float32 registers (a bf16 state diverges over L steps).
//
// Layout: u, dt, y are (ns, L, d, b); B, C are (ns, L, n, b); A is (d, n)
// and D is (d,), both float32. b is the innermost axis, so a warp's 32
// lanes are 32 neighbouring sequences and every global load and store is
// coalesced.
//
// What bounds it on the H100: each (t, d, b) element costs n = 16 exps on
// the special-function units (16 per clock per SM) and 4n FP32
// instructions; its ~7 bytes of traffic in bf16 take about half as long
// as the exps. So the kernel is bound by the exp rate.
//
// One kernel template, `selective_scan_fwd_kernel<T, R, kSteps, kPair>`:
// R channels a thread by kSteps time steps a staging buffer. K1 is its
// instance (R = `plan(...)`, kSteps = kChunk); V1
// (`vct_selective_scan_tiled`) is its grid, 4 warps x R in {1, 2, 4}
// channels a block by kSteps in {2, 4, 8}, so a sweep of V1 is a sweep of
// K1's own design space and its instance at K1's plan is K1 itself. (V1 was
// first the first K1's kernel, templated over channels a block x staged
// steps; that design's times are in PERF.md, Findings.)
//
// Design (the first K1 read B_t and C_t from shared memory once per
// channel, as 32 scalar loads per step, took each exp with the precise
// expf, and waited on device memory at every chunk):
// - A thread owns R channels (R = 1, 2 or 4) of one sequence. Every B_t[i]
//   and C_t[i] it reads from shared memory serves its R channels, so the
//   shared-memory traffic per channel-step falls R-fold.
// - B and C are staged as float32 in [step][lane][20] rows: a thread's n
//   values are contiguous, so one step's B is four conflict-free 128-bit
//   loads (a row of 20 floats puts the 8 lanes of a quarter-warp on 8
//   distinct 4-bank groups).
// - Each exp is one ex2.approx in both dtypes (float32 stays within its
//   tolerance of the plain scan): one FMUL and one MUFU op. A is
//   pre-scaled by log2(e) once per block and read from shared memory as
//   broadcasts (every lane of a warp reads the same channel's A): held in
//   registers it took R x 16 of them, 250 at R = 4, and the resident warps
//   fell to 8 per SM.
// - Loads overlap compute. B and C are double-buffered by chunks of
//   kSteps steps: at step k of chunk c every thread loads its share of
//   step k of chunk c + 1 into registers before computing, and stores it
//   (converted and transposed) after, so one barrier per chunk swaps the
//   buffers and none waits on device memory. u and dt of step t + 1 are
//   loaded while step t computes. Loaded values stay raw until used:
//   converting a bf16 value right after its load waits for the load there.
// - Staging costs few instructions: a block is 4 warps whatever R is, so
//   each thread stages 8 values a step, two lanes of four state entries,
//   as four 4-byte (bf16) or 8-byte (float32) loads where b is even
//   (kPair) and two 128-bit shared stores. Its byte offsets are computed
//   once, and a masked lane, channel or state entry loads a valid element
//   (staged as 0 where the state entry is past n, and never stored), so no
//   load takes a branch.
// - The buffers take 2 x 2 x kSteps x 32 x 20 floats: static shared memory
//   up to kSteps = kStaticSteps (41,984 B with A at K1's 4 steps), dynamic
//   shared memory above it (81,920 B at 8 steps, its cap raised per
//   instance), so K1's instance keeps the static layout it always had.
// - K1's tile is 32 sequences by 4 warps x R channels. R is chosen on the
//   host by the same formula as ops/selective_scan.py `scan_tile` (`plan`
//   below). bf16 takes R = 2: at R = 4 the state takes 160 registers, and
//   the loads are not what holds it back. float32 moves twice the bytes,
//   and every block of channels re-reads its sequences' B and C, so it
//   takes R = 4 (half the re-reads) where the launch still has two waves
//   of warps for the card.
// - n < 16 runs the 16-wide loop on zeros: A, B and C are 0 there, so
//   those state entries stay 0 and add nothing.
//
// What V1's grid shows on an H100 (NVIDIA H100 80GB HBM3, 700 W;
// tools/scan_sweep.py at the flagship's serving shapes and the probes'
// batch): K1's own instance is the fastest at 9 of the 12 cases and
// within 5% of the fastest at the others, in both dtypes. 8 steps a buffer
// (dynamic shared memory: two blocks an SM) take 1.15-2x its time, R = 1
// at least 1.3x, and 2 steps about as long as 4. So K1's next gain is
// fewer instructions a step, not another tile; the exp bound is ~1.0 ms of
// its ~2.2 ms at serving stage 1.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;       // sequences per block (one warp wide)
constexpr int kRows = 4;         // warps per block
constexpr int kThreads = kLanes * kRows;
constexpr int kMaxN = 16;        // largest state size compiled in
constexpr int kRow = 20;         // floats per staged (step, lane) row
constexpr int kChunk = 4;        // K1's steps per staging buffer
constexpr int kStaticSteps = 4;  // most steps staged in static shared memory
constexpr int kMaxChannels = kRows * 4;   // per block, at R = 4
constexpr float kLog2e = 1.4426950408889634f;
// float32 takes R = 4 where the launch has at least kFillWarps warps (two
// waves of 16 warps on each of the 132 SMs); bf16 takes R = 2
constexpr long long kFillWarps = 2LL * 132 * 16;

// R of a launch, as ops/selective_scan.py `scan_tile` computes it.
int plan(int dtype, int ns, int d, int b) {
  const long long lane_blocks = (b + kLanes - 1) / kLanes;
  const int blocks4 = (d + 4 * kRows - 1) / (4 * kRows);
  const bool fills = static_cast<long long>(ns) * blocks4 * kRows *
                         lane_blocks >= kFillWarps;
  return dtype == vct::kF32 && fills ? 4 : 2;
}

// bytes of the B and C buffers of kSteps steps
constexpr size_t staging_bytes(int steps) {
  return sizeof(float) * 2 * 2 * steps * kLanes * kRow;
}

// kSteps: steps a staging buffer. kPair: b is even, so the block stages B
// and C two lanes at a time (one 4-byte bf16 or 8-byte float32 load);
// otherwise one lane at a time
template <typename T, int R, int kSteps, bool kPair>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          const float* __restrict__ Dv, T* __restrict__ y,
                          int L, int d, int n, int b, int reverse) {
  using P = typename vct::PairOf<T>::type;
  // staged B (sBC[0]) and C (sBC[1]): two buffers of kSteps steps of
  // [lane][kRow] float32 rows; A of the block's channels, pre-scaled. The
  // static array is declared here in every instance (one 16-byte row where
  // the buffers are dynamic): declared inside a branch, K1 compiled to
  // other SASS.
  constexpr bool kStatic = kSteps <= kStaticSteps;
  __shared__ __align__(16) float sBC_static[kStatic ? 2 : 1][kStatic ? 2 : 1]
                                           [kStatic ? kSteps : 1]
                                           [kStatic ? kLanes : 1]
                                           [kStatic ? kRow : 4];
  __shared__ __align__(16) float sA[kMaxChannels][kMaxN];
  extern __shared__ __align__(16) float sBC_dynamic[];
  float(*sBC)[2][kSteps][kLanes][kRow] =
      reinterpret_cast<float(*)[2][kSteps][kLanes][kRow]>(
          kStatic ? &sBC_static[0][0][0][0][0] : sBC_dynamic);
  constexpr int kBuf = kSteps * kLanes * kRow;      // floats per buffer
  constexpr int kStep = kLanes * kRow;              // floats per step

  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kLanes + lane;
  const int b0 = blockIdx.x * kLanes;
  const int bi = b0 + lane;
  const int c0 = blockIdx.y * kRows * R;            // the block's channels
  const int cr = threadIdx.y * R;                   // the thread's, in them
  const size_t s = blockIdx.z;

  // bytes of one step of u and of B; every address below is a 64-bit
  // base plus a byte offset fixed per thread
  const size_t step_d = static_cast<size_t>(d) * b * sizeof(T);
  const size_t step_n = static_cast<size_t>(n) * b * sizeof(T);
  const char* u_s = reinterpret_cast<const char*>(u) + s * L * step_d;
  const char* dt_s = reinterpret_cast<const char*>(dt) + s * L * step_d;
  char* y_s = reinterpret_cast<char*>(y) + s * L * step_d;

  for (int idx = tid; idx < kMaxChannels * kMaxN; idx += kThreads) {
    const int c = idx / kMaxN, i = idx % kMaxN;
    sA[c][i] = (c < kRows * R && c0 + c < d && i < n)
                   ? A[(c0 + c) * n + i] * kLog2e
                   : 0.f;
  }

  // A masked lane, channel or state entry loads a valid element (any
  // finite value) and is never stored, or staged as 0, so no load needs a
  // branch.
  bool ok[R];
  size_t col[R];            // byte offset of this thread's channels in a step
  float h[R][kMaxN], dv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int di = c0 + cr + r;
    ok[r] = bi < b && di < d;
    col[r] = (static_cast<size_t>(min(di, d - 1)) * b + min(bi, b - 1)) *
             sizeof(T);
    dv[r] = di < d ? Dv[di] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) h[r][i] = 0.f;
  }

  // Each step the block stages 2 x 16 x 32 values: thread tid takes B
  // (tid < 64) or C, lanes 2 m and 2 m + 1 (m = tid % 16), entries
  // i0 .. i0 + 3 (i0 = 4 ((tid / 16) % 4)); entries past n load entry
  // n - 1 and are staged as 0.
  const int m = tid % 16;
  const int i0 = 4 * ((tid / 16) % 4);
  const char* src_s = reinterpret_cast<const char*>(tid < 64 ? Bm : Cm) +
                      s * L * step_n;
  unsigned src[4][2];       // byte offsets in one step of B or C
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
  float* const stage = &sBC[tid < 64 ? 0 : 1][0][0][2 * m][i0];

  // token of the pos-th step in scan order
  auto token = [&](int pos) { return reverse ? L - 1 - pos : pos; };
  // Loads keep the raw values: converting right after a load would wait
  // for it there.
  auto load_stage = [&](int pos, T (&v)[4][2]) {
    const char* p = src_s + static_cast<size_t>(token(pos)) * step_n;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kPair) {
        const P w = *reinterpret_cast<const P*>(p + src[e][0]);
        v[e][0] = w.x;
        v[e][1] = w.y;
      } else {
        v[e][0] = *reinterpret_cast<const T*>(p + src[e][0]);
        v[e][1] = *reinterpret_cast<const T*>(p + src[e][1]);
      }
    }
  };
  auto store_stage = [&](int buf, int k, const T (&v)[4][2]) {
    float q[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[0][e] = keep[e] ? vct::to_f32(v[e][0]) : 0.f;
      q[1][e] = keep[e] ? vct::to_f32(v[e][1]) : 0.f;
    }
    float* dst = stage + buf * kBuf + k * kStep;
    *reinterpret_cast<float4*>(dst) =
        make_float4(q[0][0], q[0][1], q[0][2], q[0][3]);
    *reinterpret_cast<float4*>(dst + kRow) =
        make_float4(q[1][0], q[1][1], q[1][2], q[1][3]);
  };
  auto load_ud = [&](int pos, T (&uv)[R], T (&dtv)[R]) {
    const size_t off = static_cast<size_t>(token(pos)) * step_d;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uv[r] = *reinterpret_cast<const T*>(u_s + off + col[r]);
      dtv[r] = *reinterpret_cast<const T*>(dt_s + off + col[r]);
    }
  };

  // chunk 0, staged before the loop
  const int first = min(kSteps, L);
  for (int k = 0; k < first; ++k) {
    T v[4][2];
    load_stage(k, v);
    store_stage(0, k, v);
  }
  T un[R], dtn[R];
  load_ud(0, un, dtn);
  __syncthreads();

  for (int base = 0, buf = 0; base < L; base += kSteps, buf ^= 1) {
    const int tc = min(kSteps, L - base);
    const int tn = max(0, min(kSteps, L - base - kSteps));  // next chunk
    for (int k = 0; k < tc; ++k) {
      const int pos = base + k;
      T v[4][2];
      if (k < tn) load_stage(pos + kSteps, v);
      float uv[R], dtv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uv[r] = vct::to_f32(un[r]);
        dtv[r] = vct::to_f32(dtn[r]);
      }
      if (pos + 1 < L) load_ud(pos + 1, un, dtn);

      float du[R], acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        du[r] = dtv[r] * uv[r];
        acc[r] = 0.f;
      }
      const float* sb = &sBC[0][buf][k][lane][0];
      const float* sc = &sBC[1][buf][k][lane][0];
#pragma unroll
      for (int q = 0; q < kMaxN / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(sb + 4 * q);
        const float4 c4 = *reinterpret_cast<const float4*>(sc + 4 * q);
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
        float aq[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&sA[cr + r][4 * q]);
          aq[r][0] = a4.x;
          aq[r][1] = a4.y;
          aq[r][2] = a4.z;
          aq[r][3] = a4.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float x = dtv[r] * aq[r][e];
            h[r][i] = fmaf(vct::ex2_approx(x), h[r][i], du[r] * bq[e]);
            acc[r] = fmaf(cq[e], h[r][i], acc[r]);
          }
        }
      }
      const size_t off = static_cast<size_t>(token(pos)) * step_d;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (ok[r])
          *reinterpret_cast<T*>(y_s + off + col[r]) =
              vct::from_f32<T>(fmaf(dv[r], uv[r], acc[r]));
      if (k < tn) store_stage(buf ^ 1, k, v);
    }
    __syncthreads();   // next chunk staged; this chunk's reads done
  }
}

template <typename T, int R, int kSteps>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, int ns, int L, int d,
           int n, int b, int reverse, cudaStream_t stream) {
  // instances above kStaticSteps stage in dynamic shared memory
  constexpr size_t smem =
      kSteps <= kStaticSteps ? 0 : staging_bytes(kSteps);
  dim3 block(kLanes, kRows);
  dim3 grid((b + kLanes - 1) / kLanes, (d + kRows * R - 1) / (kRows * R),
            ns);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto kernel) {
    const cudaError_t err = vct::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(dt), A,
        static_cast<const T*>(B), static_cast<const T*>(C), D,
        static_cast<T*>(y), L, d, n, b, reverse);
    return cudaSuccess;
  };
  const cudaError_t err =
      b % 2 == 0 ? args(selective_scan_fwd_kernel<T, R, kSteps, true>)
                 : args(selective_scan_fwd_kernel<T, R, kSteps, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int by_steps(int steps, const void* u, const void* dt, const float* A,
             const void* B, const void* C, const float* D, void* y, int ns,
             int L, int d, int n, int b, int reverse, cudaStream_t stream) {
  if (steps == 2)
    return launch<T, R, 2>(u, dt, A, B, C, D, y, ns, L, d, n, b, reverse,
                           stream);
  if (steps == 4)
    return launch<T, R, 4>(u, dt, A, B, C, D, y, ns, L, d, n, b, reverse,
                           stream);
  if (steps == 8)
    return launch<T, R, 8>(u, dt, A, B, C, D, y, ns, L, d, n, b, reverse,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the (R, steps) instance; R in {1, 2, 4}, steps in {2, 4, 8}
template <typename T>
int by_tile(int R, int steps, const void* u, const void* dt, const float* A,
            const void* B, const void* C, const float* D, void* y, int ns,
            int L, int d, int n, int b, int reverse, cudaStream_t stream) {
  if (R == 1)
    return by_steps<T, 1>(steps, u, dt, A, B, C, D, y, ns, L, d, n, b,
                          reverse, stream);
  if (R == 2)
    return by_steps<T, 2>(steps, u, dt, A, B, C, D, y, ns, L, d, n, b,
                          reverse, stream);
  if (R == 4)
    return by_steps<T, 4>(steps, u, dt, A, B, C, D, y, ns, L, d, n, b,
                          reverse, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int scan(int dtype, int R, int steps, const void* u, const void* dt,
         const float* A, const void* B, const void* C, const float* D,
         void* y, int ns, int L, int d, int n, int b, int reverse,
         void* stream) {
  if (n < 1 || n > kMaxN || ns > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ns == 0 || L == 0 || d == 0 || b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kF32)
    return by_tile<float>(R, steps, u, dt, A, B, C, D, y, ns, L, d, n, b,
                          reverse, st);
  if (dtype == vct::kBF16)
    return by_tile<__nv_bfloat16>(R, steps, u, dt, A, B, C, D, y, ns, L, d,
                                  n, b, reverse, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1: the instance at (plan(...), kChunk)
extern "C" int vct_selective_scan(int dtype, const void* u, const void* dt,
                                  const float* A, const void* B,
                                  const void* C, const float* D, void* y,
                                  int ns, int L, int d, int n, int b,
                                  int reverse, void* stream) {
  return scan(dtype, plan(dtype, ns, d, b), kChunk, u, dt, A, B, C, D, y, ns,
              L, d, n, b, reverse, stream);
}

// K1's channels per thread R for a launch: the card tests hold it equal
// to ops/selective_scan.py `scan_tile`
extern "C" int vct_selective_scan_tile(int dtype, int ns, int L, int d,
                                       int n, int b) {
  (void)L;
  (void)n;
  return plan(dtype, ns, d, b);
}

// V1: the (rows, chunk) instance of the grid, rows = 4 x R channels a block
// in {4, 8, 16} and chunk steps a staging buffer in {2, 4, 8}; anything
// else is cudaErrorInvalidValue. (4 x plan(...), kChunk) is K1.
extern "C" int vct_selective_scan_tiled(int dtype, const void* u,
                                        const void* dt, const float* A,
                                        const void* B, const void* C,
                                        const float* D, void* y, int ns,
                                        int L, int d, int n, int b,
                                        int reverse, int rows, int chunk,
                                        void* stream) {
  if (rows % kRows != 0) return static_cast<int>(cudaErrorInvalidValue);
  return scan(dtype, rows / kRows, chunk, u, dt, A, B, C, D, y, ns, L, d, n,
              b, reverse, stream);
}
