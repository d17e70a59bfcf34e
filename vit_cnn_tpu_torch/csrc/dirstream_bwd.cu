// K6 and K7: the adjoints of the directional-stream pair (K2, K3),
// lane-major layout ((L, d, b) with b innermost).
//
// K6 `dir_conv_silu_bwd` replaces the Pallas TPU kernel
// vit_cnn_tpu/ops/dirstream.py `_dir_conv_adj_kernel` (launched by
// `_dir_conv_adjoint`). For every stream of K2 (the forward stream of each
// base order o, and the reverse stream of the orders in rev_rows) it
// recomputes the preactivation z = cb + sum_j cw[j] * pu[t -/+ (k-1-j)],
// pu = u[order_o], and with the stream's cotangent g takes
//   dz = g * sigmoid(z) * (1 + z * (1 - sigmoid(z)))
//   dcb += sum dz,   dcw[j] += sum_t dz[t] * pu[t -/+ (k-1-j)]
//   dpu[t -/+ (k-1-j)] += cw[j] * dz[t],   du[order_o[p]] += dpu[p]
// so both streams of an order add into one dpu, scattered once per order
// (as the TPU kernel sums dpu over an order's streams and inverse-permutes
// it once).
//
// K7 `inv_perm_weighted_sum_bwd` replaces `_inv_sum_adj_kernel`
// (launched by `_inv_sum_adjoint`). K3 computes
// out[t] = sum_i w_i * y_i[inv_i[t]], so with out's cotangent g:
//   dy_i[inv_i[t]] = w_i * g[t],   dw_i = sum_{t,d,b} g[t] * y_i[inv_i[t]]
// (every row of dy_i is written once: inv_i is a permutation).
//
// What bounds them on the H100: both move data with a few FLOPs per byte.
// K6 reads u and the nb + nr stream cotangents and writes du; K7 reads g
// and the nb + nr streams and writes their cotangents: at the flagship's
// shapes 12 and 21 tensors of L * d * b elements, so the bytes bound both.
//
// Design of K6. The first K6 gave a thread one (d, b) column, staged a
// (L, 4, 32) float32 u tile and du tile (85 KB at L = 81: 8 warps an SM),
// read one 2-byte cotangent a step (~0.5 KB in flight an SM, where the
// card needs ~15-20 KB), took each tap's gathered value through two
// dependent shared loads, and added every tap of every stream into du in
// shared memory (40 read-modify-writes a token at k = 4), with a precise
// expf and an IEEE division. Now:
// - A block is one warp on one channel and 64 sequences, two neighbouring
//   sequences a thread: each gathered value is one 4-byte (bf16) or 8-byte
//   (float32) shared load, and each cotangent row one 128-byte (bf16) warp
//   segment. A lane stages only its own column of u, in u's dtype, and owns
//   its column of the float32 du tile, so nothing is shared across lanes
//   but the order table, and no atomics are needed: 31 KB a warp at L = 81
//   in bf16 (6 blocks an SM), 20 KB at L = 49 (11 an SM).
// - One walk per order serves both of its streams, as in K2: the last K
//   gathered values sit in a register window (K = 4, or 8 for k > 4; the k
//   taps at its end, zero weights before them). A second K-deep window
//   holds dpu: at token t the forward dz[t] adds cw * dz into positions
//   t-K+1..t, the reverse dz[t-K+1] into the same positions in the other
//   order, and position t-K+1 then has all its terms, so it is added into
//   du at row order[t-K+1] once: one shared read-modify-write per order and
//   token (6 a token, not 40). dcw and dcb gather from the same windows in
//   registers. The walk runs K - 1 tokens past the end on zeros, so its
//   body has no branch but the predicated scatter.
// - Cotangents in flight: the walk goes in chunks of kChunk tokens, and
//   each chunk issues the next chunk's cotangent loads (forward and
//   reverse rows of all 64 sequences) before its own arithmetic, kept raw
//   in registers until used: 64 bytes a thread in bf16, ~12 KB an SM in
//   flight at 6 warps; the shared memory holds no cotangent buffer because
//   the u and du tiles fill it.
// - SiLU' with ex2.approx and __fdividef (K2's silu_fast form).
// - dcw and dcb: one float32 partial per (block, tap) and (block), summed
//   across the b-blocks by vct::sum_partials in a fixed order.
// - Instances by taps (K = 4 for k <= 4, the main path; 8 up to k = 8) and
//   by alignment: packed pair loads and stores where b is even and u, the
//   cotangents and du are pair-aligned (the main path), two scalar loads
//   elsewhere (odd b, views at an odd element offset). The stream counts
//   are read at run time: an order's walk is ~L steps, so a loop of nb
//   walks costs nothing to keep general.
//
// Design of K7, K3's flat-plane form applied to its adjoint (the first K7
// gave a thread one (d, b) column, walked the tokens with 2-byte loads and
// read the stream rows and weights inside the loop, on a (b / 32, d / 8)
// grid). The weights are per stream, so each token's (d, b) plane is one
// flat vector of d * b values:
// - grid (plane chunks of 256 threads, token groups); a thread owns 16
//   bytes (8 bf16 or 4 float32 values) of the plane and walks the tokens
//   of its group (t = group, group + groups, ...); a block's threads share
//   each token, so its stream rows inv_i[t] are broadcast loads;
// - per token it loads g once and every stream's row y_i[inv_i[t]] before
//   the first FMA (the main path's 6 + 4 streams fixed at compile time,
//   weights in registers), stores dy_i = w_i * g as 16 bytes, and adds
//   g . y_i into float32 registers; one value a thread where a plane is not
//   16-byte aligned, stream counts read at run time elsewhere;
// - dw: at most kTokenGroups groups (a block walks ceil(L / 32) tokens),
//   so the partials do not depend on L; each block sums its lanes by warp
//   shuffles and its warps in order into one float32 partial per stream,
//   and one block a stream adds the partials in a fixed order
//   (sum_partials_rows_kernel): the same bits from run to run.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kConvLanes = 2 * kLanes;  // sequences per K6 block (a warp)
constexpr int kChunk = 8;               // K6 walk steps fetched together
constexpr int kMaxTaps = 8;
constexpr int kSumThreads = 256;        // threads per K7 block
constexpr int kTokenGroups = 32;        // most token groups of K7's grid
constexpr int kMaxStreams = 16;         // nb + nr that K7 keeps in registers

// d silu(z) / dz = s (1 + z (1 - s)) with s = 1 / (1 + 2^(-z log2 e)):
// two MUFU ops, as K2's silu_fast
__device__ __forceinline__ float dsilu_fast(float z) {
  const float s =
      __fdividef(1.f, 1.f + vct::ex2_approx(-1.4426950408889634f * z));
  return s * fmaf(z, 1.f - s, 1.f);
}

// p[0] and p[1] as one raw pair (zero where not v0 / v1): one 4- or 8-byte
// load where kPair says the pair is aligned and in range, else two
template <typename T, bool kPair>
__device__ __forceinline__ typename vct::PairOf<T>::type load_pair(
    const T* p, bool v0, bool v1) {
  using P = typename vct::PairOf<T>::type;
  P r = vct::PairOf<T>::pack(0.f, 0.f);
  if constexpr (kPair) {
    if (v0) r = *reinterpret_cast<const P*>(p);
  } else {
    if (v0) r.x = p[0];
    if (v1) r.y = p[1];
  }
  return r;
}

template <typename T>
size_t conv_bwd_smem(int L, int nb) {
  using P = typename vct::PairOf<T>::type;
  return (sizeof(float2) + sizeof(P)) * static_cast<size_t>(L) * kLanes +
         sizeof(int) * (static_cast<size_t>(nb) * L + nb);
}

// One warp: channel blockIdx.y, sequences blockIdx.x * 64 + [0, 64), two a
// lane. K: window depth (taps at its end); kPair: b even and every pair
// aligned.
template <typename T, int K, bool kPair>
__global__ void __launch_bounds__(kLanes)
dir_conv_silu_bwd_kernel(const T* __restrict__ u,
                         const float* __restrict__ cw,
                         const float* __restrict__ cb,
                         const int* __restrict__ orders,
                         const int* __restrict__ rev_rows,
                         const T* __restrict__ gf, const T* __restrict__ gr,
                         T* __restrict__ du, float* __restrict__ pcw,
                         float* __restrict__ pcb, int L, int d, int b, int nb,
                         int nr, int k) {
  using P = typename vct::PairOf<T>::type;
  using PO = vct::PairOf<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* sdu = reinterpret_cast<float2*>(smem_raw);     // [L][lanes]
  P* su = reinterpret_cast<P*>(sdu + L * kLanes);         // [L][lanes]
  int* sord = reinterpret_cast<int*>(su + L * kLanes);    // [nb][L]
  int* sslot = sord + nb * L;     // [nb]: each order's reverse stream or -1

  const int lane = threadIdx.x;
  const int di = blockIdx.y;
  const int bi = blockIdx.x * kConvLanes + 2 * lane;
  const bool v0 = bi < b;
  const bool v1 = bi + 1 < b;
  const size_t seq = static_cast<size_t>(d) * b;
  const size_t col = static_cast<size_t>(di) * b + bi;

  for (int idx = lane; idx < nb * L; idx += kLanes) sord[idx] = orders[idx];
  for (int o = lane; o < nb; o += kLanes) {
    int slot = -1;
    for (int j = 0; j < nr; ++j)
      if (rev_rows[j] == o) slot = j;
    sslot[o] = slot;
  }
  P* mine = su + lane;            // this lane's column, stride kLanes
  float2* my_du = sdu + lane;
#pragma unroll 8
  for (int t = 0; t < L; ++t) {
    mine[t * kLanes] = load_pair<T, kPair>(u + t * seq + col, v0, v1);
    my_du[t * kLanes] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  // tap j of the window weighs the value K - 1 - j tokens back
  float w[K], acc_w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    w[j] = j >= K - k ? cw[(j - (K - k)) * d + di] : 0.f;
    acc_w[j] = 0.f;
  }
  const float bias = cb[di];
  float acc_b = 0.f;

  // One walk over an order's tokens: at token t the window holds
  // pu[t-K+1 .. t] and dwin the partial dpu of the same positions. Forward
  // output t and (kRev) reverse output t - K + 1 push their taps into dwin;
  // then position t - K + 1 is complete and goes to du.
  auto walk = [&](const int* ord, const T* pf, const T* pr, auto rev_on) {
    constexpr bool kRev = decltype(rev_on)::value;
    float2 win[K], dwin[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      win[j] = make_float2(0.f, 0.f);
      dwin[j] = make_float2(0.f, 0.f);
    }
    P nf[kChunk], nrv[kChunk];
    // cotangent rows of steps t0 .. t0 + kChunk - 1 (zero outside [0, L))
    auto fetch = [&](int t0) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = t0 + c;
        const bool in = t < L;
        nf[c] = load_pair<T, kPair>(pf + static_cast<size_t>(t) * seq,
                                    v0 && in, v1 && in);
        if constexpr (kRev) {
          const int s = t - (K - 1);
          const bool rin = s >= 0 && s < L;
          nrv[c] = load_pair<T, kPair>(
              pr + static_cast<long long>(s) * static_cast<long long>(seq),
              v0 && rin, v1 && rin);
        }
      }
    };
    fetch(0);
    const int steps = L + K - 1;
#pragma unroll 1
    for (int t0 = 0; t0 < steps; t0 += kChunk) {
      P cf[kChunk], cr[kChunk], ug[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        cf[c] = nf[c];
        if constexpr (kRev) cr[c] = nrv[c];
      }
      fetch(t0 + kChunk);         // in flight during this chunk
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = t0 + c;
        const P got = mine[ord[min(t, L - 1)] * kLanes];
        ug[c] = t < L ? got : PO::pack(0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
        win[K - 1] = PO::unpack(ug[c]);
        float zx = bias, zy = bias;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          zx = fmaf(w[j], win[j].x, zx);
          zy = fmaf(w[j], win[j].y, zy);
        }
        const float2 g = PO::unpack(cf[c]);
        const float dx = g.x * dsilu_fast(zx), dy = g.y * dsilu_fast(zy);
        acc_b += dx + dy;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          acc_w[j] = fmaf(dx, win[j].x, fmaf(dy, win[j].y, acc_w[j]));
          dwin[j].x = fmaf(w[j], dx, dwin[j].x);
          dwin[j].y = fmaf(w[j], dy, dwin[j].y);
        }
        if constexpr (kRev) {
          float rx = bias, ry = bias;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            rx = fmaf(w[j], win[K - 1 - j].x, rx);
            ry = fmaf(w[j], win[K - 1 - j].y, ry);
          }
          const float2 h = PO::unpack(cr[c]);
          const float ex = h.x * dsilu_fast(rx), ey = h.y * dsilu_fast(ry);
          acc_b += ex + ey;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float2 x = win[K - 1 - j];
            acc_w[j] = fmaf(ex, x.x, fmaf(ey, x.y, acc_w[j]));
            dwin[K - 1 - j].x = fmaf(w[j], ex, dwin[K - 1 - j].x);
            dwin[K - 1 - j].y = fmaf(w[j], ey, dwin[K - 1 - j].y);
          }
        }
        const int p = t0 + c - (K - 1);
        if (p >= 0 && p < L) {
          float2* at = my_du + ord[p] * kLanes;
          const float2 cur = *at;
          *at = make_float2(cur.x + dwin[0].x, cur.y + dwin[0].y);
        }
#pragma unroll
        for (int j = 0; j < K - 1; ++j) dwin[j] = dwin[j + 1];
        dwin[K - 1] = make_float2(0.f, 0.f);
      }
    }
  };
  for (int o = 0; o < nb; ++o) {
    const int slot = sslot[o];
    const T* pf = gf + static_cast<size_t>(o) * L * seq + col;
    if (slot >= 0)
      walk(sord + o * L, pf, gr + static_cast<size_t>(slot) * L * seq + col,
           std::true_type{});
    else
      walk(sord + o * L, pf, pf, std::false_type{});
  }
  if (v0) {
    T* out = du + col;
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const float2 x = my_du[t * kLanes];
      vct::store_pair<T, kPair>(out + t * seq, x.x, x.y, v1);
    }
  }

  // dcw, dcb: one partial per (b-block, tap, channel) and (b-block, channel)
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float v = vct::warp_sum(acc_w[j]);
    if (lane == 0 && j >= K - k)
      pcw[(static_cast<size_t>(blockIdx.x) * k + (j - (K - k))) * d + di] = v;
  }
  const float vb = vct::warp_sum(acc_b);
  if (lane == 0) pcb[static_cast<size_t>(blockIdx.x) * d + di] = vb;
}

// One thread: kVec neighbouring values of the (d, b) plane, for the tokens
// blockIdx.y, blockIdx.y + gridDim.y, ... NB, NR: stream counts fixed at
// compile time, or -1 to read nb, nr. pw: [stream][block] partials of dw.
template <typename T, int kVec, int NB, int NR>
__global__ void __launch_bounds__(kSumThreads)
inv_perm_weighted_sum_bwd_kernel(const T* __restrict__ g,
                                 const T* __restrict__ yf,
                                 const T* __restrict__ yr,
                                 const float* __restrict__ wf,
                                 const float* __restrict__ wr,
                                 const int* __restrict__ inv,
                                 const int* __restrict__ rev_rows,
                                 T* __restrict__ dyf, T* __restrict__ dyr,
                                 float* __restrict__ pw, int L, long long n,
                                 int nb, int nr) {
  using IO = vct::VecIO<T, kVec>;
  constexpr int kS = NB >= 0 ? NB + NR : kMaxStreams;
  constexpr int kWarps = kSumThreads / kLanes;
  __shared__ float sred[kWarps][kS];
  if constexpr (NB >= 0) {
    nb = NB;
    nr = NR;
  }
  const int ns = nb + nr;
  const long long e =
      (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) * kVec;
  const size_t stream = static_cast<size_t>(L) * n;

  float w[kS], acc[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    w[i] = i < nb ? wf[i] : (i < ns ? wr[i - nb] : 0.f);
    acc[i] = 0.f;
  }
  if (e < n) {
    for (int t = blockIdx.y; t < L; t += gridDim.y) {
      // every load of the token before the first FMA
      const typename IO::Raw graw = IO::load(g + t * n + e);
      typename IO::Raw raw[kS];
      size_t at[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (i < ns) {
          const bool rv = i >= nb;
          const int j = rv ? i - nb : i;
          const int row = inv[(rv ? rev_rows[j] : i) * L + t];
          at[i] = j * stream + static_cast<size_t>(row) * n + e;
          raw[i] = IO::load((rv ? yr : yf) + at[i]);
        }
      }
      float gv[kVec];
      IO::unpack(graw, gv);
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (i < ns) {
          float x[kVec], dy[kVec];
          IO::unpack(raw[i], x);
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            acc[i] = fmaf(gv[c], x[c], acc[i]);
            dy[c] = w[i] * gv[c];
          }
          IO::store((i >= nb ? dyr : dyf) + at[i], dy);
        }
      }
    }
  }
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const float v = vct::warp_sum(acc[i]);
    if (lane == 0) sred[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < ns) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) tot += sred[r][threadIdx.x];
    const size_t blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
    pw[threadIdx.x * blocks + static_cast<size_t>(blockIdx.y) * gridDim.x +
       blockIdx.x] = tot;
  }
}

// out[i] = sum_p part[i][p]: one block per row i; each thread adds a fixed
// strided share in order, then warp shuffles and the warps in order, so
// the result does not depend on the order in which blocks ran
__global__ void __launch_bounds__(kSumThreads)
sum_partials_rows_kernel(const float* __restrict__ part,
                         float* __restrict__ out, long long parts) {
  constexpr int kWarps = kSumThreads / kLanes;
  __shared__ float s[kWarps];
  const float* src = part + static_cast<size_t>(blockIdx.x) * parts;
  float acc = 0.f;
  for (long long p = threadIdx.x; p < parts; p += kSumThreads) acc += src[p];
  acc = vct::warp_sum(acc);
  if (threadIdx.x % kLanes == 0) s[threadIdx.x / kLanes] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) tot += s[r];
    out[blockIdx.x] = tot;
  }
}

template <typename T, int K, bool kPair>
int launch_conv_bwd(const void* u, const float* cw, const float* cb,
                    const int* orders, const int* rev_rows, const void* gf,
                    const void* gr, void* du, float* dcw, float* dcb,
                    float* work, int L, int d, int b, int nb, int nr, int k,
                    cudaStream_t stream) {
  const auto kernel = dir_conv_silu_bwd_kernel<T, K, kPair>;
  const size_t smem = conv_bwd_smem<T>(L, nb);
  cudaError_t err = vct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((b + kConvLanes - 1) / kConvLanes, d);
  float* pcw = work;
  float* pcb = work + static_cast<size_t>(grid.x) * k * d;
  kernel<<<grid, kLanes, smem, stream>>>(
      static_cast<const T*>(u), cw, cb, orders, rev_rows,
      static_cast<const T*>(gf), static_cast<const T*>(gr),
      static_cast<T*>(du), pcw, pcb, L, d, b, nb, nr, k);
  vct::sum_partials<float>(pcw, dcw, 1, grid.x, static_cast<long long>(k) * d,
                           stream);
  vct::sum_partials<float>(pcb, dcb, 1, grid.x, d, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool pair_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) %
             sizeof(typename vct::PairOf<T>::type) == 0;
}

// the pair instance where b is even and every pointer pair-aligned; K = 4
// for up to 4 taps (the main path), 8 beyond
template <typename T>
int by_taps(const void* u, const float* cw, const float* cb,
            const int* orders, const int* rev_rows, const void* gf,
            const void* gr, void* du, float* dcw, float* dcb, float* work,
            int L, int d, int b, int nb, int nr, int k, cudaStream_t stream) {
  const bool pair = b % 2 == 0 && pair_aligned<T>(u) && pair_aligned<T>(gf) &&
                    (nr == 0 || pair_aligned<T>(gr)) && pair_aligned<T>(du);
  if (k <= 4 && pair)
    return launch_conv_bwd<T, 4, true>(u, cw, cb, orders, rev_rows, gf, gr,
                                       du, dcw, dcb, work, L, d, b, nb, nr, k,
                                       stream);
  if (k <= 4)
    return launch_conv_bwd<T, 4, false>(u, cw, cb, orders, rev_rows, gf, gr,
                                        du, dcw, dcb, work, L, d, b, nb, nr,
                                        k, stream);
  if (pair)
    return launch_conv_bwd<T, kMaxTaps, true>(u, cw, cb, orders, rev_rows,
                                              gf, gr, du, dcw, dcb, work, L,
                                              d, b, nb, nr, k, stream);
  return launch_conv_bwd<T, kMaxTaps, false>(u, cw, cb, orders, rev_rows, gf,
                                             gr, du, dcw, dcb, work, L, d, b,
                                             nb, nr, k, stream);
}

// K7's plane chunks: the most any instance launches (one value a thread)
long long sum_bwd_chunks(long long n, int vec) {
  return (n / vec + kSumThreads - 1) / kSumThreads;
}

template <typename T, int kVec, int NB, int NR>
int launch_sum_bwd(const void* g, const void* yf, const void* yr,
                   const float* wf, const float* wr, const int* inv,
                   const int* rev_rows, void* dyf, void* dyr, float* dw,
                   float* work, int L, long long n, int nb, int nr,
                   cudaStream_t stream) {
  const int per = (L + kTokenGroups - 1) / kTokenGroups;
  const int groups = (L + per - 1) / per;
  dim3 grid(static_cast<unsigned>(sum_bwd_chunks(n, kVec)), groups);
  inv_perm_weighted_sum_bwd_kernel<T, kVec, NB, NR>
      <<<grid, kSumThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(yf),
          static_cast<const T*>(yr), wf, wr, inv, rev_rows,
          static_cast<T*>(dyf), static_cast<T*>(dyr), work, L, n, nb, nr);
  sum_partials_rows_kernel<<<nb + nr, kSumThreads, 0, stream>>>(
      work, dw, static_cast<long long>(grid.x) * grid.y);
  return static_cast<int>(cudaGetLastError());
}

// the 16-byte instance where every plane starts 16-byte aligned, the
// compile-time instance for the main path's 6 + 4 streams
template <typename T>
int by_width(const void* g, const void* yf, const void* yr, const float* wf,
             const float* wr, const int* inv, const int* rev_rows, void* dyf,
             void* dyr, float* dw, float* work, int L, long long n, int nb,
             int nr, cudaStream_t stream) {
  constexpr int kV = vct::Vec16<T>::kN;
  const bool wide = n % kV == 0 && vct::aligned16(g) && vct::aligned16(yf) &&
                    vct::aligned16(dyf) &&
                    (nr == 0 || (vct::aligned16(yr) && vct::aligned16(dyr)));
  const bool main = nb == 6 && nr == 4;
  if (wide && main)
    return launch_sum_bwd<T, kV, 6, 4>(g, yf, yr, wf, wr, inv, rev_rows, dyf,
                                       dyr, dw, work, L, n, nb, nr, stream);
  if (wide)
    return launch_sum_bwd<T, kV, -1, -1>(g, yf, yr, wf, wr, inv, rev_rows,
                                         dyf, dyr, dw, work, L, n, nb, nr,
                                         stream);
  if (main)
    return launch_sum_bwd<T, 1, 6, 4>(g, yf, yr, wf, wr, inv, rev_rows, dyf,
                                      dyr, dw, work, L, n, nb, nr, stream);
  return launch_sum_bwd<T, 1, -1, -1>(g, yf, yr, wf, wr, inv, rev_rows, dyf,
                                      dyr, dw, work, L, n, nb, nr, stream);
}

}  // namespace

// float32 elements of the workspace vct_dir_conv_silu_bwd needs
extern "C" long long vct_dir_conv_silu_bwd_workspace(int d, int b, int k) {
  const long long bx = (b + kConvLanes - 1) / kConvLanes;
  return bx * (static_cast<long long>(k) + 1) * d;
}

extern "C" int vct_dir_conv_silu_bwd(int dtype, const void* u, const float* cw,
                                     const float* cb, const int* orders,
                                     const int* rev_rows, const void* gf,
                                     const void* gr, void* du, float* dcw,
                                     float* dcb, float* work, int L, int d,
                                     int b, int nb, int nr, int k,
                                     void* stream) {
  if (k < 1 || k > kMaxTaps || nb < 1 || nr < 0 || nr > nb || d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 0 || d == 0 || b == 0) {
    cudaMemsetAsync(dcw, 0, sizeof(float) * k * d, st);
    cudaMemsetAsync(dcb, 0, sizeof(float) * d, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == vct::kF32)
    return by_taps<float>(u, cw, cb, orders, rev_rows, gf, gr, du, dcw, dcb,
                          work, L, d, b, nb, nr, k, st);
  if (dtype == vct::kBF16)
    return by_taps<__nv_bfloat16>(u, cw, cb, orders, rev_rows, gf, gr, du,
                                  dcw, dcb, work, L, d, b, nb, nr, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// float32 elements of the workspace vct_inv_perm_weighted_sum_bwd needs:
// one partial per (stream, block) of the widest grid, whatever L
extern "C" long long vct_inv_perm_weighted_sum_bwd_workspace(int d, int b,
                                                             int nb, int nr) {
  return sum_bwd_chunks(static_cast<long long>(d) * b, 1) * kTokenGroups *
         (nb + nr);
}

extern "C" int vct_inv_perm_weighted_sum_bwd(int dtype, const void* g,
                                             const void* yf, const void* yr,
                                             const float* wf, const float* wr,
                                             const int* inv,
                                             const int* rev_rows, void* dyf,
                                             void* dyr, float* dw, float* work,
                                             int L, int d, int b, int nb,
                                             int nr, void* stream) {
  const long long n = static_cast<long long>(d) * b;
  if (nb < 1 || nr < 0 || nr > nb || nb + nr > kMaxStreams ||
      sum_bwd_chunks(n, 1) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 0 || d == 0 || b == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * (nb + nr), st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == vct::kF32)
    return by_width<float>(g, yf, yr, wf, wr, inv, rev_rows, dyf, dyr, dw,
                           work, L, n, nb, nr, st);
  if (dtype == vct::kBF16)
    return by_width<__nv_bfloat16>(g, yf, yr, wf, wr, inv, rev_rows, dyf,
                                   dyr, dw, work, L, n, nb, nr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
