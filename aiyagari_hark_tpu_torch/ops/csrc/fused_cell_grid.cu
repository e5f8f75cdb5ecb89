// fused_cell_grid: one whole supply evaluation per lane in one launch --
// the EGM policy fixed point, the savings policy on the histogram support,
// the lottery grouped by target, and the stationary distribution -- one
// thread block per lane, or one thread-block cluster per lane where one
// block's shared memory cannot hold it, each lane exiting at its own
// convergence.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, fused_cell_pallas
// (single lane, launched here with C = 1) and fused_cell_pallas_grid (one
// program instance per lane); their shared body is _fused_phases.
//
// The phases:
//   1. egm_device.cuh's egm_fixed_point (one block holds the lane); with
//      `tail` (compact grids) every iterate is closed by the analytic tail
//      (K = A+3 knots), its slope computed here, its intercept h [C, N]
//      from the wrapper (an N x N solve that depends only on R, W and P,
//      as in the TPU kernel);
//   2. household.wealth_transition on the final knots: m = R x_d + W l_n,
//      c by rowwise interpolation over all K knots (linear extrapolation
//      past the ends; with the tail, above the knee along its segments),
//      a' = clamp(m - c, b, x_{D-1}), bracket searchsorted(right) - 1 in
//      [0, D-2] and right-neighbour weight clipped to [0, 1];
//   3. the lottery grouped by target inside the kernel (no host round trip
//      between the phases): a stable counting sort per labor state, one
//      thread per state, that lists for each target all left shares in
//      source order, then all right shares -- ops.kernels.lottery_csr's
//      order, with no float atomics;
//   4. lottery_device.cuh's lottery_fixed_point on that CSR.
//
// The TPU kernel builds a one-hot [D, N*D] operator (14 MB per lane in f64
// at D=500, N=7) and runs each step as a [D, N*D] x [N*D, N] matrix
// product.  This kernel iterates the two-point lottery instead; it mixes
// labor states after summing the lottery, the reference path's order (the
// TPU order is an artefact of its matrix layout, held to the reference
// only within 1e-9 by the JAX package itself).
//
// Memory: a lane's workspace is the lottery first (lottery_device.cuh's
// LotteryCsr: the transposed transition, coefficient [N, 2D], start
// [N, D+1], source element [N, 2D]), then one region that two phases
// share.  During phases 1-3 it holds the EGM workspace and the sort's
// temporaries (weights and bracket [D, N], cursors [N, D]); these are dead
// once the CSR is built and the knots are copied out, so during phase 4
// the same bytes hold the distribution iterates (current, previous, next)
// and, when it fits, the best one.  At D=500, N=7, A=32 in f64 that is
// 211 KB, so the whole lane sits in shared memory and the distribution
// loop, nearly all of the kernel's time, reads nothing else.  A larger
// workspace that no cluster takes (more than 16 labor states), or
// `force_global`, puts the same layout in a wrapper-allocated global
// workspace, with the same bits.  The kernel is
// compiled once per layout (and per bound on the labor states), so a
// shared workspace is addressed as shared memory.
//
// The cluster layout (3; the fine width, A=1000, N=15, D=1000: a 1.5 MB
// workspace as one block in f64, 226 KB a block of 8 with its staged
// lottery; the fine compact grid, A=851, D=926, with the tail) runs the
// same phases on a cluster of kLotteryClusterMax blocks:
//   1. egm_device.cuh's egm_fixed_point<T, true>: block r holds the labor
//      states [r S, r S + S), S = ceil(N / 8) (a block past the states,
//      where N < 15, holds none and joins the barriers), each closed by
//      the tail under `tail`; each block writes its states' certified
//      knots to the outputs;
//   2. block r computes the savings policy of its own source rows
//      [r0, r1) (lottery_cluster_span) in every state, reading each state's
//      K knots (tail-closed under `tail`) from the block that holds them
//      through distributed shared memory, and writes bracket and weight to
//      the lane's global workspace; a cluster barrier;
//   3. the lottery grouped by target into the global workspace: each
//      state is one warp's, state n in warp n / 8 of block n % 8, a stable
//      counting sort in 32-source chunks (a warp match ranks a chunk's
//      equal targets in source order), the CSR of the one-block phase 3
//      byte for byte; a cluster barrier;
//   4. lottery_device.cuh's lottery_stage_rows and lottery_cluster_loop,
//      on a LotteryClusterSmem region over the bytes phases 1-3 used (the
//      barrier ending phase 2 ends every peer's read of them).
//
// What bounds it on an H100: the latency of two dependent chains of
// block-wide steps (hundreds of EGM steps, then hundreds to thousands of
// push-forward steps), not bytes or FLOPs; keeping both chains in shared
// memory -- one block's, or a cluster's -- is what the layouts do about
// it.  One block per lane fills 12 of 132 SMs on the Table II sweep.
//
// Compile without --use_fast_math and with contraction on (--fmad=true,
// as PyTorch's kernels are built): pow then rounds as torch.pow does, and
// every product the kernel writes is rounded on its own (common.cuh's
// mul), as the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "egm_device.cuh"
#include "lottery_device.cuh"

namespace {

constexpr int kThreads = ahtt::kLotteryThreads;
constexpr int kCluster = 3;
constexpr int kG = ahtt::kLotteryClusterMax;   // blocks of a cluster lane
constexpr int kClusterRed =
    ahtt::lottery_cluster_red_elems(kThreads) > ahtt::egm_red_elems(kThreads)
        ? ahtt::lottery_cluster_red_elems(kThreads)
        : ahtt::egm_red_elems(kThreads);

static_assert((kThreads & (kThreads - 1)) == 0, "a power of two");
static_assert(ahtt::lottery_red_elems(kThreads)
                  >= ahtt::egm_red_elems(kThreads),
              "both loops share the reduction scratch");
static_assert(ahtt::kEgmClusterMax == kG, "one cluster runs both loops");

// Bytes of one lane's workspace in one block under bound `nb`: the
// lottery's CSR and transition, then the larger of phases 1-3 (the EGM
// region, weights [D, N] in T, bracket [D, N] and cursors [N, D] in int)
// and phase 4 (the iterates, with the best one if `best`, and the wide
// mix's staging rows).
template <typename T>
__host__ __device__ size_t workspace_bytes(int N, int A, int D, int nb,
                                           bool tail, bool best) {
  const size_t dn = (size_t)D * N;
  const size_t sort =
      (ahtt::egm_workspace_elems(N, N, A, A + (tail ? 3 : 1)) + dn)
          * sizeof(T)
      + 2 * dn * sizeof(int);
  const size_t dist = ahtt::lottery_iterate_bytes<T>(D, N, nb, best);
  return ahtt::lottery_csr_bytes<T>(D, N, nb) + (sort > dist ? sort : dist);
}

// Whether a lane may take the cluster layout: 2-16 labor states (the EGM
// cluster's), staged sources that pack into 16 bits.
__host__ __device__ inline bool cluster_takes(int N, int D, int nb) {
  return N >= 2 && N <= ahtt::kEgmClusterMaxN && D >= 2
         && nb == ahtt::lottery_nb(N) && ahtt::lottery_cluster_packs(D, N);
}

// Warps of a cluster block that sort a state each in phase 3.
__host__ __device__ inline int cluster_sort_warps(int N) {
  const int w = (N + kG - 1) / kG;
  return w < kThreads / 32 ? w : kThreads / 32;
}

// Bytes of one cluster block's shared memory, the largest of its phases:
// the EGM block (phase 1, K = A+3 knots a state with the tail), the sort's
// cursors (phase 3), the lottery region with room for `stage` staged
// entries (phase 4).
template <typename T>
__host__ __device__ size_t cluster_bytes(int N, int A, int D, int nb,
                                         bool tail, int stage) {
  const size_t egm =
      ahtt::egm_workspace_elems(ahtt::egm_cluster_states(N), N, A,
                                A + (tail ? 3 : 1))
      * sizeof(T);
  const size_t sort = (size_t)cluster_sort_warps(N) * (D + 1) * sizeof(int);
  const size_t lot = ahtt::lottery_cluster_bytes<T>(D, N, nb, stage);
  const size_t b = egm > sort ? egm : sort;
  return ahtt::ws_row_bytes(b > lot ? b : lot);
}

// Bytes of a cluster lane's global workspace: coefficient [N, 2D] and
// weight [D, N] in T, then start [N, D+1], source element [N, 2D] and
// bracket [D, N] in int.
template <typename T>
__host__ __device__ size_t cluster_ws_bytes(int N, int D) {
  const size_t dn = (size_t)D * N;
  return 3 * dn * sizeof(T) + ((size_t)N * (D + 1) + 3 * dn) * sizeof(int);
}

// The two bounds this library is compiled for: 8 and 16 (with the
// cluster layout), or, built from fused_cell_grid_wide.cu
// (AHTT_WIDE_BOUNDS), 32 and the wide mix: nvcc builds the two libraries
// side by side, each about half the kernels.
#ifdef AHTT_WIDE_BOUNDS
constexpr int kBounds[2] = {32, 0};
#else
constexpr int kBounds[2] = {8, 16};
#endif

// Layouts (the wrapper's choice): 0 global; 1 shared, best iterate in the
// output; 2 shared, best iterate too; 3 cluster (fused_cell_cluster_kernel).
// NB bounds the labor states (8, 16, 32, or 0: the wide mix), so the loops
// over states unroll.
template <typename T, int kLayout, int NB>
__global__ void __launch_bounds__(kThreads)
fused_cell_kernel(const T* __restrict__ m0, const T* __restrict__ c0,
                  const T* __restrict__ a_g, const T* __restrict__ dg_g,
                  const T* __restrict__ lvl_g, const T* __restrict__ P_g,
                  const T* __restrict__ scal, const T* __restrict__ h_g,
                  const T* __restrict__ d0, T* __restrict__ m_out,
                  T* __restrict__ c_out, T* __restrict__ dist_out,
                  int* __restrict__ egm_it_out, T* __restrict__ egm_diff_out,
                  int* __restrict__ dist_it_out,
                  T* __restrict__ dist_diff_out, unsigned char* ws_g,
                  int tail, int N, int A, int D, T tol,
                  int max_iter, int accel_every, T dist_tol,
                  int dist_max_iter, int dist_accel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[ahtt::lottery_red_elems(kThreads)];
  const bool tl = tail != 0;
  const int K = A + (tl ? 3 : 1);
  const int NK = N * K;
  const int DN = D * N;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  unsigned char* row;
  if constexpr (kLayout == 0)
    row = ws_g + (size_t)lane * ahtt::ws_row_bytes(
                                    workspace_bytes<T>(N, A, D, NB, tl,
                                                       false));
  else
    row = smem_raw;
  const ahtt::LotteryCsr<T> csr(row, D, N, NB);
  T* ws = reinterpret_cast<T*>(row + ahtt::lottery_csr_bytes<T>(D, N, NB));
  const ahtt::EgmWorkspace<T> w(ws, N, N, A, K);
  const T* s = scal + (size_t)lane * 5;
  ahtt::load_transition(csr.Pt, P_g + (size_t)lane * N * N, N,
                        ahtt::lottery_pad(N, NB));

  // 1. the policy fixed point
  const ahtt::EgmResult<T> egm = ahtt::egm_fixed_point<T, false>(
      w, red, m0 + (size_t)lane * NK, c0 + (size_t)lane * NK,
      a_g + (size_t)lane * A, lvl_g + (size_t)lane * N,
      P_g + (size_t)lane * N * N, s, h_g + (size_t)lane * N, N, N, A, tl,
      tol, max_iter, accel_every);
  const T* km = egm.m;                  // the certified knots [N, K]
  const T* kc = egm.c;
  for (int j = tid; j < NK; j += nthr) {
    m_out[(size_t)lane * NK + j] = km[j];
    c_out[(size_t)lane * NK + j] = kc[j];
  }

  // the sort's temporaries, after the EGM region; the CSR is the head
  T* wgt = ws + ahtt::egm_workspace_elems(N, N, A, K);   // [D, N]
  int* bidx = reinterpret_cast<int*>(wgt + DN);       // [D, N]
  int* cu = bidx + DN;                                // [N, D]
  T* cf = csr.cf;                                     // [N, 2D]
  int* st = csr.st;                                   // [N, D+1]
  int* se = csr.se;                                   // [N, 2D]

  // 2. the savings policy on the histogram support, as a lottery
  const T* x = dg_g + (size_t)lane * D;
  const T R = s[0], W = s[1], b = s[4];
  const T xtop = x[D - 1];
  for (int j = tid; j < DN; j += nthr) {
    const int d = j / N;
    const int n = j - d * N;
    const T m = ahtt::mul(R, x[d]) + ahtt::mul(W, w.lvl[n]);
    const T* xp = km + n * K;
    const T* fp = kc + n * K;
    int lo = 0, hi = K;                 // searchsorted(side="right")
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (xp[mid] <= m) lo = mid + 1; else hi = mid;
    }
    int k = lo - 1;
    k = k < 0 ? 0 : (k > K - 2 ? K - 2 : k);
    const T slope = (fp[k + 1] - fp[k]) / (xp[k + 1] - xp[k]);
    const T c = fp[k] + ahtt::mul(slope, m - xp[k]);
    const T an = ahtt::nan_min(ahtt::nan_max(m - c, b), xtop);
    lo = 0;
    hi = D;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (x[mid] <= an) lo = mid + 1; else hi = mid;
    }
    int i = lo - 1;
    i = i < 0 ? 0 : (i > D - 2 ? D - 2 : i);
    const T wt = (an - x[i]) / (x[i + 1] - x[i]);
    bidx[j] = i;
    wgt[j] = ahtt::nan_min(ahtt::nan_max(wt, T(0)), T(1));
  }
  __syncthreads();

  // 3. group the lottery by target: a stable counting sort per state
  for (int n = tid; n < N; n += nthr) {
    int* stn = st + n * (D + 1);
    int* cun = cu + n * D;
    int* sen = se + n * 2 * D;
    T* cfn = cf + n * 2 * D;
    for (int t = 0; t <= D; ++t) stn[t] = 0;
    for (int d = 0; d < D; ++d) {       // left share to i, right to i+1
      const int i = bidx[d * N + n];
      stn[i + 1] += 1;
      stn[i + 2] += 1;
    }
    for (int t = 1; t <= D; ++t) stn[t] += stn[t - 1];
    for (int t = 0; t < D; ++t) cun[t] = stn[t];
    for (int d = 0; d < D; ++d) {       // all left shares, in source order
      const int k = cun[bidx[d * N + n]]++;
      sen[k] = d * N + n;               // the source's element of [D, N]
      cfn[k] = T(1) - wgt[d * N + n];
    }
    for (int d = 0; d < D; ++d) {       // then all right shares
      const int k = cun[bidx[d * N + n] + 1]++;
      sen[k] = d * N + n;
      cfn[k] = wgt[d * N + n];
    }
  }
  __syncthreads();

  // 4. the stationary distribution, its iterates over phases 1-3's
  // region (dead now: the barrier above ends the sort)
  T* out = dist_out + (size_t)lane * DN;
  const ahtt::LotteryResult<T> dist = ahtt::lottery_fixed_point<T, NB>(
      st, se, cf, csr.Pt, d0 + (size_t)lane * DN, ws,
      kLayout == 2 ? ws + 3 * DN : out, out,
      NB ? nullptr : ws + (kLayout == 2 ? 4 : 3) * DN, red, D, N, dist_tol,
      dist_max_iter, dist_accel);
  if (tid == 0) {
    egm_it_out[lane] = egm.iters;
    egm_diff_out[lane] = egm.diff;
    dist_it_out[lane] = dist.iters;
    dist_diff_out[lane] = dist.diff;
  }
}

// The cluster layout (3): one lane per cluster of kG blocks, the phases
// as the header says.  `ws_g` holds each lane's cluster_ws_bytes; `stage`
// is the lottery entries each block may stage (the wrapper's count).
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
fused_cell_cluster_kernel(const T* __restrict__ m0, const T* __restrict__ c0,
                          const T* __restrict__ a_g,
                          const T* __restrict__ dg_g,
                          const T* __restrict__ lvl_g,
                          const T* __restrict__ P_g,
                          const T* __restrict__ scal,
                          const T* __restrict__ h_g,
                          const T* __restrict__ d0, T* __restrict__ m_out,
                          T* __restrict__ c_out, T* __restrict__ dist_out,
                          int* __restrict__ egm_it_out,
                          T* __restrict__ egm_diff_out,
                          int* __restrict__ dist_it_out,
                          T* __restrict__ dist_diff_out, unsigned char* ws_g,
                          int tail, int N, int A, int D, int stage, T tol,
                          int max_iter, int accel_every, T dist_tol,
                          int dist_max_iter, int dist_accel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kClusterRed];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int lane = blockIdx.x / kG;
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const bool tl = tail != 0;
  const int K = A + (tl ? 3 : 1);
  const int NK = N * K;
  const int DN = D * N;
  const int S = ahtt::egm_cluster_states(N);
  const T* s = scal + (size_t)lane * 5;
  unsigned char* wsl =
      ws_g + (size_t)lane * ahtt::ws_row_bytes(cluster_ws_bytes<T>(N, D));
  T* cf = reinterpret_cast<T*>(wsl);                  // [N, 2D]
  T* wgt = cf + 2 * DN;                               // [D, N]
  int* st = reinterpret_cast<int*>(wgt + DN);         // [N, D+1]
  int* se = st + N * (D + 1);                         // [N, 2D]
  int* bidx = se + 2 * DN;                            // [D, N]

  // 1. the policy fixed point, the labor states split over the cluster
  // (each block closing its own states with the tail under `tail`)
  const ahtt::EgmWorkspace<T> w(reinterpret_cast<T*>(smem_raw), S, N, A, K);
  const ahtt::EgmResult<T> egm = ahtt::egm_fixed_point<T, true>(
      w, red, m0 + (size_t)lane * NK, c0 + (size_t)lane * NK,
      a_g + (size_t)lane * A, lvl_g + (size_t)lane * N,
      P_g + (size_t)lane * N * N, s, h_g + (size_t)lane * N, S, N, A, tl,
      tol, max_iter, accel_every);
  const int s0 = rank * S;
  const int ns = N - s0 < S ? (N > s0 ? N - s0 : 0) : S;
  for (int j = tid; j < ns * K; j += nthr) {
    m_out[(size_t)lane * NK + (size_t)s0 * K + j] = egm.m[j];
    c_out[(size_t)lane * NK + (size_t)s0 * K + j] = egm.c[j];
  }

  // 2. the savings policy of this block's source rows, as a lottery; the
  // K knots of state n are in block n / S's certified iterate (the same
  // offset in every block), written before the EGM loop's last barrier
  int r0, r1;
  ahtt::lottery_cluster_span(D, rank, &r0, &r1);
  const T* x = dg_g + (size_t)lane * D;
  const T R = s[0], W = s[1], b = s[4];
  const T xtop = x[D - 1];
  T* const km = const_cast<T*>(egm.m);
  T* const kc = const_cast<T*>(egm.c);
  for (int j = r0 * N + tid; j < r1 * N; j += nthr) {
    const int d = j / N;
    const int n = j - d * N;
    const T m = ahtt::mul(R, x[d]) + ahtt::mul(W, w.lvl[n]);
    const T* xp = cl.map_shared_rank(km, n / S) + (n % S) * K;
    const T* fp = cl.map_shared_rank(kc, n / S) + (n % S) * K;
    int lo = 0, hi = K;                 // searchsorted(side="right")
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (xp[mid] <= m) lo = mid + 1; else hi = mid;
    }
    int k = lo - 1;
    k = k < 0 ? 0 : (k > K - 2 ? K - 2 : k);
    const T slope = (fp[k + 1] - fp[k]) / (xp[k + 1] - xp[k]);
    const T c = fp[k] + ahtt::mul(slope, m - xp[k]);
    const T an = ahtt::nan_min(ahtt::nan_max(m - c, b), xtop);
    lo = 0;
    hi = D;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (x[mid] <= an) lo = mid + 1; else hi = mid;
    }
    int i = lo - 1;
    i = i < 0 ? 0 : (i > D - 2 ? D - 2 : i);
    const T wt = (an - x[i]) / (x[i + 1] - x[i]);
    bidx[j] = i;
    wgt[j] = ahtt::nan_min(ahtt::nan_max(wt, T(0)), T(1));
  }
  // every bracket written (global, read by other blocks next); every read
  // of the peers' knots done, so the shared bytes are free
  __threadfence();
  cl.sync();

  // 3. the lottery grouped by target: a stable counting sort per state,
  // one warp each, its cursors [D+1] in this block's shared memory
  const int wl = tid & 31;
  const int wid = tid >> 5;
  const int nw = cluster_sort_warps(N);
  int* cnt = reinterpret_cast<int*>(smem_raw) + wid * (D + 1);
  for (int n = rank + kG * wid; wid < nw && n < N; n += kG * nw) {
    int* stn = st + n * (D + 1);
    int* sen = se + n * 2 * D;
    T* cfn = cf + n * 2 * D;
    for (int t = wl; t <= D; t += 32) cnt[t] = 0;
    __syncwarp();
    for (int d = wl; d < D; d += 32) {   // left share to i, right to i+1
      const int i = bidx[d * N + n];
      atomicAdd(cnt + i + 1, 1);
      atomicAdd(cnt + i + 2, 1);
    }
    __syncwarp();
    // the starts: an inclusive scan of the counts, 32 at a time
    int carry = 0;
    for (int t0 = 0; t0 <= D; t0 += 32) {
      const int t = t0 + wl;
      int v = t <= D ? cnt[t] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (wl >= o) v += u;
      }
      v += carry;
      if (t <= D) {
        cnt[t] = v;                      // the target's cursor
        stn[t] = v;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    // all left shares in source order, then all right shares: a chunk's
    // sources with equal targets take consecutive slots in source order
    for (int side = 0; side < 2; ++side) {
      for (int d0c = 0; d0c < D; d0c += 32) {
        const int d = d0c + wl;
        const bool valid = d < D;
        const int key = valid ? bidx[d * N + n] + side : -1 - wl;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const int before = __popc(peers & ((1u << wl) - 1u));
        const int pos = valid ? cnt[key] + before : 0;
        __syncwarp();
        if (valid && before == 0) cnt[key] += __popc(peers);
        __syncwarp();
        if (valid) {
          const T wt = wgt[d * N + n];
          sen[pos] = d * N + n;          // the source's element of [D, N]
          cfn[pos] = side ? wt : T(1) - wt;
        }
      }
    }
  }
  // every state's CSR written (global, staged by every block next)
  __threadfence();
  cl.sync();

  // 4. the stationary distribution over the cluster, its shared region
  // over phases 1-3's bytes
  const ahtt::LotteryClusterSmem<T> sm(smem_raw, D, N, NB, stage);
  const ahtt::LotteryRows<T> rows =
      ahtt::lottery_stage_rows(sm, st, se, cf, D, N, stage, rank);
  ahtt::load_transition(sm.Pt, P_g + (size_t)lane * N * N, N,
                        ahtt::lottery_pad(N, NB));
  const int rn = ahtt::lottery_cluster_rows(D) * N;
  const ahtt::LotteryResult<T> dist = ahtt::lottery_cluster_loop<T, NB>(
      rows, sm.Pt, d0 + (size_t)lane * DN, sm.it, sm.it + 3 * rn,
      dist_out + (size_t)lane * DN, sm.mv, sm.split, red, D, N, dist_tol,
      dist_max_iter, dist_accel);
  if (rank == 0 && tid == 0) {
    egm_it_out[lane] = egm.iters;
    egm_diff_out[lane] = egm.diff;
    dist_it_out[lane] = dist.iters;
    dist_diff_out[lane] = dist.diff;
  }
}

template <typename T, int kLayout, int NB>
int launch_layout(const void* m0, const void* c0, const void* a,
                  const void* dg, const void* lvl, const void* P,
                  const void* scal, const void* h, const void* d0,
                  void* m_out, void* c_out, void* dist_out, void* egm_it,
                  void* egm_diff, void* dist_it, void* dist_diff, void* ws,
                  int tail, int stage, int C, int N, int A, int D,
                  double tol, int max_iter, int accel_every, double dist_tol,
                  int dist_max_iter, int dist_accel, void* stream) {
  const size_t smem =
      kLayout ? workspace_bytes<T>(N, A, D, NB, tail != 0, kLayout == 2) : 0;
  // the default cap (48 KB) counts the static arrays too: allow every
  // dynamic request
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_cell_kernel<T, kLayout, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_cell_kernel<T, kLayout, NB>
      <<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)m0, (const T*)c0, (const T*)a, (const T*)dg, (const T*)lvl,
      (const T*)P, (const T*)scal, (const T*)h, (const T*)d0, (T*)m_out,
      (T*)c_out, (T*)dist_out, (int*)egm_it, (T*)egm_diff, (int*)dist_it,
      (T*)dist_diff, (unsigned char*)ws, tail, N, A, D, (T)tol, max_iter,
      accel_every, (T)dist_tol, dist_max_iter, dist_accel);
  return (int)cudaGetLastError();
}

template <typename T, int NB>
int launch_cluster(const void* m0, const void* c0, const void* a,
                   const void* dg, const void* lvl, const void* P,
                   const void* scal, const void* h, const void* d0,
                   void* m_out, void* c_out, void* dist_out, void* egm_it,
                   void* egm_diff, void* dist_it, void* dist_diff, void* ws,
                   int tail, int stage, int C, int N, int A, int D,
                   double tol, int max_iter, int accel_every,
                   double dist_tol, int dist_max_iter, int dist_accel,
                   void* stream) {
  const size_t smem = cluster_bytes<T>(N, A, D, NB, tail != 0, stage);
  auto kern = fused_cell_cluster_kernel<T, NB>;
  // the default cap (48 KB) counts the static arrays too: allow every
  // dynamic request
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * kG));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kG;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)m0, (const T*)c0, (const T*)a, (const T*)dg,
      (const T*)lvl, (const T*)P, (const T*)scal, (const T*)h, (const T*)d0,
      (T*)m_out, (T*)c_out, (T*)dist_out, (int*)egm_it, (T*)egm_diff,
      (int*)dist_it, (T*)dist_diff, (unsigned char*)ws, tail, N, A, D, stage,
      (T)tol, max_iter, accel_every, (T)dist_tol, dist_max_iter, dist_accel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* m0, const void* c0, const void* a, const void* dg,
           const void* lvl, const void* P, const void* scal, const void* h,
           const void* d0, void* m_out, void* c_out, void* dist_out,
           void* egm_it, void* egm_diff, void* dist_it, void* dist_diff,
           void* ws, int layout, int nb, int stage, int tail, int C, int N,
           int A, int D, double tol, int max_iter, int accel_every,
           double dist_tol, int dist_max_iter, int dist_accel,
           void* stream) {
  const int K = A + (tail ? 3 : 1);
  if (N < 1 || A < 1 || D < 2 || nb != ahtt::lottery_nb(N)
      || (nb != kBounds[0] && nb != kBounds[1]) || layout < 0
      || layout > kCluster || stage < 0 || (layout != kCluster && stage != 0)
      || (layout == kCluster && !cluster_takes(N, D, nb))
      || ahtt::next_pow2(D * N) / kThreads > (1 << ahtt::kChunkLevels)
      || ahtt::next_pow2(2 * N * K) / kThreads > (1 << ahtt::kChunkLevels))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto fn) {
    return fn(m0, c0, a, dg, lvl, P, scal, h, d0, m_out, c_out, dist_out,
              egm_it, egm_diff, dist_it, dist_diff, ws, tail, stage, C, N, A,
              D, tol, max_iter, accel_every, dist_tol, dist_max_iter,
              dist_accel, stream);
  };
  // one instantiation per layout, and per bound on the labor states this
  // library holds
#ifndef AHTT_WIDE_BOUNDS
  if (layout == kCluster)   // 2-16 states: the bound is 8 or 16
    return nb == 8 ? run(launch_cluster<T, 8>) : run(launch_cluster<T, 16>);
#endif
  using Fn = decltype(&launch_layout<T, 0, kBounds[0]>);
  constexpr Fn fns[2][3] = {
      {launch_layout<T, 0, kBounds[0]>, launch_layout<T, 1, kBounds[0]>,
       launch_layout<T, 2, kBounds[0]>},
      {launch_layout<T, 0, kBounds[1]>, launch_layout<T, 1, kBounds[1]>,
       launch_layout<T, 2, kBounds[1]>}};
  return run(fns[nb == kBounds[1]][layout]);
}

}  // namespace

extern "C" {

// Bytes of one lane's workspace in one block under bound `nb`, with or
// without the best iterate: the wrapper puts it in shared memory when it
// fits one block's share, else allocates it (without the best iterate) in
// global memory.
unsigned long long fused_cell_grid_workspace_bytes(int N, int A, int D,
                                                   int nb, int tail, int f64,
                                                   int best) {
  return f64 ? workspace_bytes<double>(N, A, D, nb, tail != 0, best != 0)
             : workspace_bytes<float>(N, A, D, nb, tail != 0, best != 0);
}

// Bytes of shared memory each block of a cluster lane takes under bound
// `nb`, with or without the tail, with room for `stage` staged lottery
// entries (stage = 0: the part that must fit for the lane to take the
// cluster layout), or ~0 where the lane cannot take it (N outside 2..16,
// unpackable sources).
unsigned long long fused_cell_grid_cluster_bytes(int N, int A, int D, int nb,
                                                 int tail, int f64,
                                                 int stage) {
  if (A < 1 || stage < 0 || !cluster_takes(N, D, nb)) return ~0ull;
  return f64 ? cluster_bytes<double>(N, A, D, nb, tail != 0, stage)
             : cluster_bytes<float>(N, A, D, nb, tail != 0, stage);
}

// Bytes of the lottery region of a cluster block with no entry staged:
// the rest of the block's share is the room its staged entries may take.
unsigned long long fused_cell_grid_cluster_lottery_bytes(int N, int D, int nb,
                                                         int f64) {
  return f64 ? ahtt::lottery_cluster_bytes<double>(D, N, nb, 0)
             : ahtt::lottery_cluster_bytes<float>(D, N, nb, 0);
}

// Bytes of one cluster lane's global workspace (its sort's output).
unsigned long long fused_cell_grid_cluster_ws_bytes(int N, int D, int f64) {
  return f64 ? cluster_ws_bytes<double>(N, D) : cluster_ws_bytes<float>(N, D);
}

#define FUSED_ENTRY(NAME, T)                                                 \
  int NAME(const void* m0, const void* c0, const void* a, const void* dg,    \
           const void* lvl, const void* P, const void* scal, const void* h,  \
           const void* d0, void* m_out, void* c_out, void* dist_out,         \
           void* egm_it, void* egm_diff, void* dist_it, void* dist_diff,     \
           void* ws, int layout, int nb, int stage, int tail, int C, int N,  \
           int A, int D, double tol, int max_iter, int accel_every,          \
           double dist_tol, int dist_max_iter, int dist_accel,               \
           void* stream) {                                                   \
    return launch<T>(m0, c0, a, dg, lvl, P, scal, h, d0, m_out, c_out,       \
                     dist_out, egm_it, egm_diff, dist_it, dist_diff, ws,     \
                     layout, nb, stage, tail, C, N, A, D, tol, max_iter,     \
                     accel_every, dist_tol, dist_max_iter, dist_accel,       \
                     stream);                                                \
  }

FUSED_ENTRY(fused_cell_grid_f32, float)
FUSED_ENTRY(fused_cell_grid_f64, double)

#undef FUSED_ENTRY

}  // extern "C"
