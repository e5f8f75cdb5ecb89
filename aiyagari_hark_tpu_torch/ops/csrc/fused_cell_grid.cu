// fused_cell_grid: one whole supply evaluation per lane in one launch --
// the EGM policy fixed point, the savings policy on the histogram support,
// the lottery grouped by target, and the stationary distribution -- one
// thread block per lane, each lane exiting at its own convergence.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, fused_cell_pallas
// (single lane, launched here with C = 1) and fused_cell_pallas_grid (one
// program instance per lane); their shared body is _fused_phases.
//
// The phases:
//   1. egm_device.cuh's egm_fixed_point (one block holds the lane); with
//      `tail` (compact grids) every
//      iterate is closed by the analytic tail (K = A+3 knots), its slope
//      computed here, its intercept h [C, N] from the wrapper (an N x N
//      solve that depends only on R, W and P, as in the TPU kernel);
//   2. household.wealth_transition on the final knots: m = R x_d + W l_n,
//      c by rowwise interpolation (linear extrapolation past the ends),
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
// 212 KB, so the whole lane sits in shared memory and the distribution
// loop, nearly all of the kernel's time, reads nothing else.  A larger
// workspace (the fine grid), or `force_global`, puts the same layout in a
// wrapper-allocated global workspace, with the same bits.  The kernel is
// compiled once per layout (and per bound on the labor states), so a
// shared workspace is addressed as shared memory.
//
// What bounds it on an H100: the latency of two dependent chains of
// block-wide steps (hundreds of EGM steps, then hundreds to thousands of
// push-forward steps), not bytes or FLOPs; keeping both chains in shared
// memory is what the layout does about it.  One block per lane fills 12
// of 132 SMs on the Table II sweep; spreading a lane over a cluster is
// later work.
//
// Compile without --use_fast_math and with contraction on (--fmad=true,
// as PyTorch's kernels are built): pow then rounds as torch.pow does, and
// every product the kernel writes is rounded on its own (common.cuh's
// mul), as the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "egm_device.cuh"
#include "lottery_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = ahtt::kLotteryMaxN;

static_assert((kThreads & (kThreads - 1)) == 0, "a power of two");
static_assert(ahtt::lottery_red_elems(kThreads)
                  >= ahtt::egm_red_elems(kThreads),
              "both loops share the reduction scratch");

// Bytes of one lane's workspace: the lottery's CSR and transition, then
// the larger of phases 1-3 (the EGM region, weights [D, N] in T, bracket
// [D, N] and cursors [N, D] in int) and phase 4 (the iterates, with the
// best one if `best`).
template <typename T>
__host__ __device__ size_t workspace_bytes(int N, int A, int D, bool tail,
                                           bool best) {
  const size_t dn = (size_t)D * N;
  const size_t sort =
      (ahtt::egm_workspace_elems(N, N, A, A + (tail ? 3 : 1)) + dn)
          * sizeof(T)
      + 2 * dn * sizeof(int);
  const size_t dist = ahtt::lottery_iterate_bytes<T>(D, N, best);
  return ahtt::lottery_csr_bytes<T>(D, N) + (sort > dist ? sort : dist);
}

// Layouts (the wrapper's choice): 0 global; 1 shared, best iterate in the
// output; 2 shared, best iterate too.  NB bounds the labor states (8 or
// 16), so the loops over states unroll.
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
                                    workspace_bytes<T>(N, A, D, tl, false));
  else
    row = smem_raw;
  const ahtt::LotteryCsr<T> csr(row, D, N);
  T* ws = reinterpret_cast<T*>(row + ahtt::lottery_csr_bytes<T>(D, N));
  const ahtt::EgmWorkspace<T> w(ws, N, N, A, K);
  const T* s = scal + (size_t)lane * 5;
  ahtt::load_transition(csr.Pt, P_g + (size_t)lane * N * N, N);

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
      kLayout == 2 ? ws + 3 * DN : out, out, red, D, N, dist_tol,
      dist_max_iter, dist_accel);
  if (tid == 0) {
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
                  int tail, int C, int N, int A, int D, double tol,
                  int max_iter, int accel_every, double dist_tol,
                  int dist_max_iter, int dist_accel, void* stream) {
  const size_t smem =
      kLayout ? workspace_bytes<T>(N, A, D, tail != 0, kLayout == 2) : 0;
  if (smem > 48 * 1024) {
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

template <typename T>
int launch(const void* m0, const void* c0, const void* a, const void* dg,
           const void* lvl, const void* P, const void* scal, const void* h,
           const void* d0, void* m_out, void* c_out, void* dist_out,
           void* egm_it, void* egm_diff, void* dist_it, void* dist_diff,
           void* ws, int layout, int tail, int C, int N, int A, int D,
           double tol, int max_iter, int accel_every, double dist_tol,
           int dist_max_iter, int dist_accel, void* stream) {
  if (N < 1 || N > kMaxN || A < 1 || D < 2 || layout < 0 || layout > 2
      || ahtt::next_pow2(D * N) / kThreads > (1 << ahtt::kChunkLevels))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto fn) {
    return fn(m0, c0, a, dg, lvl, P, scal, h, d0, m_out, c_out, dist_out,
              egm_it, egm_diff, dist_it, dist_diff, ws, tail, C, N, A, D,
              tol, max_iter, accel_every, dist_tol, dist_max_iter,
              dist_accel, stream);
  };
  // one instantiation per layout, and per bound on the labor states
  if (N <= 8) {
    switch (layout) {
      case 0: return run(launch_layout<T, 0, 8>);
      case 1: return run(launch_layout<T, 1, 8>);
      default: return run(launch_layout<T, 2, 8>);
    }
  }
  switch (layout) {
    case 0: return run(launch_layout<T, 0, 16>);
    case 1: return run(launch_layout<T, 1, 16>);
    default: return run(launch_layout<T, 2, 16>);
  }
}

}  // namespace

extern "C" {

int fused_cell_grid_max_states() { return kMaxN; }

// Bytes of one lane's workspace, with or without the best iterate: the
// wrapper puts it in shared memory when it fits one block's share, else
// allocates it (without the best iterate) in global memory.
unsigned long long fused_cell_grid_workspace_bytes(int N, int A, int D,
                                                   int tail, int f64,
                                                   int best) {
  return f64 ? workspace_bytes<double>(N, A, D, tail != 0, best != 0)
             : workspace_bytes<float>(N, A, D, tail != 0, best != 0);
}

#define FUSED_ENTRY(NAME, T)                                                 \
  int NAME(const void* m0, const void* c0, const void* a, const void* dg,    \
           const void* lvl, const void* P, const void* scal, const void* h,  \
           const void* d0, void* m_out, void* c_out, void* dist_out,         \
           void* egm_it, void* egm_diff, void* dist_it, void* dist_diff,     \
           void* ws, int layout, int tail, int C, int N, int A, int D,       \
           double tol, int max_iter, int accel_every, double dist_tol,       \
           int dist_max_iter, int dist_accel, void* stream) {                \
    return launch<T>(m0, c0, a, dg, lvl, P, scal, h, d0, m_out, c_out,       \
                     dist_out, egm_it, egm_diff, dist_it, dist_diff, ws,     \
                     layout, tail, C, N, A, D, tol, max_iter, accel_every,   \
                     dist_tol, dist_max_iter, dist_accel, stream);           \
  }

FUSED_ENTRY(fused_cell_grid_f32, float)
FUSED_ENTRY(fused_cell_grid_f64, double)

#undef FUSED_ENTRY

}  // extern "C"
