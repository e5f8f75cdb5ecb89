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
//   1. egm_device.cuh's egm_fixed_point; with `tail` (compact grids) every
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
// Memory: a lane's workspace holds the EGM phase's arrays, then the
// lottery's (weights and bracket [D, N], CSR start [N, D+1], source and
// coefficient [N, 2D], cursors [N, D]): about 175 KB in f64 at D=500,
// N=7, A=32, so it sits in shared memory; a larger one (the fine grid)
// goes to a wrapper-allocated global workspace, with the same bits.  The
// distribution iterates live in a global scratch that the 50 MB L2 holds,
// as in stationary_lottery_grid.
//
// What bounds it on an H100: the latency of two dependent chains of
// block-wide steps (hundreds of EGM steps, then hundreds to thousands of
// push-forward steps), not bytes or FLOPs.  One block per lane fills 12 of
// 132 SMs on the Table II sweep; spreading a lane is later work.
//
// Compile without --use_fast_math and with --fmad=false, so every
// product-then-sum rounds as the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "egm_device.cuh"
#include "lottery_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = ahtt::kLotteryMaxN;

// Bytes of one lane's workspace: the EGM region, then the lottery's T
// arrays (weights [D, N], coefficients [N, 2D]) and int arrays (bracket
// [D, N], start [N, D+1], sources [N, 2D], cursors [N, D]).
template <typename T>
__host__ __device__ size_t workspace_bytes(int N, int A, int D, bool tail) {
  const size_t dn = (size_t)D * N;
  const size_t t_elems =
      ahtt::egm_workspace_elems(N, A, A + (tail ? 3 : 1)) + 3 * dn;
  const size_t i_elems = dn + (size_t)N * (D + 1) + 2 * dn + dn;
  return t_elems * sizeof(T) + i_elems * sizeof(int);
}

template <typename T>
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
                  T* __restrict__ dscratch, int use_shared, int tail, int N,
                  int A, int D, T tol, int max_iter, int accel_every,
                  T dist_tol, int dist_max_iter, int dist_accel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kThreads / 32];
  const bool tl = tail != 0;
  const int K = A + (tl ? 3 : 1);
  const int NK = N * K;
  const int DN = D * N;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  unsigned char* row = use_shared
      ? smem_raw
      : ws_g + (size_t)lane * ahtt::ws_row_bytes(
                                  workspace_bytes<T>(N, A, D, tl));
  T* ws = reinterpret_cast<T*>(row);
  const ahtt::EgmWorkspace<T> w(ws, N, A, K);
  const T* s = scal + (size_t)lane * 5;

  // 1. the policy fixed point
  const ahtt::EgmResult<T> egm = ahtt::egm_fixed_point<T>(
      w, red, m0 + (size_t)lane * NK, c0 + (size_t)lane * NK,
      a_g + (size_t)lane * A, lvl_g + (size_t)lane * N,
      P_g + (size_t)lane * N * N, s, h_g + (size_t)lane * N, N, A, tl, tol,
      max_iter, accel_every);
  const T* km = w.new_m;                // the certified knots [N, K]
  const T* kc = w.new_c;
  for (int j = tid; j < NK; j += nthr) {
    m_out[(size_t)lane * NK + j] = km[j];
    c_out[(size_t)lane * NK + j] = kc[j];
  }

  // the lottery's region of the workspace, after the EGM region
  T* wgt = ws + ahtt::egm_workspace_elems(N, A, K);   // [D, N]
  T* cf = wgt + DN;                                   // [N, 2D]
  int* bidx = reinterpret_cast<int*>(cf + 2 * DN);    // [D, N]
  int* st = bidx + DN;                                // [N, D+1]
  int* sr = st + N * (D + 1);                         // [N, 2D]
  int* cu = sr + 2 * DN;                              // [N, D]

  // 2. the savings policy on the histogram support, as a lottery
  const T* x = dg_g + (size_t)lane * D;
  const T R = s[0], W = s[1], b = s[4];
  const T xtop = x[D - 1];
  for (int j = tid; j < DN; j += nthr) {
    const int d = j / N;
    const int n = j - d * N;
    const T m = R * x[d] + W * w.lvl[n];
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
    const T c = fp[k] + slope * (m - xp[k]);
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
    int* srn = sr + n * 2 * D;
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
      srn[k] = d;
      cfn[k] = T(1) - wgt[d * N + n];
    }
    for (int d = 0; d < D; ++d) {       // then all right shares
      const int k = cun[bidx[d * N + n] + 1]++;
      srn[k] = d;
      cfn[k] = wgt[d * N + n];
    }
  }
  __syncthreads();

  // 4. the stationary distribution
  const ahtt::LotteryResult<T> dist = ahtt::lottery_fixed_point<T>(
      st, sr, cf, w.P, d0 + (size_t)lane * DN, dist_out + (size_t)lane * DN,
      dscratch + (size_t)lane * ahtt::lottery_scratch_elems(D, N), red, D,
      N, dist_tol, dist_max_iter, dist_accel);
  if (tid == 0) {
    egm_it_out[lane] = egm.iters;
    egm_diff_out[lane] = egm.diff;
    dist_it_out[lane] = dist.iters;
    dist_diff_out[lane] = dist.diff;
  }
}

template <typename T>
int launch(const void* m0, const void* c0, const void* a, const void* dg,
           const void* lvl, const void* P, const void* scal, const void* h,
           const void* d0, void* m_out, void* c_out, void* dist_out,
           void* egm_it, void* egm_diff, void* dist_it, void* dist_diff,
           void* ws, void* dscratch, int use_shared, int tail, int C, int N,
           int A, int D, double tol, int max_iter, int accel_every,
           double dist_tol, int dist_max_iter, int dist_accel,
           void* stream) {
  if (N > kMaxN || A < 1 || D < 2) return (int)cudaErrorInvalidValue;
  const size_t smem =
      use_shared ? workspace_bytes<T>(N, A, D, tail != 0) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_cell_kernel<T><<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)m0, (const T*)c0, (const T*)a, (const T*)dg, (const T*)lvl,
      (const T*)P, (const T*)scal, (const T*)h, (const T*)d0, (T*)m_out,
      (T*)c_out, (T*)dist_out, (int*)egm_it, (T*)egm_diff, (int*)dist_it,
      (T*)dist_diff, (unsigned char*)ws, (T*)dscratch, use_shared, tail, N,
      A, D, (T)tol, max_iter, accel_every, (T)dist_tol, dist_max_iter,
      dist_accel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_cell_grid_max_states() { return kMaxN; }

// Bytes of one lane's workspace: the wrapper puts it in shared memory when
// it fits one block's share, else allocates it in global memory.
unsigned long long fused_cell_grid_workspace_bytes(int N, int A, int D,
                                                   int tail, int f64) {
  return f64 ? workspace_bytes<double>(N, A, D, tail != 0)
             : workspace_bytes<float>(N, A, D, tail != 0);
}

// Elements of T one lane's distribution scratch needs (global memory).
unsigned long long fused_cell_grid_scratch_elems(int D, int N) {
  return ahtt::lottery_scratch_elems(D, N);
}

#define FUSED_ENTRY(NAME, T)                                                 \
  int NAME(const void* m0, const void* c0, const void* a, const void* dg,    \
           const void* lvl, const void* P, const void* scal, const void* h,  \
           const void* d0, void* m_out, void* c_out, void* dist_out,         \
           void* egm_it, void* egm_diff, void* dist_it, void* dist_diff,     \
           void* ws, void* dscratch, int use_shared, int tail, int C, int N, \
           int A, int D, double tol, int max_iter, int accel_every,          \
           double dist_tol, int dist_max_iter, int dist_accel,               \
           void* stream) {                                                   \
    return launch<T>(m0, c0, a, dg, lvl, P, scal, h, d0, m_out, c_out,       \
                     dist_out, egm_it, egm_diff, dist_it, dist_diff, ws,     \
                     dscratch, use_shared, tail, C, N, A, D, tol, max_iter,  \
                     accel_every, dist_tol, dist_max_iter, dist_accel,       \
                     stream);                                                \
  }

FUSED_ENTRY(fused_cell_grid_f32, float)
FUSED_ENTRY(fused_cell_grid_f64, double)

#undef FUSED_ENTRY

}  // extern "C"
