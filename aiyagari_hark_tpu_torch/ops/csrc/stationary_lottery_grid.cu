// stationary_lottery_grid: the stationary wealth distribution of the
// Young-lottery push-forward, one thread block per lane.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, stationary_dense_pallas
// (single lane, launched here with C = 1) and stationary_dense_pallas_grid
// (one program instance per lane).  The loop is lottery_device.cuh's
// lottery_fixed_point (household.accelerated_distribution_fixed_point).
//
// The TPU kernel iterates the dense operator S [N, D, D] (about 7 MB per
// lane in f32 at D=500, N=7) resident in VMEM.  That is thirty times one
// SM's shared memory, so this kernel iterates the same Markov operator in
// the two-point form S is built from: the wrapper lists, for each labor
// state and target gridpoint, the sources that land there (a stable CSR,
// ops.kernels.lottery_csr), and each target sums its sources in that
// fixed order, with no float atomics.
//
// What bounds it on an H100: not bytes or FLOPs.  A lane moves about
// 150 KB of lottery and iterates once, then runs thousands of dependent
// steps of ~20 D N flops each, separated by block-wide reductions; the
// bound is the latency of that chain.  The iterates (current, previous,
// next) and the pairwise-sum buffers live in a wrapper-allocated scratch
// that the 50 MB L2 holds, the best iterate in the output.  Shared-memory
// residency and more than one SM per lane are later work.
//
// Compile without --use_fast_math and with --fmad=false, so every
// product-then-sum rounds as the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "lottery_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = ahtt::kLotteryMaxN;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stationary_lottery_kernel(const int* __restrict__ start,
                          const int* __restrict__ src,
                          const T* __restrict__ coef,
                          const T* __restrict__ P_g,
                          const T* __restrict__ d0, T* __restrict__ best_out,
                          int* __restrict__ iters_out,
                          T* __restrict__ diff_out, T* __restrict__ scratch,
                          int D, int N, T tol, int max_iter,
                          int accel_every) {
  __shared__ T P[kMaxN * kMaxN];
  __shared__ T red[kThreads / 32];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t DN = (size_t)D * N;
  for (int j = tid; j < N * N; j += blockDim.x)
    P[j] = P_g[(size_t)lane * N * N + j];
  __syncthreads();
  const ahtt::LotteryResult<T> r = ahtt::lottery_fixed_point<T>(
      start + (size_t)lane * N * (D + 1), src + (size_t)lane * N * 2 * D,
      coef + (size_t)lane * N * 2 * D, P, d0 + (size_t)lane * DN,
      best_out + (size_t)lane * DN,
      scratch + (size_t)lane * ahtt::lottery_scratch_elems(D, N), red, D, N,
      tol, max_iter, accel_every);
  if (tid == 0) {
    iters_out[lane] = r.iters;
    diff_out[lane] = r.diff;
  }
}

template <typename T>
int launch(const void* start, const void* src, const void* coef,
           const void* P, const void* d0, void* best, void* iters, void* diff,
           void* scratch, int C, int D, int N, double tol, int max_iter,
           int accel_every, void* stream) {
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  stationary_lottery_kernel<T><<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)start, (const int*)src, (const T*)coef, (const T*)P,
      (const T*)d0, (T*)best, (int*)iters, (T*)diff, (T*)scratch, D, N,
      (T)tol, max_iter, accel_every);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stationary_lottery_grid_max_states() { return kMaxN; }

unsigned long long stationary_lottery_grid_scratch_elems(int D, int N) {
  return ahtt::lottery_scratch_elems(D, N);
}

int stationary_lottery_grid_f32(const void* start, const void* src,
                                const void* coef, const void* P,
                                const void* d0, void* best, void* iters,
                                void* diff, void* scratch, int C, int D,
                                int N, double tol, int max_iter,
                                int accel_every, void* stream) {
  return launch<float>(start, src, coef, P, d0, best, iters, diff, scratch,
                       C, D, N, tol, max_iter, accel_every, stream);
}

int stationary_lottery_grid_f64(const void* start, const void* src,
                                const void* coef, const void* P,
                                const void* d0, void* best, void* iters,
                                void* diff, void* scratch, int C, int D,
                                int N, double tol, int max_iter,
                                int accel_every, void* stream) {
  return launch<double>(start, src, coef, P, d0, best, iters, diff, scratch,
                        C, D, N, tol, max_iter, accel_every, stream);
}

}  // extern "C"
