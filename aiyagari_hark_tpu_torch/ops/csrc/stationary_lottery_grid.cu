// stationary_lottery_grid: the stationary wealth distribution of the
// Young-lottery push-forward, one thread block per lane.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, stationary_dense_pallas
// (single lane, launched here with C = 1) and stationary_dense_pallas_grid
// (one program instance per lane).  The iteration is models/household.py's
// accelerated_distribution_fixed_point: an Aitken extrapolation every
// `accel_every` steps (clipped at 0, renormalised), the 512-step stall
// exit, and the best certified iterate as the result.
//
// The TPU kernel iterates the dense operator S [N, D, D] (about 7 MB per
// lane in f32 at D=500, N=7) resident in VMEM.  That is thirty times one
// SM's shared memory, so this kernel iterates the same Markov operator in
// the two-point form S is built from: for each labor state n and target
// gridpoint t, the wrapper lists the sources that land on t (a CSR built
// with a stable sort: all left-neighbour shares in source order, then all
// right-neighbour shares in source order -- the order in which the JAX
// scatter adds them).  Each target sums its sources in that fixed order:
// no float atomics, so a lane's bits do not depend on its batchmates or on
// the run.  A thread owns whole rows t, so the [D, N] x [N, N] labor mix
// runs in registers right after the gather.
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

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = 16;
constexpr int kStallWindow = 512;

// Scratch elements one lane needs: three iterates and the two
// pairwise-sum buffers.
__host__ __device__ inline size_t scratch_elems(int D, int N) {
  const size_t dn = (size_t)D * N;
  const size_t p = (size_t)ahtt::next_pow2((int)dn);
  return 3 * dn + p + p / 2;
}

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
  using ahtt::nan_max;
  __shared__ T P[kMaxN * kMaxN];
  __shared__ T red[kThreads / 32];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t DN = (size_t)D * N;
  const int D2 = 2 * D;
  const int* st = start + (size_t)lane * N * (D + 1);
  const int* sr = src + (size_t)lane * N * D2;
  const T* cf = coef + (size_t)lane * N * D2;
  T* cur = scratch + (size_t)lane * scratch_elems(D, N);
  T* prv = cur + DN;
  T* nw = prv + DN;
  T* tree_a = nw + DN;                     // pairwise-sum buffers
  T* tree_b = tree_a + ahtt::next_pow2((int)DN);
  T* best_d = best_out + (size_t)lane * DN;
  const T* d0l = d0 + (size_t)lane * DN;

  for (int j = tid; j < N * N; j += nthr) P[j] = P_g[(size_t)lane * N * N + j];
  for (size_t j = tid; j < DN; j += nthr) {
    const T v = d0l[j];
    cur[j] = v; prv[j] = v; best_d[j] = v;
  }
  const T tiny = ahtt::Limits<T>::tiny();
  const T big = ahtt::Limits<T>::big();
  const T lam_max = T(0.995);
  __syncthreads();

  T diff = big, best = big;
  int it = 0, since = 0;
  bool finite = true;
  while (diff > tol && it < max_iter && since < kStallWindow && finite) {
    // push-forward: gather each target's lottery sources, then mix states
    T dl = T(0);
    for (int t = tid; t < D; t += nthr) {
      T mv[kMaxN];
      for (int n = 0; n < N; ++n) {
        const int* stn = st + n * (D + 1);
        const int* srn = sr + n * D2;
        const T* cfn = cf + n * D2;
        T acc = T(0);
        for (int k = stn[t]; k < stn[t + 1]; ++k)
          acc = acc + cur[(size_t)srn[k] * N + n] * cfn[k];
        mv[n] = acc;
      }
      for (int n2 = 0; n2 < N; ++n2) {
        T acc = mv[0] * P[n2];
        for (int n = 1; n < N; ++n) acc = acc + mv[n] * P[n * N + n2];
        const size_t j = (size_t)t * N + n2;
        nw[j] = acc;
        dl = nan_max(dl, (T)fabs(acc - cur[j]));
      }
    }
    const T d = ahtt::block_reduce(dl, red, ahtt::MaxOp());
    // best certified iterate: every step certifies `nw`
    const bool improved = d < best;
    if (improved)
      for (int t = tid; t < D; t += nthr)
        for (int n = 0; n < N; ++n) best_d[(size_t)t * N + n] = nw[(size_t)t * N + n];
    const bool accel = accel_every > 0 && ((it + 1) % accel_every) == 0;
    if (accel) {
      // Aitken rate <d2,d1> / max(<d1,d1>, tiny), each dot a pairwise
      // tree sum over the flattened [D, N] iterate
      for (int t = tid; t < D; t += nthr)
        for (int n = 0; n < N; ++n) {
          const size_t j = (size_t)t * N + n;
          tree_a[j] = (nw[j] - cur[j]) * (cur[j] - prv[j]);
        }
      const T num = ahtt::tree_sum(tree_a, tree_b, (int)DN);
      for (int t = tid; t < D; t += nthr)
        for (int n = 0; n < N; ++n) {
          const size_t j = (size_t)t * N + n;
          const T d1 = cur[j] - prv[j];
          tree_a[j] = d1 * d1;
        }
      const T den = ahtt::tree_sum(tree_a, tree_b, (int)DN);
      T lam = num / nan_max(den, tiny);
      lam = lam < T(0) ? T(0) : lam;    // clip keeps NaN
      lam = lam > lam_max ? lam_max : lam;
      const T fac = lam / (T(1) - lam);
      if (d <= tol) {
        // converged on the plain step: the loop exits carrying it
        T* oc = cur; cur = nw; nw = oc;
      } else {
        // extrapolate into the previous iterate's rows (own rows only)
        for (int t = tid; t < D; t += nthr)
          for (int n = 0; n < N; ++n) {
            const size_t j = (size_t)t * N + n;
            T e = nw[j] + fac * (nw[j] - cur[j]);
            e = e < T(0) ? T(0) : e;
            prv[j] = e;
            tree_a[j] = e;
          }
        const T tot = ahtt::tree_sum(tree_a, tree_b, (int)DN);
        for (int t = tid; t < D; t += nthr)
          for (int n = 0; n < N; ++n) prv[(size_t)t * N + n] = prv[(size_t)t * N + n] / tot;
        // dist <- extrapolation, prev <- new, old dist is free
        T* oc = cur; cur = prv; prv = nw; nw = oc;
      }
    } else {
      // dist <- new, prev <- dist, old prev is free
      T* op = prv; prv = cur; cur = nw; nw = op;
    }
    best = (d != d || d < best) ? d : best;
    since = improved ? 0 : since + 1;
    diff = d;
    ++it;
    finite = isfinite(d);
    __syncthreads();
  }
  if (tid == 0) {
    iters_out[lane] = it;
    // the best residual, unless the last step was non-finite: then the
    // status rebuilt from (iters, diff) must read NONFINITE
    diff_out[lane] = isfinite(diff) ? best : diff;
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
  return scratch_elems(D, N);
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
