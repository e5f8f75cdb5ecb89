// The stationary-distribution fixed point of the Young-lottery
// push-forward as block-level device code, shared by
// stationary_lottery_grid.cu and fused_cell_grid.cu.
//
// One thread block runs one lane.  The iteration is models/household.py's
// accelerated_distribution_fixed_point: an Aitken extrapolation every
// `accel_every` steps (clipped at 0, renormalised by a pairwise sum), the
// 512-step stall exit, and the best certified iterate as the result.
//
// The lottery comes as a CSR per labor state n (start [N, D+1], source
// row [N, 2D], coefficient [N, 2D]), stable in contribution order: for
// each target, all left-neighbour shares in source order, then all
// right-neighbour shares in source order (ops.kernels.lottery_csr).  Each
// target sums its sources from 0 in that order: no float atomics, so a
// lane's bits depend neither on its batchmates nor on the run.  A thread
// owns whole rows t, so the [D, N] x [N, N] labor mix runs in registers
// right after the gather.  The iterates (current, previous, next) and the
// pairwise-sum buffers live in the lane's global scratch, the best
// iterate in the output.
#pragma once

#include "common.cuh"

namespace ahtt {

constexpr int kLotteryMaxN = 16;
constexpr int kStallWindow = 512;

// Scratch elements one lane needs: three iterates and the two pairwise-sum
// buffers.
__host__ __device__ inline size_t lottery_scratch_elems(int D, int N) {
  const size_t dn = (size_t)D * N;
  const size_t p = (size_t)next_pow2((int)dn);
  return 3 * dn + p + p / 2;
}

template <typename T>
struct LotteryResult {
  int iters;
  T diff;   // the best residual, or the last one when that was non-finite
};

// Every thread of the block must call it (N <= kLotteryMaxN).  `st`, `sr`,
// `cf` are the lane's CSR, `P` its [N, N] transition, `d0l` its initial
// distribution [D, N]; the best iterate goes to `best_d` [D, N].  `red`
// is shared scratch of blockDim.x / 32 elements.
template <typename T>
__device__ LotteryResult<T> lottery_fixed_point(
    const int* st, const int* sr, const T* cf, const T* P, const T* d0l,
    T* best_d, T* scratch_l, T* red, int D, int N, T tol, int max_iter,
    int accel_every) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t DN = (size_t)D * N;
  const int D2 = 2 * D;
  T* cur = scratch_l;
  T* prv = cur + DN;
  T* nw = prv + DN;
  T* tree_a = nw + DN;                     // pairwise-sum buffers
  T* tree_b = tree_a + next_pow2((int)DN);

  for (size_t j = tid; j < DN; j += nthr) {
    const T v = d0l[j];
    cur[j] = v; prv[j] = v; best_d[j] = v;
  }
  const T tiny = Limits<T>::tiny();
  const T big = Limits<T>::big();
  const T lam_max = T(0.995);
  __syncthreads();

  T diff = big, best = big;
  int it = 0, since = 0;
  bool finite = true;
  while (diff > tol && it < max_iter && since < kStallWindow && finite) {
    // push-forward: gather each target's lottery sources, then mix states
    T dl = T(0);
    for (int t = tid; t < D; t += nthr) {
      T mv[kLotteryMaxN];
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
    const T d = block_reduce(dl, red, MaxOp());
    // best certified iterate: every step certifies `nw`
    const bool improved = d < best;
    if (improved)
      for (int t = tid; t < D; t += nthr)
        for (int n = 0; n < N; ++n)
          best_d[(size_t)t * N + n] = nw[(size_t)t * N + n];
    const bool accel = accel_every > 0 && ((it + 1) % accel_every) == 0;
    if (accel) {
      // Aitken rate <d2,d1> / max(<d1,d1>, tiny), each dot a pairwise
      // tree sum over the flattened [D, N] iterate
      for (int t = tid; t < D; t += nthr)
        for (int n = 0; n < N; ++n) {
          const size_t j = (size_t)t * N + n;
          tree_a[j] = (nw[j] - cur[j]) * (cur[j] - prv[j]);
        }
      const T num = tree_sum(tree_a, tree_b, (int)DN);
      for (int t = tid; t < D; t += nthr)
        for (int n = 0; n < N; ++n) {
          const size_t j = (size_t)t * N + n;
          const T d1 = cur[j] - prv[j];
          tree_a[j] = d1 * d1;
        }
      const T den = tree_sum(tree_a, tree_b, (int)DN);
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
        const T tot = tree_sum(tree_a, tree_b, (int)DN);
        for (int t = tid; t < D; t += nthr)
          for (int n = 0; n < N; ++n)
            prv[(size_t)t * N + n] = prv[(size_t)t * N + n] / tot;
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
  // the best residual, unless the last step was non-finite: then the
  // status rebuilt from (iters, diff) must read NONFINITE
  return LotteryResult<T>{it, isfinite(diff) ? best : diff};
}

}  // namespace ahtt
