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
// element [N, 2D] -- the source's d N + n in the flattened [D, N] iterate
// -- and coefficient [N, 2D]), stable in contribution order: for each
// target, all left-neighbour shares in source order, then all
// right-neighbour shares in source order (ops.kernels.lottery_csr).  Each
// target sums its sources from 0 in that order: no float atomics, so a
// lane's bits depend neither on its batchmates nor on the run.  Two
// neighbouring threads share a target row: each sums the sources of half
// the states, a shuffle swaps the sums, and each mixes half the next
// states over all states in order, so the [D, N] x [N, N] labor mix runs
// in registers right after the gather.
//
// What bounds it on an H100: neither bytes nor FLOPs but the chain of
// thousands of steps in one SM, each at D=500, N=7 some 3.5 k outputs
// gathered and mixed (about 60 k flops and a few thousand shared-memory
// loads) and one block-wide max.  The design keeps that chain on chip and
// short.  Where the lane fits one block's shared memory (the wrappers
// decide by size, from the byte counts below), the CSR, the transposed
// transition and the three iterates (current, previous, next) sit in
// shared memory for the whole loop, and the best iterate too when it fits,
// else in the output; the kernels are compiled once per layout, so the
// compiler addresses shared memory as such.  A plain step holds one
// barrier (the residual's max, its buffer alternating between steps).  The
// Aitken dot products and the renormalisation are common.cuh's
// buffer-free pairwise sums (registers and warp shuffles, one barrier
// each), the same tree as household.pairwise_sum.  Where the lane does not
// fit (the fine width), the same code runs on global pointers, with the
// same bits.
#pragma once

#include "common.cuh"

namespace ahtt {

constexpr int kLotteryMaxN = 16;
constexpr int kStallWindow = 512;

// Shared scratch of the loop, in elements of T: two alternating buffers
// for the residual's reduction and three for the Aitken sums.
__host__ __device__ constexpr int lottery_red_elems(int threads) {
  return 5 * (threads / 32);
}

// Bytes of the transition, transposed and padded to [kLotteryMaxN,
// kLotteryMaxN]: the labor mix then reads each next state's coefficients
// contiguously, 16-byte aligned, at offsets known at compile time.
template <typename T>
__host__ __device__ constexpr size_t lottery_p_bytes() {
  return (size_t)kLotteryMaxN * kLotteryMaxN * sizeof(T);
}

// Bytes of a lane's lottery and transition in shared memory, 16-byte
// aligned: the padded P and coefficient [N, 2D] in T, then start
// [N, D+1] and source element [N, 2D] in int.
template <typename T>
__host__ __device__ inline size_t lottery_csr_bytes(int D, int N) {
  const size_t b = lottery_p_bytes<T>() + 2 * (size_t)D * N * sizeof(T)
                   + ((size_t)N * (D + 1) + 2 * (size_t)D * N) * sizeof(int);
  return (b + 15) / 16 * 16;
}

// Bytes of the iterates (current, previous, next), and the best one.
template <typename T>
__host__ __device__ inline size_t lottery_iterate_bytes(int D, int N,
                                                        bool best) {
  return (best ? 4 : 3) * (size_t)D * N * sizeof(T);
}

// The lottery_csr_bytes region at `base`.
template <typename T>
struct LotteryCsr {
  T* Pt;    // Pt[n2][n] = P[n][n2], padded to [kLotteryMaxN, kLotteryMaxN]
  T* cf;
  int* st;
  int* se;
  __device__ LotteryCsr(unsigned char* base, int D, int N) {
    Pt = reinterpret_cast<T*>(base);
    cf = Pt + kLotteryMaxN * kLotteryMaxN;
    st = reinterpret_cast<int*>(cf + 2 * D * N);
    se = st + N * (D + 1);
  }
};

// Copy a lane's [N, N] transition into the padded transpose Pt (the
// block's threads share the work; the caller orders it before any read).
template <typename T>
__device__ __forceinline__ void load_transition(T* Pt, const T* P_l, int N) {
  for (int j = threadIdx.x; j < N * N; j += blockDim.x)
    Pt[(j % N) * kLotteryMaxN + j / N] = P_l[j];
}

template <typename T>
struct LotteryResult {
  int iters;
  T diff;   // the best residual, or the last one when that was non-finite
};

// Every thread of the block must call it (N <= NB <= kLotteryMaxN, NB
// even, blockDim.x a power of two).  `st`, `se`, `cf` are the lane's CSR,
// `Pt` its transition as load_transition lays it out (16-byte aligned),
// `d0l` its initial distribution [D, N]; `iter3` holds the three iterates
// [3, D, N]; the best iterate is kept in `best_d` [D, N] and copied to
// `best_out` at the end when the two differ.  `red` is shared scratch of
// lottery_red_elems(blockDim.x) elements.
template <typename T, int NB>
__device__ LotteryResult<T> lottery_fixed_point(
    const int* st, const int* se, const T* cf, const T* Pt, const T* d0l,
    T* iter3, T* best_d, T* best_out, T* red, int D, int N, T tol,
    int max_iter, int accel_every) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int DN = D * N;
  const int D2 = 2 * D;
  T* cur = iter3;
  T* prv = cur + DN;
  T* nw = prv + DN;
  T* const sum_part = red + 2 * nwarps;   // [3, nwarps]: Aitken sums
  // the pairwise sums' chunks: nt threads own L contiguous leaves each
  const int p = next_pow2(DN);
  const int nt = p < nthr ? p : nthr;
  const int L = p / nt;
  const int lo = tid * L;

  for (int j = tid; j < DN; j += nthr) {
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
    // push-forward: two neighbouring threads share a target row.  Thread
    // h of the pair sums the sources of the states n = h, h+2, ... (each
    // from 0 in CSR order), the pair swaps those sums, and thread h mixes
    // the next states n2 = h, h+2, ..., each over all states in order
    T dl = T(0);
    const int h = tid & 1;
    for (int base = 0; base < D; base += nthr >> 1) {
      const int r = base + (tid >> 1);
      const int t = r < D ? r : D - 1;   // every lane takes the shuffles
      T own[NB / 2];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        const int n = 2 * i + h;
        T acc = T(0);
        if (n < N) {
          const int* sen = se + n * D2;
          const T* cfn = cf + n * D2;
          const int k1 = st[n * (D + 1) + t + 1];
          for (int k = st[n * (D + 1) + t]; k < k1; ++k)
            acc = acc + mul(cur[sen[k]], cfn[k]);
        }
        own[i] = acc;
      }
      T acc[NB];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        const T other = __shfl_xor_sync(0xffffffffu, own[i], 1);
        acc[2 * i] = h == 0 ? own[i] : other;
        acc[2 * i + 1] = h == 0 ? other : own[i];
      }
      if (r < D) {
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) {
          const int n2 = 2 * i + h;
          if (n2 < N) {
            const T* pr = Pt + n2 * kLotteryMaxN;   // P[., n2], aligned
            T o = mul(acc[0], pr[0]);
#pragma unroll
            for (int n = 1; n < NB; ++n)
              if (n < N) o = o + mul(acc[n], pr[n]);
            const int j = t * N + n2;
            nw[j] = o;
            dl = nan_max(dl, (T)fabs(o - cur[j]));
          }
        }
      }
    }
    // the step's one barrier: every row of `nw` is written, and the
    // buffer alternates, so no thread still reads the one written here
    const T d = block_max_fresh(dl, red + (it & 1) * nwarps);
    // best certified iterate: every step certifies `nw` (own elements; the
    // barrier above ordered every write of `nw`)
    const bool improved = d < best;
    if (improved)
      for (int j = tid; j < DN; j += nthr) best_d[j] = nw[j];
    const bool accel = accel_every > 0 && ((it + 1) % accel_every) == 0;
    if (accel && d <= tol) {
      // converged on the plain step: the loop exits carrying it
      T* oc = cur; cur = nw; nw = oc;
    } else if (accel) {
      // Aitken rate <d2,d1> / max(<d1,d1>, tiny), each dot the pairwise
      // tree over the flattened [D, N] iterate
      T num = T(0), den = T(0);
      if (tid < nt) {
        num = chunk_pairwise<T>([&](int j) {
          return j < DN ? mul(nw[j] - cur[j], cur[j] - prv[j]) : T(0);
        }, lo, L);
        den = chunk_pairwise<T>([&](int j) {
          if (j >= DN) return T(0);
          const T d1 = cur[j] - prv[j];
          return mul(d1, d1);
        }, lo, L);
      }
      num = tree_combine(num, nt, sum_part);
      den = tree_combine(den, nt, sum_part + nwarps);
      T lam = num / nan_max(den, tiny);
      lam = lam < T(0) ? T(0) : lam;    // clip keeps NaN
      lam = lam > lam_max ? lam_max : lam;
      const T fac = lam / (T(1) - lam);
      // extrapolate into the previous iterate's slots (own chunk; every
      // thread has read them before the barriers above), then renormalise
      T tot = T(0);
      if (tid < nt)
        tot = chunk_pairwise<T>([&](int j) {
          if (j >= DN) return T(0);
          T e = nw[j] + mul(fac, nw[j] - cur[j]);
          e = e < T(0) ? T(0) : e;
          prv[j] = e;
          return e;
        }, lo, L);
      tot = tree_combine(tot, nt, sum_part + 2 * nwarps);
      if (tid < nt)
        for (int j = lo; j < lo + L && j < DN; ++j) prv[j] = prv[j] / tot;
      __syncthreads();
      // dist <- extrapolation, prev <- new, old dist is free
      T* oc = cur; cur = prv; prv = nw; nw = oc;
    } else {
      // dist <- new, prev <- dist, old prev is free
      T* op = prv; prv = cur; cur = nw; nw = op;
    }
    best = (d != d || d < best) ? d : best;
    since = improved ? 0 : since + 1;
    diff = d;
    ++it;
    finite = isfinite(d);
  }
  if (best_out != best_d)   // own elements, written by this thread or
    for (int j = tid; j < DN; j += nthr)   // before the first barrier
      best_out[j] = best_d[j];
  // the best residual, unless the last step was non-finite: then the
  // status rebuilt from (iters, diff) must read NONFINITE
  return LotteryResult<T>{it, isfinite(diff) ? best : diff};
}

}  // namespace ahtt
