// The EGM policy fixed point as block-level device code, shared by
// egm_policy_grid.cu and fused_cell_grid.cu.
//
// One thread block runs one lane.  The iteration is models/household.py's
// egm_step under accelerated_policy_fixed_point: Anderson(1) extrapolation
// of both knot fields every `accel_every` steps, rejected when it breaks
// strict knot monotonicity or consumption positivity; the loop returns the
// last plain iterate, which its sup-norm diff certifies.  With `tail` set
// (compact grids) each step's A+1 knots are closed by the two-knot
// analytic tail (household._append_analytic_tail_knots), so the policy has
// K = A+3 knots and the extrapolation and its checks cover all of them.
//
// Memory: every array the loop touches lives in the lane's workspace
// `ws`, which the kernel points at dynamic shared memory when it fits one
// block's share and at a wrapper-allocated global scratch otherwise (the
// fine grid, A=1000 and N=15, needs 1.2 MB in f64).  Both layouts run the
// same index arithmetic under the same barriers (__syncthreads orders the
// block's global accesses as it orders its shared ones), so they agree
// bitwise.
#pragma once

#include "common.cuh"

namespace ahtt {

constexpr double kTailSlopeBlend = 0.75;   // household.TAIL_SLOPE_BLEND

// Elements of T in one lane's EGM workspace: three iterates (policy,
// previous, new) x two fields of N*K knots, the marginal values [N, A],
// the lane's a [A], levels [N], P [N, N] and human wealth h [N], and the
// two pairwise-sum buffers.
__host__ __device__ inline size_t egm_workspace_elems(int N, int A, int K) {
  const size_t nk = (size_t)N * K;
  const size_t p = (size_t)next_pow2(2 * N * K);
  return 6 * nk + (size_t)N * A + A + 2 * (size_t)N + (size_t)N * N + p
         + p / 2;
}

template <typename T>
struct EgmWorkspace {
  T *pol_m, *pol_c, *prv_m, *prv_c, *new_m, *new_c, *vp, *a, *lvl, *P, *h,
      *tree_a, *tree_b;
  __device__ EgmWorkspace(T* ws, int N, int A, int K) {
    const int NK = N * K;
    pol_m = ws;
    pol_c = pol_m + NK;
    prv_m = pol_c + NK;
    prv_c = prv_m + NK;
    new_m = prv_c + NK;
    new_c = new_m + NK;
    vp = new_c + NK;
    a = vp + N * A;
    lvl = a + A;
    P = lvl + N;
    h = P + N * N;
    tree_a = h + N;
    tree_b = tree_a + next_pow2(2 * NK);
  }
};

// finfo(float64).tiny in T, the tail's slope guard: in float32 the cast
// underflows to 0 (the JAX package's constant), not FLT_MIN.
template <typename T> __device__ __forceinline__ T f64_tiny_as();
template <> __device__ __forceinline__ double f64_tiny_as<double>() {
  return DBL_MIN;
}
template <> __device__ __forceinline__ float f64_tiny_as<float>() {
  return 0.0f;
}

// Close one state's knots m, c [A+3] (A+1 computed) with the analytic
// tail, in household._append_analytic_tail_knots's operations and order.
template <typename T>
__device__ __forceinline__ void close_tail(T* m, T* c, int A, T kap, T h) {
  const T m_top = m[A], c_top = c[A];
  const T span = nan_max(m_top - m[0], T(1));
  const T s_loc = (c_top - c[A - 1]) / nan_max(m_top - m[A - 1],
                                               f64_tiny_as<T>());
  const T s_bar = nan_min(nan_max(kap + T(kTailSlopeBlend) * (s_loc - kap),
                                  kap), T(1));
  const T m1 = m_top + span;
  T c1 = nan_min(c_top + s_bar * span, kap * (m1 + h));
  c1 = nan_max(c1, c_top + kap * span);   // monotone floor
  m[A + 1] = m1;
  c[A + 1] = c1;
  m[A + 2] = m1 + span;
  c[A + 2] = c1 + kap * span;
}

template <typename T>
struct EgmResult {
  int iters;
  T diff;
};

// Load one lane's constants and initial knots [N, K] into the workspace
// and run the fixed point.  Every thread of the block must call it; on
// return the certified knots are in w.new_m / w.new_c (the initial knots
// if no step ran) and every thread holds the same result.  `h_l` is read
// only with `tail`.  `red` is shared scratch of blockDim.x / 32 elements.
template <typename T>
__device__ EgmResult<T> egm_fixed_point(
    const EgmWorkspace<T>& w, T* red, const T* m0l, const T* c0l,
    const T* a_l, const T* lvl_l, const T* P_l, const T* s, const T* h_l,
    int N, int A, bool tail, T tol, int max_iter, int accel_every) {
  const int K = A + (tail ? 3 : 1);
  const int NK = N * K;
  const int NA = N * A;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  T* const pol_m = w.pol_m;
  T* const pol_c = w.pol_c;
  T* const prv_m = w.prv_m;
  T* const prv_c = w.prv_c;
  T* const new_m = w.new_m;
  T* const new_c = w.new_c;
  T* const vp = w.vp;
  T* const a = w.a;
  T* const lvl = w.lvl;
  T* const P = w.P;
  T* const h = w.h;

  for (int j = tid; j < NK; j += nthr) {
    const T m = m0l[j], c = c0l[j];
    pol_m[j] = m; prv_m[j] = m; new_m[j] = m;
    pol_c[j] = c; prv_c[j] = c; new_c[j] = c;
  }
  for (int j = tid; j < A; j += nthr) a[j] = a_l[j];
  for (int j = tid; j < N; j += nthr) {
    lvl[j] = lvl_l[j];
    h[j] = tail ? h_l[j] : T(0);
  }
  for (int j = tid; j < N * N; j += nthr) P[j] = P_l[j];

  const T R = s[0], W = s[1], beta = s[2], gam = s[3], b = s[4];
  const T ngam = -gam;
  const T ninv = T(-1) / gam;
  const T bR = beta * R;
  const T eps = T(1e-7);
  const T tiny = Limits<T>::tiny();
  const T big = Limits<T>::big();
  const T lam_max = T(0.995);
  // the tail's slope: ops.utility.asymptotic_mpc, clipped to [1e-3, 0.999]
  T kap = T(1) - tpow(beta * R, T(1) / gam) / R;
  kap = nan_min(nan_max(kap, T(1e-3)), T(0.999));
  __syncthreads();

  T diff = big;
  int it = 0;
  bool finite = true;
  while (diff > tol && it < max_iter && finite) {
    // (1) vp[s', i] = u'(c(R a_i + W l_s')) on state s' knots
    for (int j = tid; j < NA; j += nthr) {
      const int sp = j / A;
      const int i = j - sp * A;
      const T x = R * a[i] + W * lvl[sp];
      const T* xp = pol_m + sp * K;
      const T* fp = pol_c + sp * K;
      int lo = 0, hi = K;               // searchsorted(side="right")
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xp[mid] <= x) lo = mid + 1; else hi = mid;
      }
      int k = lo - 1;
      k = k < 0 ? 0 : (k > K - 2 ? K - 2 : k);
      const T x0 = xp[k], f0 = fp[k];
      const T slope = (fp[k + 1] - f0) / (xp[k + 1] - x0);
      vp[j] = tpow(f0 + slope * (x - x0), ngam);
    }
    __syncthreads();
    // (2) expectation over next states, FOC inversion, endogenous knots
    for (int j = tid; j < NA; j += nthr) {
      const int st = j / A;
      const int i = j - st * A;
      T e = P[st * N] * vp[i];
      for (int sp = 1; sp < N; ++sp) e = e + P[st * N + sp] * vp[sp * A + i];
      const T cn = tpow(bR * e, ninv);
      new_c[st * K + i + 1] = cn;
      new_m[st * K + i + 1] = a[i] + cn;
    }
    for (int st = tid; st < N; st += nthr) {
      new_c[st * K] = eps;
      new_m[st * K] = b + eps;
    }
    __syncthreads();
    if (tail) {
      for (int st = tid; st < N; st += nthr)
        close_tail(new_m + st * K, new_c + st * K, A, kap, h[st]);
      __syncthreads();
    }
    // (3) sup-norm over both fields
    T dl = T(0);
    for (int j = tid; j < NK; j += nthr) {
      dl = nan_max(dl, (T)fabs(new_m[j] - pol_m[j]));
      dl = nan_max(dl, (T)fabs(new_c[j] - pol_c[j]));
    }
    const T d = block_reduce(dl, red, MaxOp());
    const bool accel = accel_every > 0 && ((it + 1) % accel_every) == 0;
    if (accel) {
      // Anderson rate over both fields, flattened m then c:
      // <d2,d1> / max(<d1,d1>, tiny), each dot a pairwise tree sum
      for (int j = tid; j < NK; j += nthr) {
        w.tree_a[j] = (new_m[j] - pol_m[j]) * (pol_m[j] - prv_m[j]);
        w.tree_a[NK + j] = (new_c[j] - pol_c[j]) * (pol_c[j] - prv_c[j]);
      }
      const T num = tree_sum(w.tree_a, w.tree_b, 2 * NK);
      for (int j = tid; j < NK; j += nthr) {
        const T dm = pol_m[j] - prv_m[j];
        const T dc = pol_c[j] - prv_c[j];
        w.tree_a[j] = dm * dm;
        w.tree_a[NK + j] = dc * dc;
      }
      const T den = tree_sum(w.tree_a, w.tree_b, 2 * NK);
      T lam = num / nan_max(den, tiny);
      lam = lam < T(0) ? T(0) : lam;    // clip keeps NaN
      lam = lam > lam_max ? lam_max : lam;
      const T fac = lam / (T(1) - lam);
      // the extrapolation goes into the previous iterate's slots, which
      // the reductions above have finished reading
      for (int j = tid; j < NK; j += nthr) {
        prv_m[j] = new_m[j] + fac * (new_m[j] - pol_m[j]);
        prv_c[j] = new_c[j] + fac * (new_c[j] - pol_c[j]);
      }
      __syncthreads();
      bool ok = true;
      for (int j = tid; j < NK; j += nthr) {
        const int k = j % K;
        if (k < K - 1 && !(prv_m[j + 1] > prv_m[j])) ok = false;
        if (!(prv_c[j] > T(0))) ok = false;
      }
      ok = __syncthreads_and(ok) && (d > tol);
      for (int j = tid; j < NK; j += nthr) {
        pol_m[j] = ok ? prv_m[j] : new_m[j];
        pol_c[j] = ok ? prv_c[j] : new_c[j];
        prv_m[j] = new_m[j];
        prv_c[j] = new_c[j];
      }
    } else {
      for (int j = tid; j < NK; j += nthr) {
        prv_m[j] = pol_m[j];
        prv_c[j] = pol_c[j];
        pol_m[j] = new_m[j];
        pol_c[j] = new_c[j];
      }
    }
    __syncthreads();
    diff = d;
    ++it;
    finite = isfinite(d);
  }
  return EgmResult<T>{it, diff};
}

}  // namespace ahtt
