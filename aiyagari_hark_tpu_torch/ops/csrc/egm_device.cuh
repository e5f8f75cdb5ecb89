// The EGM policy fixed point as device code, shared by egm_policy_grid.cu
// and fused_cell_grid.cu.
//
// The iteration is models/household.py's egm_step under
// accelerated_policy_fixed_point: Anderson(1) extrapolation of both knot
// fields every `accel_every` steps, rejected when it breaks strict knot
// monotonicity or consumption positivity; the loop returns the last plain
// iterate, which its sup-norm diff certifies.  With `tail` set (compact
// grids) each step's A+1 knots are closed by the two-knot analytic tail
// (household._append_analytic_tail_knots), so the policy has K = A+3 knots
// and the extrapolation and its checks cover all of them, in one block or
// in a cluster: a state's tail reads only that state's knots, so each
// block closes the states it holds.
//
// Who runs a lane:
//  - one thread block (kCluster = false) holding all N labor states, its
//    workspace in shared memory or, when that does not fit or the caller
//    forces it, in global memory (the kernels are compiled once per
//    layout, so each is addressed as what it is);
//  - a thread-block cluster (kCluster = true) of G <= 8 blocks, block r
//    holding the states [r S, r S + S) with S = ceil(N / 8): its three
//    iterates, its rows of the marginal values and copies of a, levels,
//    P, h, all in its own shared memory.  egm_policy_grid launches
//    egm_cluster_blocks(N) blocks; fused_cell_grid's cluster has 8
//    whatever N, and a block past the states holds none and only joins
//    the barriers and the sums.  The
//    expectation reads the other blocks' marginal-value rows through
//    distributed shared memory, a thread taking whole assets so that each
//    load serves both held states; the sup-norm, the Aitken sums and the
//    extrapolation's check are combined across the cluster.  Every block
//    computes the same diff, step count and exit decision, bit for bit.
//
// A plain step holds two barriers (three with the tail): one after the
// marginal values; with the tail, a block barrier before each held state
// is closed (its top knots are other threads' writes); one that ends the
// step, the sup-norm's max into alternating buffers, which also publishes
// the new knots.  The
// expectation, the FOC inversion, the new knots and their distance to the
// current ones are one pass, each thread on the knots it writes.  The
// three iterates rotate by index, never by copy.  An Aitken step adds the
// two pairwise sums (common.cuh's chunk_pairwise and tree_combine,
// registers and shuffles, the tree of household.pairwise_sum) and the
// check's vote.  Each thread computes the marginal values of a run of
// assets for one next state: it finds its first bracket by binary search
// and walks the bracket forward as the query R a_i + W l rises, which
// gives searchsorted(right) exactly on a non-decreasing row of knots (the
// EGM step keeps every row increasing, and an extrapolation is accepted
// only when strictly monotone; torch.searchsorted is undefined on an
// unsorted row).  With R < 0 or NaN the queries need not rise, and every
// query takes the binary search.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace ahtt {

namespace cg = cooperative_groups;

constexpr double kTailSlopeBlend = 0.75;   // household.TAIL_SLOPE_BLEND
constexpr int kEgmClusterMax = 8;          // the portable cluster size
constexpr int kEgmClusterMaxN = 16;        // labor states a cluster holds

// Labor states per block of a cluster lane, and the cluster's blocks.
__host__ __device__ inline int egm_cluster_states(int N) {
  return (N + kEgmClusterMax - 1) / kEgmClusterMax;
}
__host__ __device__ inline int egm_cluster_blocks(int N) {
  const int S = egm_cluster_states(N);
  return (N + S - 1) / S;
}

// Elements of T in one block's EGM workspace, for S labor states held of
// a lane with N states, A assets and K knots: three iterates of two
// fields [2, S, K] each, the marginal values [S, A], and the lane's a [A],
// levels [N], P [N, N] and human wealth h [N].
__host__ __device__ inline size_t egm_workspace_elems(int S, int N, int A,
                                                      int K) {
  return 6 * (size_t)S * K + (size_t)S * A + A + 2 * (size_t)N
         + (size_t)N * N;
}

// Shared scratch of the loop, in elements of T: two alternating buffers
// for the sup-norm's max, two for the Aitken sums, and (clusters) three
// slots the other blocks read.
__host__ __device__ constexpr int egm_red_elems(int threads) {
  return 4 * (threads / 32) + 3;
}

template <typename T>
struct EgmWorkspace {
  T *it, *vp, *a, *lvl, *P, *h;   // it: the iterates [3][2][S][K]
  __device__ EgmWorkspace(T* ws, int S, int N, int A, int K) {
    it = ws;
    vp = it + 6 * S * K;
    a = vp + S * A;
    lvl = a + A;
    P = lvl + N;
    h = P + N * N;
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
  const T s_bar = nan_min(nan_max(kap + mul(T(kTailSlopeBlend), s_loc - kap),
                                  kap), T(1));
  const T m1 = m_top + span;
  T c1 = nan_min(c_top + mul(s_bar, span), mul(kap, m1 + h));
  c1 = nan_max(c1, c_top + mul(kap, span));   // monotone floor
  m[A + 1] = m1;
  c[A + 1] = c1;
  m[A + 2] = m1 + span;
  c[A + 2] = c1 + mul(kap, span);
}

template <typename T>
struct EgmResult {
  int iters;
  T diff;
  const T* m;   // the certified knots of the states held, [S, K] ...
  const T* c;   // ... each, in this block's workspace
};

// The index of an iterate buffer that is neither `a` nor `b`.
__device__ __forceinline__ int egm_other(int a, int b) {
  return a != b ? 3 - a - b : (a + 1) % 3;
}

// Run one lane's fixed point.  Every thread of the block (of every block
// of the cluster) must call it; every thread gets the same result.  `w`
// is this block's workspace for S states, `red` shared scratch of
// egm_red_elems(blockDim.x) elements; the initial knots m0l, c0l [N, K]
// and a_l, lvl_l, P_l, s, h_l are the lane's inputs in global memory
// (`h_l` is read only with `tail`).  The tail's slope `kap` comes from
// the lane's scalars alone, so every block of a cluster computes the same.
template <typename T, bool kCluster>
__device__ EgmResult<T> egm_fixed_point(
    const EgmWorkspace<T>& w, T* red, const T* m0l, const T* c0l,
    const T* a_l, const T* lvl_l, const T* P_l, const T* s, const T* h_l,
    int S, int N, int A, bool tail, T tol, int max_iter, int accel_every) {
  const int K = A + (tail ? 3 : 1);
  const int NK = N * K;
  const int fs = S * K;                 // a field's stride in an iterate
  const int bs = 2 * fs;                // an iterate's stride
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int lane = tid & 31;
  int rank = 0, G = 1;
  if constexpr (kCluster) {
    rank = (int)cg::this_cluster().block_rank();
    G = (int)cg::this_cluster().num_blocks();
  }
  const int s0 = rank * S;              // the states held: [s0, s0 + ns)
  const int ns = N - s0 < S ? (N > s0 ? N - s0 : 0) : S;
  T* const it = w.it;
  T* const vp = w.vp;
  const T* const a = w.a;
  const T* const lvl = w.lvl;
  const T* const P = w.P;
  T* const sum_part = red + 2 * nwarps;   // [2, nwarps]: the Aitken sums
  T* const slot = red + 4 * nwarps;       // [3]: read by the other blocks

  for (int j = tid; j < ns * K; j += nthr) {
    it[j] = m0l[s0 * K + j];
    it[fs + j] = c0l[s0 * K + j];
  }
  for (int j = tid; j < A; j += nthr) w.a[j] = a_l[j];
  for (int j = tid; j < N; j += nthr) {
    w.lvl[j] = lvl_l[j];
    w.h[j] = tail ? h_l[j] : T(0);
  }
  for (int j = tid; j < N * N; j += nthr) w.P[j] = P_l[j];

  // a cluster's view of its peers: each state's marginal-value row and
  // each block's iterates, through distributed shared memory
  __shared__ T* vrow[kCluster ? kEgmClusterMaxN : 1];
  __shared__ T* peer[kCluster ? kEgmClusterMax : 1];
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    if (tid < N) vrow[tid] = cl.map_shared_rank(vp, tid / S) + (tid % S) * A;
    if (tid < G) peer[tid] = cl.map_shared_rank(it, tid);
  }

  const T R = s[0], W = s[1], beta = s[2], gam = s[3], b = s[4];
  const T ngam = -gam;
  const T ninv = T(-1) / gam;
  const T bR = mul(beta, R);
  const T eps = T(1e-7);
  const T tiny = Limits<T>::tiny();
  const T big = Limits<T>::big();
  const T lam_max = T(0.995);
  // the tail's slope: ops.utility.asymptotic_mpc, clipped to [1e-3, 0.999]
  T kap = T(1) - tpow(bR, T(1) / gam) / R;
  kap = nan_min(nan_max(kap, T(1e-3)), T(0.999));
  const bool walk = R >= T(0);          // the queries rise with the asset
  // phase A's share: runs of `run` assets, `rps` runs per held state
  const int rps = ns > 0 && nthr / ns > 0 ? nthr / ns : 1;
  const int run = (A + rps - 1) / rps;
  // the Aitken sums' leaves: nt threads (a power of two, from the first
  // nb blocks) own L contiguous leaves each of the 2 N K, m then c
  const int p = next_pow2(2 * NK);
  int gp = 1;
  while (2 * gp <= G) gp <<= 1;
  const int nt = p < nthr * gp ? p : nthr * gp;
  const int ntb = nt < nthr ? nt : nthr;
  const int nb = nt / ntb;
  const int L = p / nt;
  const int gtid = rank * nthr + tid;
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();

  // element j of the flattened [2, N, K] iterate `ix`, wherever it lives
  auto elem = [&](int ix, int j) -> T {
    if constexpr (kCluster) {
      const int f = j >= NK;
      const int jj = j - f * NK;
      const int st = jj / K;
      const int r = st / S;
      return peer[r][ix * bs + f * fs + (st - r * S) * K + (jj - st * K)];
    } else {
      return it[ix * bs + j];
    }
  };

  T diff = big;
  int step = 0;
  bool finite = true;
  int ic = 0, ip = 0, icert = 0;        // current, previous, certified
  while (diff > tol && step < max_iter && finite) {
    const int in = egm_other(ic, ip);   // the new iterate's buffer
    const T* cm = it + ic * bs;
    const T* cc = cm + fs;
    T* nm = it + in * bs;
    T* nc = nm + fs;
    // (A) vp[s', i] = u'(c(R a_i + W l_s')) on state s' knots, s' held
    for (int u = tid; u < ns * rps; u += nthr) {
      const int sl = u / rps;
      const int i0 = (u - sl * rps) * run;
      const int i1 = i0 + run < A ? i0 + run : A;
      const T* xp = cm + sl * K;
      const T* fp = cc + sl * K;
      const T wl = mul(W, lvl[s0 + sl]);
      int lo = 0;                        // searchsorted(side="right")
      for (int i = i0; i < i1; ++i) {
        const T x = mul(R, a[i]) + wl;
        if (i == i0 || !walk) {
          lo = 0;
          int hi = K;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (xp[mid] <= x) lo = mid + 1; else hi = mid;
          }
        } else {
          while (lo < K && xp[lo] <= x) ++lo;
        }
        int k = lo - 1;
        k = k < 0 ? 0 : (k > K - 2 ? K - 2 : k);
        const T x0 = xp[k], f0 = fp[k];
        const T slope = (fp[k + 1] - f0) / (xp[k + 1] - x0);
        vp[sl * A + i] = tpow(f0 + mul(slope, x - x0), ngam);
      }
    }
    if constexpr (kCluster) cg::this_cluster().sync();
    else __syncthreads();
    // (B) expectation over next states in state order, FOC inversion,
    // the new knots and their distance to the current ones
    T dl = T(0);
    auto knot = [&](int sl, int i, T e) {
      const T cn = tpow(mul(bR, e), ninv);
      const T mn = a[i] + cn;
      const int q = sl * K + i + 1;
      nc[q] = cn;
      nm[q] = mn;
      dl = nan_max(dl, (T)fabs(mn - cm[q]));
      dl = nan_max(dl, (T)fabs(cn - cc[q]));
    };
    if constexpr (kCluster) {
      // a thread takes whole assets: the N remote loads of vp[., i] are
      // issued in groups of 8 and serve both held states (S <= 2)
      for (int i = tid; i < A; i += nthr) {
        T e[2] = {T(0), T(0)};
#pragma unroll
        for (int g = 0; g < kEgmClusterMaxN; g += 8) {
          T v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = g + q < N ? vrow[g + q][i] : T(0);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int sp = g + q;
#pragma unroll
            for (int sl = 0; sl < 2; ++sl) {
              if (sp < N && sl < ns) {
                const T t = mul(P[(s0 + sl) * N + sp], v[q]);
                e[sl] = sp == 0 ? t : e[sl] + t;
              }
            }
          }
        }
#pragma unroll
        for (int sl = 0; sl < 2; ++sl)
          if (sl < ns) knot(sl, i, e[sl]);
      }
    } else {
      for (int j = tid; j < ns * A; j += nthr) {
        const int sl = j / A;
        const int i = j - sl * A;
        const T* Pr = P + (s0 + sl) * N;
        T e = mul(Pr[0], vp[i]);
        for (int sp = 1; sp < N; ++sp) e = e + mul(Pr[sp], vp[sp * A + i]);
        knot(sl, i, e);
      }
    }
    for (int sl = tid; sl < ns; sl += nthr) {
      const int q = sl * K;
      nc[q] = eps;
      nm[q] = b + eps;
      dl = nan_max(dl, (T)fabs(nm[q] - cm[q]));
      dl = nan_max(dl, (T)fabs(nc[q] - cc[q]));
    }
    if (tail) {                         // each block closes its states
      __syncthreads();
      for (int sl = tid; sl < ns; sl += nthr) {
        T* m = nm + sl * K;
        T* c = nc + sl * K;
        close_tail(m, c, A, kap, w.h[s0 + sl]);
        for (int k = A + 1; k < K; ++k) {
          dl = nan_max(dl, (T)fabs(m[k] - cm[sl * K + k]));
          dl = nan_max(dl, (T)fabs(c[k] - cc[sl * K + k]));
        }
      }
    }
    // (C) the sup-norm over both fields: the step's closing barrier
    T d;
    T* mx = red + (step & 1) * nwarps;
    if constexpr (kCluster) {
      for (int o = 16; o > 0; o >>= 1)
        dl = nan_max(dl, __shfl_xor_sync(0xffffffffu, dl, o));
      if (lane == 0) mx[tid >> 5] = dl;
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      d = T(0);
      for (int q = lane; q < G * nwarps; q += 32)
        d = nan_max(d, cl.map_shared_rank(mx, q / nwarps)[q % nwarps]);
      for (int o = 16; o > 0; o >>= 1)
        d = nan_max(d, __shfl_xor_sync(0xffffffffu, d, o));
    } else {
      d = block_max_fresh(dl, mx);
    }
    const bool accel = accel_every > 0 && ((step + 1) % accel_every) == 0;
    if (accel && d > tol) {
      // Anderson rate over both fields, flattened m then c:
      // <d2,d1> / max(<d1,d1>, tiny), each dot the pairwise tree
      T num = T(0), den = T(0);
      if (gtid < nt) {
        const int lo = gtid * L;
        num = chunk_pairwise<T>([&](int j) {
          if (j >= 2 * NK) return T(0);
          const T c = elem(ic, j);
          return mul(elem(in, j) - c, c - elem(ip, j));
        }, lo, L);
        den = chunk_pairwise<T>([&](int j) {
          if (j >= 2 * NK) return T(0);
          const T d1 = elem(ic, j) - elem(ip, j);
          return mul(d1, d1);
        }, lo, L);
      }
      num = tree_combine(num, ntb, sum_part);
      den = tree_combine(den, ntb, sum_part + nwarps);
      if constexpr (kCluster) {
        // the blocks' subtrees join in rank order, as the tree does
        if (tid == 0) {
          slot[0] = num;
          slot[1] = den;
        }
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        T u = lane < nb ? cl.map_shared_rank(slot, lane)[0] : T(0);
        T v = lane < nb ? cl.map_shared_rank(slot, lane)[1] : T(0);
        u = warp_tree(u, nb);
        v = warp_tree(v, nb);
        num = __shfl_sync(0xffffffffu, u, 0);
        den = __shfl_sync(0xffffffffu, v, 0);
      }
      T lam = num / nan_max(den, tiny);
      lam = lam < T(0) ? T(0) : lam;    // clip keeps NaN
      lam = lam > lam_max ? lam_max : lam;
      const T fac = lam / (T(1) - lam);
      // the extrapolation, into the buffer that is neither the current
      // nor the new iterate (every read of it ended at the barriers
      // above); each thread checks its own knots, recomputing the right
      // neighbour's extrapolated m
      const int ie = 3 - ic - in;
      T* em = it + ie * bs;
      bool ok = true;
      for (int j = tid; j < ns * K; j += nthr) {
        const T xm = nm[j] + mul(fac, nm[j] - cm[j]);
        const T xc = nc[j] + mul(fac, nc[j] - cc[j]);
        em[j] = xm;
        em[fs + j] = xc;
        if (j % K < K - 1
            && !(nm[j + 1] + mul(fac, nm[j + 1] - cm[j + 1]) > xm))
          ok = false;
        if (!(xc > T(0))) ok = false;
      }
      ok = __syncthreads_and(ok);
      if constexpr (kCluster) {
        if (tid == 0) slot[2] = ok ? T(1) : T(0);
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        for (int r = 0; r < G; ++r)
          ok = ok && cl.map_shared_rank(slot, r)[2] != T(0);
      }
      // policy <- extrapolation if accepted, else new; previous <- new
      ic = ok ? ie : in;
      ip = in;
    } else {
      ip = ic;                          // previous <- policy <- new
      ic = in;
    }
    icert = in;
    diff = d;
    ++step;
    finite = isfinite(d);
  }
  const T* km = it + icert * bs;
  return EgmResult<T>{step, diff, km, km + fs};
}

}  // namespace ahtt
