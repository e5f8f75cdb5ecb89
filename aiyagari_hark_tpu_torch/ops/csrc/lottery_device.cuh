// The stationary-distribution fixed point of the Young-lottery
// push-forward as device code, shared by stationary_lottery_grid.cu and
// fused_cell_grid.cu.
//
// The iteration is models/household.py's
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
// lane's bits depend neither on its batchmates nor on the run.
//
// Who runs a lane:
//  - one thread block (lottery_fixed_point) holding every row, its lottery
//    and iterates in shared memory where they fit (the wrappers decide by
//    size, from the byte counts below), else on global pointers.  Two
//    neighbouring threads share a target row: each sums the sources of
//    half the states, a shuffle swaps the sums, and each mixes half the
//    next states over all states in order, so the [D, N] x [N, N] labor
//    mix runs in registers right after the gather;
//  - a thread-block cluster (lottery_cluster_loop) of kLotteryClusterMax
//    blocks, block r owning the target rows
//    [r R, r R + R), R = ceil(D / 8), in every labor state: its rows of
//    the four iterates (current, previous, next, best) and its rows'
//    starts in its own shared memory, and its rows' lottery entries
//    staged there too when they fit the room the wrapper gives (counted
//    on the device from `start`, since the split depends on the policy),
//    else read where the wrapper built them.  Four threads share a row;
//    a source that another block owns is read through distributed shared
//    memory.  The residual's max, the Aitken sums and the renormalisation
//    combine across the cluster; every block computes the same diff,
//    rate, total, step count and exit, bit for bit.  The one-block loop is
//    kept apart: folded into one function, its global layout compiled to
//    a gather loop unrolled 4 times instead of 16 and ran 10-21 % slower
//    on the card.
//
// Each loop is compiled once per bound NB on the labor states (8, 16 or
// 32), its mix holding a row's N sums in registers, and once more for any
// N past 32 (NB = 0, the wide mix): a row's sums go once to a staging
// buffer in the lane's own memory (shared, or the global scratch), and
// each next state's value is formed from it in the order n = 0 ... N-1,
// the same products in the same order, so the same bits.  The transition
// is padded to NB (or N rounded up to 4) by the instantiation, never by
// the largest bound: a lane of 7 states keeps a pad of 8 x 8.
//
// What bounds it on an H100: neither bytes nor FLOPs but the chain of
// thousands of dependent steps, each at D=500, N=7 some 3.5 k outputs
// gathered and mixed (about 60 k flops and a few thousand shared-memory
// loads) and a max over them.  The design keeps that chain on chip and
// short: a plain step holds one barrier (block-wide, or the cluster's),
// the residual's max into buffers that alternate between steps.  The
// Aitken dot products and the renormalisation are common.cuh's
// buffer-free pairwise sums (registers and warp shuffles, one barrier
// each, plus one across a cluster), the same tree as
// household.pairwise_sum; its chunks need not fall on a cluster block's
// rows, so a cluster reads them through distributed shared memory, once
// every `accel_every` steps.
//
// The cluster loop's split of long segments (bounds 8, 16 and 32; the
// wide mix keeps its loop).  A segment is one target row's sources in one
// labor state.  Most hold 1-4, but the low-income states pile theirs onto
// the bottom rows of the wealth grid (up to ~170 at the fine width, all in
// the first warp of the lane's first block), and a warp runs each of its
// threads' states in lockstep, as long as its longest segment: one warp's
// serial gather set the step.  So each cluster block lists, once per
// launch, the segments of its rows with more than kSplitDegree sources
// (lottery_split_build, in the order its threads meet them, up to
// kSplitSegs segments and kSplitEntries entries), with a copy of their
// sources and coefficients.  Each step of a block that lists any, all
// its threads first form the listed products, a few each, as independent
// loads (mul, the rounded product of the serial gather); after a barrier
// each listed segment is summed by one lane of the warp that owns it,
// from 0 in CSR order, the lanes working at once, and the owning thread
// takes that sum in place of its gather: the same products added in the
// same order, so the same bits.  What stays serial is the adds of the
// longest segment.  A segment past the caps keeps the serial gather.  The
// one-block loop (lottery_fixed_point) keeps the serial gather alone: at
// the paper's width (~90 sources at most) the split saved warp 0 about
// what its adds cost, and slowed the lanes with no long segment.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace ahtt {

namespace cg = cooperative_groups;

constexpr int kStallWindow = 512;
constexpr int kLotteryClusterMax = 8;     // the portable cluster size
constexpr int kLotteryThreads = 512;      // every lottery kernel's block
constexpr int kLotteryPackedMax = 1 << 16;   // a staged source's element

// The split of long segments: a segment with more than kSplitDegree
// sources is split (a warp's regular gather then runs at most that many
// in a state); a cluster block lists at most kSplitSegs of them and
// kSplitEntries of their entries.  The build passes the three as -D flags
// from ops/kernels.py (LOTTERY_SPLIT_*), their one source.
#if !defined(AHTT_SPLIT_DEGREE) || !defined(AHTT_SPLIT_SEGS) \
    || !defined(AHTT_SPLIT_ENTRIES)
#error "the split's limits come from the build (ops/kernels.py NVCC_FLAGS)"
#endif
constexpr int kSplitDegree = AHTT_SPLIT_DEGREE;
constexpr int kSplitSegs = AHTT_SPLIT_SEGS;
constexpr int kSplitEntries = AHTT_SPLIT_ENTRIES;
static_assert(kSplitSegs + 1 >= 2 * (kLotteryThreads / 32),
              "the list's starts hold the build's warp totals");

// The bound NB on the labor states a lane's loop is compiled for: 8, 16
// or 32, or 0 past 32 (the wide mix, no per-state array in registers).
__host__ __device__ constexpr int lottery_nb(int N) {
  return N <= 8 ? 8 : N <= 16 ? 16 : N <= 32 ? 32 : 0;
}

// Bytes of a cluster block's split list under bound `nb` (none under the
// wide mix): the segments' sums, the entries' products and coefficients
// in T, then the entries' sources, the segments' first entries and the
// count listed in int, 16-byte aligned.
template <typename T>
__host__ __device__ constexpr size_t lottery_split_bytes(int nb) {
  return nb ? ((kSplitSegs + 2 * (size_t)kSplitEntries) * sizeof(T)
               + ((size_t)kSplitEntries + kSplitSegs + 2) * sizeof(int)
               + 15) / 16 * 16
            : 0;
}

// The lottery_split_bytes(nb) region at `base` (16-byte aligned): every
// part at an offset known at compile time.
template <typename T>
struct LotterySplit {
  unsigned char* base;
  // each listed segment's sum, this step [kSplitSegs]
  __device__ T* sum() const { return reinterpret_cast<T*>(base); }
  // the listed entries' products, this step, and coefficients
  // [kSplitEntries]
  __device__ T* prod() const { return sum() + kSplitSegs; }
  __device__ T* coef() const { return prod() + kSplitEntries; }
  // their sources, as the loop addresses them [kSplitEntries]
  __device__ int* src() const {
    return reinterpret_cast<int*>(coef() + kSplitEntries);
  }
  // each listed segment's first entry [kSplitSegs + 1], then the count
  // of segments listed
  __device__ int* off() const { return src() + kSplitEntries; }
  __device__ int* listed() const { return off() + kSplitSegs + 1; }
};

// What a thread keeps of its block's split list: its own listed segments
// are `count` from `first` on, the first `count` of its segments over
// kSplitDegree in the order it meets them; its warp's are [w0, w1); the
// block's listed entries end at `end` (0: the block lists none).
struct SplitPlan {
  int first;
  int count;
  int w0;
  int w1;
  int end;
};

// The transposed transition's padded width under bound `nb`: nb, or N
// rounded up to 4 for the wide mix (rows stay 16-byte aligned).
__host__ __device__ constexpr int lottery_pad(int N, int nb) {
  return nb ? nb : (N + 3) / 4 * 4;
}

// Elements of T of the wide mix's staging buffer (one row's N sums for
// each row a pass of `tpr` threads per row covers); none under a bound.
__host__ __device__ constexpr int lottery_mix_elems(int N, int nb, int tpr) {
  return nb ? 0 : kLotteryThreads / tpr * N;
}

// Shared scratch of the loop, in elements of T: two alternating buffers
// for the residual's reduction and three for the Aitken sums; a cluster
// loop's adds three slots the other blocks read.
__host__ __device__ constexpr int lottery_red_elems(int threads) {
  return 5 * (threads / 32);
}
__host__ __device__ constexpr int lottery_cluster_red_elems(int threads) {
  return lottery_red_elems(threads) + 3;
}

// Bytes of the transition, transposed and padded to [pad, pad]
// (lottery_pad): the labor mix then reads each next state's coefficients
// contiguously, 16-byte aligned, at offsets known at compile time.
template <typename T>
__host__ __device__ constexpr size_t lottery_p_bytes(int N, int nb) {
  return (size_t)lottery_pad(N, nb) * lottery_pad(N, nb) * sizeof(T);
}

// Bytes of a lane's lottery and transition in shared memory, 16-byte
// aligned: the padded P and coefficient [N, 2D] in T, then start
// [N, D+1] and source element [N, 2D] in int.
template <typename T>
__host__ __device__ inline size_t lottery_csr_bytes(int D, int N, int nb) {
  const size_t b = lottery_p_bytes<T>(N, nb) + 2 * (size_t)D * N * sizeof(T)
                   + ((size_t)N * (D + 1) + 2 * (size_t)D * N) * sizeof(int);
  return (b + 15) / 16 * 16;
}

// Bytes of the one-block loop's iterates (current, previous, next), the
// best one, then the wide mix's staging rows.
template <typename T>
__host__ __device__ inline size_t lottery_iterate_bytes(int D, int N, int nb,
                                                        bool best) {
  return ((best ? 4 : 3) * (size_t)D * N + lottery_mix_elems(N, nb, 2))
         * sizeof(T);
}

// Target rows each block of a cluster lane owns.
__host__ __device__ inline int lottery_cluster_rows(int D) {
  return (D + kLotteryClusterMax - 1) / kLotteryClusterMax;
}

// Bytes of one cluster block's shared memory: the padded P, the split
// list, its rows of the four iterates [4, R N] and the wide mix's staging
// rows in T, room for `stage` staged lottery entries (coefficients in T,
// then their start [N, R+1] and packed sources in int), 16-byte aligned.
// With stage = 0: the part that must fit for the lane to take the
// cluster layout.
template <typename T>
__host__ __device__ inline size_t lottery_cluster_bytes(int D, int N, int nb,
                                                        int stage) {
  const size_t rn = (size_t)lottery_cluster_rows(D) * N;
  const size_t b = lottery_p_bytes<T>(N, nb)
                   + lottery_split_bytes<T>(nb)
                   + (4 * rn + lottery_mix_elems(N, nb, 4) + stage)
                         * sizeof(T)
                   + ((size_t)N * (lottery_cluster_rows(D) + 1) + stage)
                         * sizeof(int);
  return (b + 15) / 16 * 16;
}

// Whether a [D, N] lane's staged sources fit the packed (owner << 16) |
// element form: each block's rows hold fewer than 2^16 elements.
__host__ __device__ inline bool lottery_cluster_packs(int D, int N) {
  return (long long)lottery_cluster_rows(D) * N < kLotteryPackedMax;
}

// The lottery_csr_bytes region at `base`.
template <typename T>
struct LotteryCsr {
  T* Pt;    // Pt[n2][n] = P[n][n2], padded to [pad, pad]
  T* cf;
  int* st;
  int* se;
  __device__ LotteryCsr(unsigned char* base, int D, int N, int nb) {
    Pt = reinterpret_cast<T*>(base);
    cf = Pt + lottery_pad(N, nb) * lottery_pad(N, nb);
    st = reinterpret_cast<int*>(cf + 2 * D * N);
    se = st + N * (D + 1);
  }
};

// The lottery_cluster_bytes region at `base`.
template <typename T>
struct LotteryClusterSmem {
  T* Pt;
  unsigned char* split;   // the split list (lottery_split_bytes)
  T* it;    // the iterates [3, R N], then the best one [R N]
  T* mv;    // the wide mix's staging rows (none under a bound)
  T* cf;    // [stage]
  int* st;  // [N, R+1]
  int* se;  // [stage]
  __device__ LotteryClusterSmem(unsigned char* base, int D, int N, int nb,
                                int stage) {
    const int rn = lottery_cluster_rows(D) * N;
    Pt = reinterpret_cast<T*>(base);
    split = base + lottery_p_bytes<T>(N, nb);
    it = reinterpret_cast<T*>(
        split + lottery_split_bytes<T>(nb));
    mv = it + 4 * rn;
    cf = mv + lottery_mix_elems(N, nb, 4);
    st = reinterpret_cast<int*>(cf + stage);
    se = st + N * (lottery_cluster_rows(D) + 1);
  }
};

// Copy a lane's [N, N] transition into the transpose Pt padded to `pad`
// (the block's threads share the work; the caller orders it before any
// read).
template <typename T>
__device__ __forceinline__ void load_transition(T* Pt, const T* P_l, int N,
                                                int pad) {
  for (int j = threadIdx.x; j < N * N; j += blockDim.x)
    Pt[(j % N) * pad + j / N] = P_l[j];
}

// The lottery entries a block gathers from: the row starts of the rows it
// owns (`st`, rows of `rs` ints per state, relative to the state's
// entries at se + n ss, cf + n ss) and the entries.  A source is the
// element d N + n of the flattened iterate; `packed` (cluster, staged)
// means it was rewritten as (owner block << 16) | element within the
// owner's rows.
template <typename T>
struct LotteryRows {
  const int* st;
  int rs;
  const int* se;
  const T* cf;
  int ss;
  bool packed;
};

// A cluster block's rows: [r0, r1) of the D.
__device__ inline void lottery_cluster_span(int D, int rank, int* r0,
                                            int* r1) {
  const int R = lottery_cluster_rows(D);
  *r0 = rank * R < D ? rank * R : D;
  *r1 = *r0 + R < D ? *r0 + R : D;
}

// Stage a cluster block's rows of a lane's CSR (start [N, D+1], source
// element and coefficient [N, 2D], global) into `s` when its entries,
// counted here, fit `stage`; else point at the global entries.  Every
// thread of the block must call it; the caller orders the writes (the
// fixed point's first barrier does) before any read.
template <typename T>
__device__ LotteryRows<T> lottery_stage_rows(
    const LotteryClusterSmem<T>& s, const int* st_g, const int* se_g,
    const T* cf_g, int D, int N, int stage, int rank) {
  int r0, r1;
  lottery_cluster_span(D, rank, &r0, &r1);
  const int R = lottery_cluster_rows(D);
  const int rn = R * N;
  const int D2 = 2 * D;
  int total = 0;
  for (int n = 0; n < N; ++n)
    total += st_g[n * (D + 1) + r1] - st_g[n * (D + 1) + r0];
  const bool staged = total <= stage;
  int off = 0;
  for (int n = 0; n < N; ++n) {
    const int* stn = st_g + n * (D + 1);
    const int k0 = stn[r0];
    const int cnt = stn[r1] - k0;
    for (int i = threadIdx.x; i <= r1 - r0; i += blockDim.x)
      s.st[n * (R + 1) + i] = staged ? off + stn[r0 + i] - k0 : stn[r0 + i];
    if (staged) {
      for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
        const int e = se_g[n * D2 + k0 + k];
        const int o = e / rn;
        s.se[off + k] = (o << 16) | (e - o * rn);
        s.cf[off + k] = cf_g[n * D2 + k0 + k];
      }
    }
    off += cnt;
  }
  if (staged) return LotteryRows<T>{s.st, R + 1, s.se, s.cf, 0, true};
  return LotteryRows<T>{s.st, R + 1, se_g, cf_g, D2, false};
}

// List a cluster block's segments over kSplitDegree (SplitPlan,
// LotterySplit) in the order its threads meet them: rows in passes of
// blockDim.x / TPR, a row's TPR threads each taking the states n = h,
// h + TPR, ... (SPT of them), as the loop does.  The block's rows are
// `nrows` rows of starts `st` (rows of `rs` ints a state, relative to the
// state's entries at se + n ss, cf + n ss).  Segments are listed while
// the list holds them (kSplitSegs, kSplitEntries entries): a prefix of
// that order, so each thread's are the first of its own.  Sources are
// listed in the packed (owner << 16) | element form (`packed`: they come
// so; else elements of the lane, `bn` to a block).  Every thread of the
// block must call it: it starts with a barrier (the caller's copy of the
// CSR into shared memory is then in place), and it ends with one, the
// list in place and its end read (the same in every thread).
template <typename T, int SPT, int TPR>
__device__ SplitPlan lottery_split_build(
    const LotterySplit<T>& sp, const int* st, int rs, const int* se,
    const T* cf, int ss, int nrows, int N, int bn, bool packed) {
  const int tid = threadIdx.x;
  if (tid == 0) *sp.listed() = 0;
  __syncthreads();
  const int wl = tid & 31;
  const int wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int h = tid % TPR;
  const int pass = blockDim.x / TPR;
  int* const off = sp.off();
  // calls f(n, k0, degree) for each of this thread's long segments
  auto each_long = [&](auto f) {
    for (int base = 0; base < nrows; base += pass) {
      const int r = base + tid / TPR;
      if (r >= nrows) break;
      for (int q = 0; q < SPT; ++q) {
        const int n = TPR * q + h;
        if (n >= N) break;
        const int k0 = st[n * rs + r];
        const int deg = st[n * rs + r + 1] - k0;
        if (deg > kSplitDegree && !f(n, k0, deg)) return;
      }
    }
  };
  int ns = 0, ne = 0;
  each_long([&](int, int, int deg) {
    ++ns;
    ne += deg;
    return true;
  });
  // exclusive prefixes over the block, in thread order; the warps' totals
  // pass through the list's starts, free until it is written
  int ps = ns, pe = ne;
  for (int o = 1; o < 32; o <<= 1) {
    const int us = __shfl_up_sync(0xffffffffu, ps, o);
    const int ue = __shfl_up_sync(0xffffffffu, pe, o);
    if (wl >= o) {
      ps += us;
      pe += ue;
    }
  }
  if (wl == 31) {
    off[wid] = ps;
    off[nwarps + wid] = pe;
  }
  __syncthreads();
  ps -= ns;
  pe -= ne;
  for (int w = 0; w < wid; ++w) {
    ps += off[w];
    pe += off[nwarps + w];
  }
  __syncthreads();
  SplitPlan plan{ps, 0, 0, 0, 0};
  int e = pe;
  if (tid == 0) off[0] = 0;
  each_long([&](int n, int k0, int deg) {
    const int s = ps + plan.count;
    if (s >= kSplitSegs || e + deg > kSplitEntries) return false;
    for (int k = 0; k < deg; ++k) {
      int v = se[n * ss + k0 + k];
      if (!packed) {
        const int o = v / bn;
        v = (o << 16) | (v - o * bn);
      }
      sp.src()[e + k] = v;
      sp.coef()[e + k] = cf[n * ss + k0 + k];
    }
    e += deg;
    off[s + 1] = e;
    ++plan.count;
    return true;
  });
  if (plan.count) atomicMax(sp.listed(), ps + plan.count);
  plan.w0 = __shfl_sync(0xffffffffu, ps, 0);
  plan.w1 = __reduce_max_sync(0xffffffffu,
                              plan.count ? ps + plan.count : 0);
  if (plan.w1 < plan.w0) plan.w1 = plan.w0;
  __syncthreads();
  plan.end = off[*sp.listed()];
  return plan;
}

// The step's sums of the listed segments, into sp.sum(): every thread of
// the block forms a share of the listed products (`val(src)`: the
// current iterate at a listed source, the rounded product mul of the
// serial gather), a barrier, then each listed segment is summed by one
// lane of the warp that owns it, from 0 in list order (the CSR's), the
// lanes working at once (eight products loaded ahead of their adds).
// Every thread of a block that lists a segment calls it.
template <typename T, typename Val>
__device__ __forceinline__ void lottery_split_sums(
    const LotterySplit<T>& sp, const SplitPlan& plan, Val val) {
  T* const prod = sp.prod();
  for (int e = threadIdx.x; e < plan.end; e += blockDim.x)
    prod[e] = mul(val(sp.src()[e]), sp.coef()[e]);
  __syncthreads();
  const int* const off = sp.off();
  for (int s = plan.w0 + (threadIdx.x & 31); s < plan.w1; s += 32) {
    const int k1 = off[s + 1];
    int k = off[s];
    T acc = T(0);
    for (; k + 8 <= k1; k += 8) {
      T v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = prod[k + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = acc + v[j];
    }
    for (; k < k1; ++k) acc = acc + prod[k];
    sp.sum()[s] = acc;
  }
  __syncwarp();
}

template <typename T>
struct LotteryResult {
  int iters;
  T diff;   // the best residual, or the last one when that was non-finite
};

// Every thread of the block must call it (NB = lottery_nb(N), blockDim.x
// = kLotteryThreads).  `st`, `se`, `cf` are the lane's CSR, `Pt` its
// transition as load_transition lays it out with lottery_pad(N, NB)
// (16-byte aligned), `d0l` its initial distribution [D, N]; `iter3` holds
// the three iterates [3, D, N]; the best iterate is kept in `best_d`
// [D, N] and copied to `best_out` at the end when the two differ.  `mv`
// is the wide mix's staging rows, lottery_mix_elems(N, 0, 2) elements
// (unused under a bound).  `red` is shared scratch of
// lottery_red_elems(blockDim.x) elements.
template <typename T, int NB>
__device__ LotteryResult<T> lottery_fixed_point(
    const int* st, const int* se, const T* cf, const T* Pt, const T* d0l,
    T* iter3, T* best_d, T* best_out, T* mv, T* red, int D, int N, T tol,
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
    if constexpr (NB == 0) {
      // the wide mix: the pair's row of sums through its staging row
      const int pad = lottery_pad(N, 0);
      T* row = mv + (tid >> 1) * N;
      for (int base = 0; base < D; base += nthr >> 1) {
        const int t = base + (tid >> 1);
        if (t < D)
          for (int n = h; n < N; n += 2) {
            const int* sen = se + n * D2;
            const T* cfn = cf + n * D2;
            const int k1 = st[n * (D + 1) + t + 1];
            T acc = T(0);
            for (int k = st[n * (D + 1) + t]; k < k1; ++k)
              acc = acc + mul(cur[sen[k]], cfn[k]);
            row[n] = acc;
          }
        __syncwarp();
        if (t < D)
          for (int n2 = h; n2 < N; n2 += 2) {
            const T* pr = Pt + n2 * pad;
            T o = mul(row[0], pr[0]);
            for (int n = 1; n < N; ++n) o = o + mul(row[n], pr[n]);
            const int j = t * N + n2;
            nw[j] = o;
            dl = nan_max(dl, (T)fabs(o - cur[j]));
          }
        __syncwarp();   // the pair's reads end before the next pass writes
      }
    } else
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
            const T* pr = Pt + n2 * NB;   // P[., n2], aligned
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


// A cluster lane's fixed point, the same iteration and arithmetic as
// lottery_fixed_point.  Every thread of every block of the cluster must
// call it, and gets the same result.  NB = lottery_nb(N), blockDim.x =
// kLotteryThreads.  `rows` is this block's lottery (lottery_stage_rows),
// `Pt` its transition as load_transition lays it out with
// lottery_pad(N, NB) (16-byte aligned), `d0l` the lane's initial
// distribution [D, N] in global memory; `iter3` holds the block's rows of
// the three iterates [3, R N] and `best_d` their best one [R N], copied to
// the lane's output `best_out` [D, N] at the end; `mv` the wide mix's
// staging rows, lottery_mix_elems(N, 0, 4) elements (unused under a
// bound); `split` the block's split list, lottery_split_bytes(NB)
// (unused under the wide mix).  `red` is shared scratch of
// lottery_cluster_red_elems(blockDim.x) elements.  `iter3` and `red` sit
// at the same offsets in every block's shared memory.
//
// Four neighbouring threads share a target row (R = 125 rows at the fine
// width, so one pass of 500 threads): thread h sums the sources of the
// states n = h, h+4, ... (each from 0 in CSR order), shuffles hand every
// thread all N sums, and thread h mixes the next states n2 = h, h+4, ...,
// each over all states in order.
template <typename T, int NB>
__device__ LotteryResult<T> lottery_cluster_loop(
    const LotteryRows<T> rows, const T* Pt, const T* d0l, T* iter3,
    T* best_d, T* best_out, T* mv, unsigned char* split, T* red, int D,
    int N, T tol, int max_iter, int accel_every) {
  constexpr int TPR = 4;                  // threads per target row
  constexpr int SPT = NB / TPR;           // states each of them sums
  static_assert(NB % TPR == 0, "NB a multiple of 4");
  cg::cluster_group cl = cg::this_cluster();
  const int* const st = rows.st;
  const int* const se = rows.se;
  const T* const cf = rows.cf;
  const int rs = rows.rs, ss = rows.ss;
  const bool packed = rows.packed;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int wl = tid & 31;
  const int DN = D * N;
  const int rank = (int)cl.block_rank();
  const int G = (int)cl.num_blocks();
  int r0, r1;
  lottery_cluster_span(D, rank, &r0, &r1);
  const int nrows = r1 - r0;
  const int own = nrows * N;               // elements this block writes
  const int bn = lottery_cluster_rows(D) * N;   // an iterate's stride
  T* const sum_part = red + 2 * nwarps;    // [3, nwarps]: Aitken sums
  T* const slot = red + 5 * nwarps;        // [3]: read by the other blocks
  // the pairwise sums' chunks: nt threads (a power of two, from the first
  // nb blocks) own L contiguous leaves each of the DN, wherever they live
  const int p = next_pow2(DN);
  int gp = 1;
  while (2 * gp <= G) gp <<= 1;
  const int nt = p < nthr * gp ? p : nthr * gp;
  const int ntb = nt < nthr ? nt : nthr;
  const int nb = nt / ntb;
  const int L = p / nt;
  const int gtid = rank * nthr + tid;
  const int lo = gtid * L;

  // the peers' iterates, through distributed shared memory
  __shared__ T* peer[kLotteryClusterMax];
  if (tid < G) peer[tid] = cl.map_shared_rank(iter3, tid);
  for (int l = tid; l < own; l += nthr) {
    const T v = d0l[r0 * N + l];
    iter3[l] = v; iter3[bn + l] = v; best_d[l] = v;
  }
  const LotterySplit<T> sp{split};
  SplitPlan plan{0, 0, 0, 0, 0};
  if constexpr (NB != 0)
    plan = lottery_split_build<T, SPT, TPR>(sp, st, rs, se, cf, ss, nrows,
                                            N, bn, packed);
  const T tiny = Limits<T>::tiny();
  const T big = Limits<T>::big();
  const T lam_max = T(0.995);
  cl.sync();

  int ic = 0, ip = 1, in = 2;              // current, previous, next
  // element j of the flattened [D, N] iterate `ix`
  auto elem = [&](int ix, int j) -> T {
    const int o = j / bn;
    return peer[o][ix * bn + j - o * bn];
  };
  // the cluster's subtrees of a pairwise sum, joined in rank order as
  // the tree does (slot `q` of every block holds its block's subtree)
  auto join = [&](T v, int q) -> T {
    if (tid == 0) slot[q] = v;
    cl.sync();
    T u = wl < nb ? cl.map_shared_rank(slot, wl)[q] : T(0);
    u = warp_tree(u, nb);
    return __shfl_sync(0xffffffffu, u, 0);
  };

  T diff = big, best = big;
  int it = 0, since = 0;
  bool finite = true;
  while (diff > tol && it < max_iter && since < kStallWindow && finite) {
    const T* cur = iter3 + ic * bn;
    T* nw = iter3 + in * bn;
    const int cb = ic * bn;
    T dl = T(0);
    const int h = tid % TPR;
    // the listed segments' sums first (their sources packed), then each
    // row's gather takes them
    if constexpr (NB != 0)
      if (plan.end)   // the same in every thread of the block
        lottery_split_sums(sp, plan, [&](int e) {
          return peer[e >> 16][cb + (e & 0xffff)];
        });
    int c = 0;   // this thread's listed segments met so far
    if constexpr (NB == 0) {
      // the wide mix: the row's sums through its four threads' staging row
      const int pad = lottery_pad(N, 0);
      // the source's owner block and its element there
      auto owner = [&](int e, int* o, int* l) {
        if (packed) {
          *o = e >> 16;
          *l = e & 0xffff;
        } else {
          *o = e / bn;
          *l = e - *o * bn;
        }
      };
      T* row = mv + (tid / TPR) * N;
      for (int base = 0; base < nrows; base += nthr / TPR) {
        const int i = base + tid / TPR;
        if (i < nrows)
          for (int n = h; n < N; n += TPR) {
            const int* sen = se + n * ss;
            const T* cfn = cf + n * ss;
            const int k1 = st[n * rs + i + 1];
            T acc = T(0);
            for (int k = st[n * rs + i]; k < k1; ++k) {
              int o, l;
              owner(sen[k], &o, &l);
              acc = acc + mul(peer[o][cb + l], cfn[k]);
            }
            row[n] = acc;
          }
        __syncwarp();
        if (i < nrows)
          for (int n2 = h; n2 < N; n2 += TPR) {
            const T* pr = Pt + n2 * pad;
            T o = mul(row[0], pr[0]);
            for (int n = 1; n < N; ++n) o = o + mul(row[n], pr[n]);
            const int l = i * N + n2;
            nw[l] = o;
            dl = nan_max(dl, (T)fabs(o - cur[l]));
          }
        __syncwarp();   // the row's reads end before the next pass writes
      }
    } else
    for (int base = 0; base < nrows; base += nthr / TPR) {
      const int u = base + tid / TPR;
      const int i = u < nrows ? u : nrows - 1;   // every lane shuffles
      T mine[SPT];
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const int n = TPR * q + h;
        T acc = T(0);
        if (n < N) {
          const int* sen = se + n * ss;
          const T* cfn = cf + n * ss;
          const int k1 = st[n * rs + i + 1];
          int k = st[n * rs + i];
          if (k1 - k > kSplitDegree && c < plan.count) {
            acc = sp.sum()[plan.first + c];
            ++c;
            k = k1;
          }
          for (; k < k1; ++k) {
            // the source's owner block and its element there
            const int e = sen[k];
            int o, l;
            if (packed) {
              o = e >> 16;
              l = e & 0xffff;
            } else {
              o = e / bn;
              l = e - o * bn;
            }
            acc = acc + mul(peer[o][cb + l], cfn[k]);
          }
        }
        mine[q] = acc;
      }
      T acc[NB];
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int g = 0; g < TPR; ++g)
          acc[TPR * q + g] = __shfl_sync(0xffffffffu, mine[q], g, TPR);
      if (u < nrows) {
#pragma unroll
        for (int q = 0; q < SPT; ++q) {
          const int n2 = TPR * q + h;
          if (n2 < N) {
            const T* pr = Pt + n2 * NB;   // P[., n2], aligned
            T o = mul(acc[0], pr[0]);
#pragma unroll
            for (int n = 1; n < NB; ++n)
              if (n < N) o = o + mul(acc[n], pr[n]);
            const int l = i * N + n2;
            nw[l] = o;
            dl = nan_max(dl, (T)fabs(o - cur[l]));
          }
        }
      }
    }
    // the step's one barrier: every block's warps' maxima are written,
    // and the buffer alternates, so no thread still reads the one written
    // here; then every thread reads them all
    for (int o = 16; o > 0; o >>= 1)
      dl = nan_max(dl, __shfl_xor_sync(0xffffffffu, dl, o));
    T* mx = red + (it & 1) * nwarps;
    if (wl == 0) mx[tid >> 5] = dl;
    cl.sync();
    T d = T(0);
    for (int q = wl; q < G * nwarps; q += 32)
      d = nan_max(d, cl.map_shared_rank(mx, q / nwarps)[q % nwarps]);
    for (int o = 16; o > 0; o >>= 1)
      d = nan_max(d, __shfl_xor_sync(0xffffffffu, d, o));
    // best certified iterate: every step certifies `nw` (own elements;
    // the barrier above ordered every write of them)
    const bool improved = d < best;
    if (improved)
      for (int l = tid; l < own; l += nthr) best_d[l] = nw[l];
    const bool accel = accel_every > 0 && ((it + 1) % accel_every) == 0;
    if (accel && d <= tol) {
      // converged on the plain step: the loop exits carrying it
      const int oc = ic; ic = in; in = oc;
    } else if (accel) {
      // Aitken rate <d2,d1> / max(<d1,d1>, tiny), each dot the pairwise
      // tree over the flattened [D, N] iterate
      T num = T(0), den = T(0);
      if (gtid < nt) {
        num = chunk_pairwise<T>([&](int j) {
          if (j >= DN) return T(0);
          const T c = elem(ic, j);
          return mul(elem(in, j) - c, c - elem(ip, j));
        }, lo, L);
        den = chunk_pairwise<T>([&](int j) {
          if (j >= DN) return T(0);
          const T d1 = elem(ic, j) - elem(ip, j);
          return mul(d1, d1);
        }, lo, L);
      }
      num = join(tree_combine(num, ntb, sum_part), 0);
      den = join(tree_combine(den, ntb, sum_part + nwarps), 1);
      T lam = num / nan_max(den, tiny);
      lam = lam < T(0) ? T(0) : lam;    // clip keeps NaN
      lam = lam > lam_max ? lam_max : lam;
      const T fac = lam / (T(1) - lam);
      auto extrapolated = [&](T n, T c) {
        const T e = n + mul(fac, n - c);
        return e < T(0) ? T(0) : e;
      };
      // the extrapolation's total, then each own element divided by it
      // into the previous iterate's slots (every read of them ended at
      // the barriers above)
      T tot = T(0);
      if (gtid < nt)
        tot = chunk_pairwise<T>([&](int j) {
          return j < DN ? extrapolated(elem(in, j), elem(ic, j)) : T(0);
        }, lo, L);
      tot = join(tree_combine(tot, ntb, sum_part + 2 * nwarps), 2);
      T* pv = iter3 + ip * bn;
      for (int l = tid; l < own; l += nthr)
        pv[l] = extrapolated(nw[l], cur[l]) / tot;
      cl.sync();
      // dist <- extrapolation, prev <- new, old dist is free
      const int oc = ic; ic = ip; ip = in; in = oc;
    } else {
      // dist <- new, prev <- dist, old prev is free
      const int op = ip; ip = ic; ic = in; in = op;
    }
    best = (d != d || d < best) ? d : best;
    since = improved ? 0 : since + 1;
    diff = d;
    ++it;
    finite = isfinite(d);
  }
  T* out = best_out + r0 * N;
  for (int l = tid; l < own; l += nthr) out[l] = best_d[l];
  // no block leaves while a peer may still read its shared memory
  cl.sync();
  // the best residual, unless the last step was non-finite: then the
  // status rebuilt from (iters, diff) must read NONFINITE
  return LotteryResult<T>{it, isfinite(diff) ? best : diff};
}

}  // namespace ahtt
