// stationary_lottery_grid: the stationary wealth distribution of the
// Young-lottery push-forward, one lane per thread block, or per
// thread-block cluster where one block's shared memory cannot hold the
// lane.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, stationary_dense_pallas
// (single lane, launched here with C = 1) and stationary_dense_pallas_grid
// (one program instance per lane).  The loop is lottery_device.cuh's
// lottery_fixed_point, or lottery_cluster_loop for a cluster lane
// (household.accelerated_distribution_fixed_point).
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
// steps of ~20 D N flops each; the bound is the latency of that chain.  So
// the design keeps the chain on chip, in one of four layouts the wrapper
// chooses by size alone (ops.kernels.stationary_lottery_grid_layout):
//   shared (2), shared_best_in_output (1) -- the lane's CSR, transition and
//       three iterates in one block's shared memory, copied there once
//       (211 KB in f64 at D=500, N=7), and the best iterate too when it
//       fits, else in the output.  A plain step is one gather-and-mix pass
//       and one block barrier;
//   cluster (3) -- the target rows split over a cluster of 8 blocks (the
//       fine width, D=1000, N=15: 782 KB as one block, 68 KB of iterates
//       and row starts and 42 KB of split list per block of 8 in f64),
//       each holding its rows' iterates in its own shared memory and its
//       rows' lottery entries too when they fit the rest of its share
//       (how many its rows hold depends on the policy, so the block counts
//       them on the device; otherwise it reads them where the wrapper
//       built them).  A source another block owns is read through
//       distributed shared memory; a plain step is one cluster barrier;
//       under a bound each block splits its long lottery segments over
//       its threads (lottery_device.cuh), the same bits;
//   global (0) -- one block, the CSR where the wrapper built it and the
//       iterates in a global scratch, for what a cluster cannot hold
//       either, and under force_global.
// Every layout runs the same arithmetic in the same order, so all four
// agree bitwise, and a lane's bits depend on neither C nor its
// batchmates.  Any number of labor states runs: each layout is compiled
// for the bounds 8, 16 and 32 on the states and for the wide mix past 32
// (lottery_device.cuh); the wrapper names the bound (lottery_nb) and the
// byte counts take it, so the transition's pad is the bound's.
//
// Compile without --use_fast_math and with contraction on (--fmad=true):
// every product the kernel writes is rounded on its own (common.cuh's
// mul), so every product-then-sum rounds as the plain PyTorch version
// rounds it.
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "lottery_device.cuh"

namespace {

constexpr int kThreads = ahtt::kLotteryThreads;
static_assert((kThreads & (kThreads - 1)) == 0, "a power of two");

// Layouts (the wrapper's choice): 0 global (only the transition in shared
// memory, and under the wide mix not even that); 1 shared, best iterate
// in the output; 2 shared, best iterate too; 3 cluster.  The kernel is
// compiled once per layout, so where the lane lives in shared memory the
// compiler sees it and addresses it as such (32-bit shared loads, no
// generic address path), and once per bound NB on the labor states (8,
// 16, 32, or 0: the wide mix), so the loops over states unroll.
constexpr int kCluster = 3;

// The two bounds this library is compiled for: 8 and 16, or, built from
// stationary_lottery_grid_wide.cu (AHTT_WIDE_BOUNDS), 32 and the wide mix:
// nvcc builds the two libraries side by side, each half the kernels.
#ifdef AHTT_WIDE_BOUNDS
constexpr int kBounds[2] = {32, 0};
#else
constexpr int kBounds[2] = {8, 16};
#endif

// Bytes of shared memory one block of a lane takes under bound `nb`:
// `stage` lottery entries a cluster block may stage.
template <typename T>
__host__ __device__ size_t shared_bytes(int D, int N, int nb, int layout,
                                        int stage) {
  if (layout == kCluster)
    return ahtt::lottery_cluster_bytes<T>(D, N, nb, stage);
  if (layout == 0)   // the padded P alone (global under the wide mix)
    return nb ? ahtt::lottery_p_bytes<T>(N, nb) : 0;
  return ahtt::lottery_csr_bytes<T>(D, N, nb)
         + ahtt::lottery_iterate_bytes<T>(D, N, nb, layout == 2);
}

// Elements of T of one lane's global scratch (the global layout): the
// three iterates, then under the wide mix its staging rows and the padded
// transition.
__host__ __device__ inline size_t scratch_elems(int D, int N, int nb) {
  const size_t p = ahtt::lottery_pad(N, nb);
  return 3 * (size_t)D * N
         + (nb ? 0 : ahtt::lottery_mix_elems(N, nb, 2) + p * p);
}

template <typename T, int kLayout, int NB>
__global__ void __launch_bounds__(kThreads)
stationary_lottery_kernel(const int* __restrict__ start,
                          const int* __restrict__ elem,
                          const T* __restrict__ coef,
                          const T* __restrict__ P_g,
                          const T* __restrict__ d0, T* __restrict__ best_out,
                          int* __restrict__ iters_out,
                          T* __restrict__ diff_out, T* __restrict__ scratch,
                          int D, int N, int stage, T tol, int max_iter,
                          int accel_every) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kCl = kLayout == kCluster;
  constexpr int kRed = kCl ? ahtt::lottery_cluster_red_elems(kThreads)
                           : ahtt::lottery_red_elems(kThreads);
  __shared__ T red[kRed];
  const int G = kCl ? ahtt::kLotteryClusterMax : 1;
  const int lane = blockIdx.x / G;
  const int tid = threadIdx.x;
  const int DN = D * N;
  const int* st = start + (size_t)lane * N * (D + 1);
  const int* se = elem + (size_t)lane * N * 2 * D;
  const T* cf = coef + (size_t)lane * N * 2 * D;
  T* out = best_out + (size_t)lane * DN;
  const T* d0l = d0 + (size_t)lane * DN;
  const int pad = ahtt::lottery_pad(N, NB);
  ahtt::LotteryResult<T> r;
  if constexpr (kCl) {
    const int rank = (int)cooperative_groups::this_cluster().block_rank();
    const ahtt::LotteryClusterSmem<T> s(smem_raw, D, N, NB, stage);
    const ahtt::LotteryRows<T> rows =
        ahtt::lottery_stage_rows(s, st, se, cf, D, N, stage, rank);
    ahtt::load_transition(s.Pt, P_g + (size_t)lane * N * N, N, pad);
    const int rn = ahtt::lottery_cluster_rows(D) * N;
    r = ahtt::lottery_cluster_loop<T, NB>(rows, s.Pt, d0l, s.it,
                                          s.it + 3 * rn, out, s.mv, s.split,
                                          red, D, N, tol, max_iter,
                                          accel_every);
    if (rank != 0) return;
  } else {
    T* iter3;
    T* best = out;
    T* Pt;
    T* mv = nullptr;
    if constexpr (kLayout == 0) {
      iter3 = scratch + (size_t)lane * scratch_elems(D, N, NB);
      if constexpr (NB == 0) {
        mv = iter3 + 3 * DN;
        Pt = mv + ahtt::lottery_mix_elems(N, NB, 2);
      } else {
        Pt = reinterpret_cast<T*>(smem_raw);
      }
    } else {
      // the lane's lottery into shared memory, once; the fixed point's
      // first barrier orders these writes before any read
      const ahtt::LotteryCsr<T> s(smem_raw, D, N, NB);
      for (int j = tid; j < N * (D + 1); j += kThreads) s.st[j] = st[j];
      for (int j = tid; j < 2 * DN; j += kThreads) {
        s.se[j] = se[j];
        s.cf[j] = cf[j];
      }
      st = s.st;
      se = s.se;
      cf = s.cf;
      Pt = s.Pt;
      iter3 = reinterpret_cast<T*>(smem_raw
                                   + ahtt::lottery_csr_bytes<T>(D, N, NB));
      if constexpr (kLayout == 2) best = iter3 + 3 * DN;
      if constexpr (NB == 0) mv = iter3 + (kLayout == 2 ? 4 : 3) * DN;
    }
    ahtt::load_transition(Pt, P_g + (size_t)lane * N * N, N, pad);
    r = ahtt::lottery_fixed_point<T, NB>(st, se, cf, Pt, d0l, iter3, best,
                                         out, mv, red, D, N, tol, max_iter,
                                         accel_every);
  }
  if (tid == 0) {
    iters_out[lane] = r.iters;
    diff_out[lane] = r.diff;
  }
}

template <typename T, int kLayout, int NB>
int launch_layout(const void* start, const void* elem, const void* coef,
                  const void* P, const void* d0, void* best, void* iters,
                  void* diff, void* scratch, int stage, int C, int D, int N,
                  double tol, int max_iter, int accel_every, void* stream) {
  const size_t smem = shared_bytes<T>(D, N, NB, kLayout, stage);
  auto kern = stationary_lottery_kernel<T, kLayout, NB>;
  // the default cap (48 KB) counts the static arrays too: allow every
  // dynamic request
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int G = kLayout == kCluster ? ahtt::kLotteryClusterMax : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * G));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kLayout == kCluster ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const int*)start, (const int*)elem, (const T*)coef,
      (const T*)P, (const T*)d0, (T*)best, (int*)iters, (T*)diff,
      (T*)scratch, D, N, stage, (T)tol, max_iter, accel_every);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Whether a [D, N] lane under bound `nb` may take the cluster layout (its
// staged sources pack into 16 bits).
inline bool cluster_takes(int D, int N, int nb) {
  return N >= 1 && D >= 1 && nb == ahtt::lottery_nb(N)
         && ahtt::lottery_cluster_packs(D, N);
}

// One instantiation per layout, and per bound on the labor states this
// library holds (kBounds): the loops over states unroll to offsets known
// at compile time.  `nb` is the wrapper's bound, lottery_nb(N).
template <typename T>
int launch(const void* start, const void* elem, const void* coef,
           const void* P, const void* d0, void* best, void* iters, void* diff,
           void* scratch, int layout, int nb, int stage, int C, int D, int N,
           double tol, int max_iter, int accel_every, void* stream) {
  if (N < 1 || D < 1 || nb != ahtt::lottery_nb(N)
      || (nb != kBounds[0] && nb != kBounds[1]) || layout < 0
      || layout > kCluster || stage < 0 || (layout != kCluster && stage != 0)
      || (layout == kCluster && !cluster_takes(D, N, nb))
      || ahtt::next_pow2(D * N) / kThreads > (1 << ahtt::kChunkLevels))
    return (int)cudaErrorInvalidValue;
  using Fn = int (*)(const void*, const void*, const void*, const void*,
                     const void*, void*, void*, void*, void*, int, int, int,
                     int, double, int, int, void*);
  constexpr Fn fns[2][4] = {
      {launch_layout<T, 0, kBounds[0]>, launch_layout<T, 1, kBounds[0]>,
       launch_layout<T, 2, kBounds[0]>, launch_layout<T, 3, kBounds[0]>},
      {launch_layout<T, 0, kBounds[1]>, launch_layout<T, 1, kBounds[1]>,
       launch_layout<T, 2, kBounds[1]>, launch_layout<T, 3, kBounds[1]>}};
  return fns[nb == kBounds[1]][layout](start, elem, coef, P, d0, best, iters,
                                       diff, scratch, stage, C, D, N, tol,
                                       max_iter, accel_every, stream);
}

}  // namespace

extern "C" {

// Bytes of one lane's shared-memory layout under bound `nb`, with or
// without the best iterate: the wrapper picks the layout from these.
unsigned long long stationary_lottery_grid_shared_bytes(int D, int N, int nb,
                                                        int f64, int best) {
  return f64 ? shared_bytes<double>(D, N, nb, best ? 2 : 1, 0)
             : shared_bytes<float>(D, N, nb, best ? 2 : 1, 0);
}

// Bytes of shared memory each block of a cluster lane takes under bound
// `nb` with room for `stage` staged lottery entries (stage = 0: the part
// that must fit), or ~0 where the kernel takes no such lane (a block's
// rows of 2^16 elements or more, whose staged sources would not pack).
unsigned long long stationary_lottery_grid_cluster_bytes(int D, int N, int nb,
                                                         int f64,
                                                         int stage) {
  if (!cluster_takes(D, N, nb) || stage < 0) return ~0ull;
  return f64 ? shared_bytes<double>(D, N, nb, kCluster, stage)
             : shared_bytes<float>(D, N, nb, kCluster, stage);
}

// Blocks of a cluster lane.
int stationary_lottery_grid_cluster_blocks() {
  return ahtt::kLotteryClusterMax;
}

// Elements of T of one lane's global scratch (the global layout) under
// bound `nb`.
unsigned long long stationary_lottery_grid_scratch_elems(int D, int N,
                                                         int nb) {
  return scratch_elems(D, N, nb);
}

#define LOTTERY_ENTRY(NAME, T)                                               \
  int NAME(const void* start, const void* elem, const void* coef,            \
           const void* P, const void* d0, void* best, void* iters,           \
           void* diff, void* scratch, int layout, int nb, int stage, int C,  \
           int D, int N, double tol, int max_iter, int accel_every,          \
           void* stream) {                                                   \
    return launch<T>(start, elem, coef, P, d0, best, iters, diff, scratch,   \
                     layout, nb, stage, C, D, N, tol, max_iter, accel_every, \
                     stream);                                                \
  }

LOTTERY_ENTRY(stationary_lottery_grid_f32, float)
LOTTERY_ENTRY(stationary_lottery_grid_f64, double)

#undef LOTTERY_ENTRY

}  // extern "C"
