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
// steps of ~20 D N flops each; the bound is the latency of that chain.  So
// the design keeps the chain in one SM: where the lane fits one block's
// shared memory (the wrapper decides by the byte count below: 212 KB in
// f64 at D=500, N=7), the kernel copies the lane's CSR and transition
// there once and runs the whole loop on shared memory -- the three
// iterates and, when it fits too, the best one.  A plain step is one
// gather-and-mix pass and one barrier.  Otherwise (the fine width, D=1000
// and N=15: 420 KB of CSR alone) or with `force_global`, the loop reads
// the CSR where the wrapper built it and keeps the iterates in a global
// scratch, with the same bits.  One block per lane fills 12 of 132 SMs on
// the Table II sweep; spreading a lane over a cluster is later work.
//
// Compile without --use_fast_math and with --fmad=false, so every
// product-then-sum rounds as the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "lottery_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = ahtt::kLotteryMaxN;
static_assert((kThreads & (kThreads - 1)) == 0, "a power of two");

// Layouts (the wrapper's choice): 0 global (only the transition in shared
// memory); 1 shared, best iterate in the output; 2 shared, best iterate
// too.  The kernel is compiled once per layout, so where the lane lives in
// shared memory the compiler sees it and addresses it as such (32-bit
// shared loads, no generic address path), and once per bound NB on the
// labor states (8 or 16), so the loops over states unroll.
template <typename T>
__host__ __device__ size_t shared_bytes(int D, int N, int layout) {
  return layout ? ahtt::lottery_csr_bytes<T>(D, N)
                      + ahtt::lottery_iterate_bytes<T>(D, N, layout == 2)
                : ahtt::lottery_p_bytes<T>();   // the padded P alone
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
                          int D, int N, T tol, int max_iter, int accel_every) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[ahtt::lottery_red_elems(kThreads)];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int DN = D * N;
  const int* st = start + (size_t)lane * N * (D + 1);
  const int* se = elem + (size_t)lane * N * 2 * D;
  const T* cf = coef + (size_t)lane * N * 2 * D;
  T* out = best_out + (size_t)lane * DN;
  T* iter3;
  T* best = out;
  T* Pt;
  if constexpr (kLayout == 0) {
    Pt = reinterpret_cast<T*>(smem_raw);
    iter3 = scratch + (size_t)lane * 3 * DN;
  } else {
    // the lane's lottery into shared memory, once; the fixed point's
    // first barrier orders these writes before any read
    const ahtt::LotteryCsr<T> s(smem_raw, D, N);
    for (int j = tid; j < N * (D + 1); j += kThreads) s.st[j] = st[j];
    for (int j = tid; j < 2 * DN; j += kThreads) {
      s.se[j] = se[j];
      s.cf[j] = cf[j];
    }
    st = s.st;
    se = s.se;
    cf = s.cf;
    Pt = s.Pt;
    iter3 = reinterpret_cast<T*>(smem_raw + ahtt::lottery_csr_bytes<T>(D, N));
    if constexpr (kLayout == 2) best = iter3 + 3 * DN;
  }
  ahtt::load_transition(Pt, P_g + (size_t)lane * N * N, N);
  const ahtt::LotteryResult<T> r = ahtt::lottery_fixed_point<T, NB>(
      st, se, cf, Pt, d0 + (size_t)lane * DN, iter3, best, out, red, D, N,
      tol, max_iter, accel_every);
  if (tid == 0) {
    iters_out[lane] = r.iters;
    diff_out[lane] = r.diff;
  }
}

template <typename T, int kLayout, int NB>
int launch_layout(const void* start, const void* elem, const void* coef,
                  const void* P, const void* d0, void* best, void* iters,
                  void* diff, void* scratch, int C, int D, int N, double tol,
                  int max_iter, int accel_every, void* stream) {
  const size_t smem = shared_bytes<T>(D, N, kLayout);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stationary_lottery_kernel<T, kLayout, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stationary_lottery_kernel<T, kLayout, NB>
      <<<C, kThreads, smem, (cudaStream_t)stream>>>(
          (const int*)start, (const int*)elem, (const T*)coef, (const T*)P,
          (const T*)d0, (T*)best, (int*)iters, (T*)diff, (T*)scratch, D, N,
          (T)tol, max_iter, accel_every);
  return (int)cudaGetLastError();
}

// One instantiation per layout, and per bound on the labor states (8 or
// 16): the loops over states unroll to offsets known at compile time.
template <typename T>
int launch(const void* start, const void* elem, const void* coef,
           const void* P, const void* d0, void* best, void* iters, void* diff,
           void* scratch, int layout, int C, int D, int N, double tol,
           int max_iter, int accel_every, void* stream) {
  if (N < 1 || N > kMaxN || layout < 0 || layout > 2
      || ahtt::next_pow2(D * N) / kThreads > (1 << ahtt::kChunkLevels))
    return (int)cudaErrorInvalidValue;
  using Fn = int (*)(const void*, const void*, const void*, const void*,
                     const void*, void*, void*, void*, void*, int, int, int,
                     double, int, int, void*);
  constexpr Fn fns[2][3] = {
      {launch_layout<T, 0, 8>, launch_layout<T, 1, 8>, launch_layout<T, 2, 8>},
      {launch_layout<T, 0, 16>, launch_layout<T, 1, 16>,
       launch_layout<T, 2, 16>}};
  return fns[N > 8][layout](start, elem, coef, P, d0, best, iters, diff,
                            scratch, C, D, N, tol, max_iter, accel_every,
                            stream);
}

}  // namespace

extern "C" {

int stationary_lottery_grid_max_states() { return kMaxN; }

// Bytes of one lane's shared-memory layout, with or without the best
// iterate: the wrapper picks the layout from these.
unsigned long long stationary_lottery_grid_shared_bytes(int D, int N,
                                                        int f64, int best) {
  return f64 ? shared_bytes<double>(D, N, best ? 2 : 1)
             : shared_bytes<float>(D, N, best ? 2 : 1);
}

// Elements of T of one lane's global scratch (the global layout).
unsigned long long stationary_lottery_grid_scratch_elems(int D, int N) {
  return 3ull * D * N;
}

int stationary_lottery_grid_f32(const void* start, const void* elem,
                                const void* coef, const void* P,
                                const void* d0, void* best, void* iters,
                                void* diff, void* scratch, int layout, int C,
                                int D, int N, double tol, int max_iter,
                                int accel_every, void* stream) {
  return launch<float>(start, elem, coef, P, d0, best, iters, diff, scratch,
                       layout, C, D, N, tol, max_iter, accel_every, stream);
}

int stationary_lottery_grid_f64(const void* start, const void* elem,
                                const void* coef, const void* P,
                                const void* d0, void* best, void* iters,
                                void* diff, void* scratch, int layout, int C,
                                int D, int N, double tol, int max_iter,
                                int accel_every, void* stream) {
  return launch<double>(start, elem, coef, P, d0, best, iters, diff, scratch,
                        layout, C, D, N, tol, max_iter, accel_every, stream);
}

}  // extern "C"
