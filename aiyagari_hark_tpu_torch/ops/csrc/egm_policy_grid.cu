// egm_policy_grid: the infinite-horizon EGM policy fixed point, one lane
// per thread block, or per thread-block cluster where one block's shared
// memory cannot hold the lane.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, egm_policy_pallas
// (single lane, launched here with C = 1) and egm_policy_pallas_grid (one
// program instance per lane).  The loop is egm_device.cuh's
// egm_fixed_point (household.egm_step under accelerated_policy_fixed_point).
//
// What bounds it on an H100: neither bytes nor FLOPs.  A lane reads a few
// KB once and then runs a hundred or more dependent steps on 2 N (A+1)
// knots; each step is a bracket search, two pows and an N-term dot per
// (state, asset) pair, and a block-wide max.  The bound is the latency of
// that chain of barriers and shared-memory loads.  The design keeps the
// chain on chip and short, in one of three layouts the wrapper chooses by
// size alone (ops.kernels.egm_policy_grid_layout):
//   shared  -- the whole lane in one block's shared memory (13 KB in f64
//              at N=7, A=32);
//   cluster -- the labor states split over a cluster of up to 8 blocks,
//              each holding its states' iterates and marginal values in its
//              own shared memory and reading the others' marginal values
//              through distributed shared memory (the fine grid, A=1000,
//              N=15: 851 KB in f64 as one block, 122 KB per block of 8);
//   global  -- one block on a wrapper-allocated global workspace, for what
//              a cluster cannot hold either, and under force_global.
// With `tail` (the compact grids' coarse-to-fine ladder) every iterate is
// closed by the two-knot analytic tail, K = A+3 knots, its slope computed
// here and its intercept h [C, N] from the wrapper, in any of the three
// layouts: a cluster block closes the states it holds (the fine compact
// grid, A=851, N=15: 726 KB in f64 as one block, 104 KB per block of 8).
// Each layout is its own instantiation, so shared memory is addressed as
// shared and global as global; all three run the same arithmetic in the
// same order and agree bitwise.  A plain step holds two barriers.  Lanes
// are independent: a lane exits at its own convergence, and its bits do
// not depend on its batchmates.
//
// Compile without --use_fast_math and with contraction on (--fmad=true,
// as PyTorch's kernels are built): pow then rounds as torch.pow does, and
// every product the kernel writes is rounded on its own (common.cuh's
// mul), as the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "egm_device.cuh"

namespace {

// Layouts (the wrapper's choice): 0 global, 1 shared, 2 cluster.
constexpr int kGlobal = 0, kShared = 1, kCluster = 2;

template <int kLayout>
__host__ __device__ constexpr int threads_of() {
  return kLayout == kCluster ? 512 : 256;
}

// Knots of a lane's policy rows: A+1, or A+3 closed by the tail.
__host__ __device__ inline int knots_of(int A, bool tail) {
  return A + (tail ? 3 : 1);
}

// Bytes of one block's workspace: the whole lane (global and shared), or
// the states one block of a cluster holds.
template <typename T>
__host__ __device__ size_t workspace_bytes(int N, int A, bool tail,
                                           bool cluster) {
  const int S = cluster ? ahtt::egm_cluster_states(N) : N;
  return ahtt::egm_workspace_elems(S, N, A, knots_of(A, tail)) * sizeof(T);
}

template <typename T, int kLayout>
__global__ void __launch_bounds__(threads_of<kLayout>())
egm_policy_kernel(const T* __restrict__ m0, const T* __restrict__ c0,
                  const T* __restrict__ a_g, const T* __restrict__ lvl_g,
                  const T* __restrict__ P_g, const T* __restrict__ scal,
                  const T* __restrict__ h_g, T* __restrict__ m_out,
                  T* __restrict__ c_out, int* __restrict__ iters_out,
                  T* __restrict__ diff_out, unsigned char* ws_g, int tail,
                  int N, int A, T tol, int max_iter, int accel_every) {
  constexpr bool kCl = kLayout == kCluster;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[ahtt::egm_red_elems(threads_of<kLayout>())];
  const bool tl = tail != 0;
  const int K = knots_of(A, tl);
  const int NK = N * K;
  const int G = kCl ? ahtt::egm_cluster_blocks(N) : 1;
  const int S = kCl ? ahtt::egm_cluster_states(N) : N;
  const int lane = blockIdx.x / G;
  const int tid = threadIdx.x;
  unsigned char* row;
  if constexpr (kLayout == kGlobal)
    row = ws_g + (size_t)lane * ahtt::ws_row_bytes(
                                    workspace_bytes<T>(N, A, tl, false));
  else
    row = smem_raw;
  const ahtt::EgmWorkspace<T> w(reinterpret_cast<T*>(row), S, N, A, K);
  const ahtt::EgmResult<T> r = ahtt::egm_fixed_point<T, kCl>(
      w, red, m0 + (size_t)lane * NK, c0 + (size_t)lane * NK,
      a_g + (size_t)lane * A, lvl_g + (size_t)lane * N,
      P_g + (size_t)lane * N * N, scal + (size_t)lane * 5,
      tl ? h_g + (size_t)lane * N : nullptr, S, N, A, tl, tol, max_iter,
      accel_every);
  // the certified iterate is the last plain step (p0 if no step ran): each
  // block writes the states it holds
  const int s0 = (blockIdx.x - lane * G) * S;
  const int n = (N - s0 < S ? N - s0 : S) * K;
  T* mo = m_out + (size_t)lane * NK + (size_t)s0 * K;
  T* co = c_out + (size_t)lane * NK + (size_t)s0 * K;
  for (int j = tid; j < n; j += blockDim.x) {
    mo[j] = r.m[j];
    co[j] = r.c[j];
  }
  if (tid == 0 && s0 == 0) {
    iters_out[lane] = r.iters;
    diff_out[lane] = r.diff;
  }
  // no block leaves while a peer may still read its shared memory
  if constexpr (kCl) cooperative_groups::this_cluster().sync();
}

template <typename T, int kLayout>
int launch_layout(const void* m0, const void* c0, const void* a,
                  const void* lvl, const void* P, const void* scal,
                  const void* h, void* m_out, void* c_out, void* iters,
                  void* diff, void* ws, int tail, int C, int N, int A,
                  double tol, int max_iter, int accel_every, void* stream) {
  constexpr int nthr = threads_of<kLayout>();
  const size_t smem =
      kLayout == kGlobal
          ? 0
          : workspace_bytes<T>(N, A, tail != 0, kLayout == kCluster);
  auto kern = egm_policy_kernel<T, kLayout>;
  // the default cap (48 KB) counts the static arrays too: allow every
  // dynamic request
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int G = kLayout == kCluster ? ahtt::egm_cluster_blocks(N) : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * G));
  cfg.blockDim = dim3(nthr);
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
      &cfg, kern, (const T*)m0, (const T*)c0, (const T*)a, (const T*)lvl,
      (const T*)P, (const T*)scal, (const T*)h, (T*)m_out, (T*)c_out,
      (int*)iters, (T*)diff, (unsigned char*)ws, tail, N, A, (T)tol,
      max_iter, accel_every);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* m0, const void* c0, const void* a, const void* lvl,
           const void* P, const void* scal, const void* h, void* m_out,
           void* c_out, void* iters, void* diff, void* ws, int layout,
           int tail, int C, int N, int A, double tol, int max_iter,
           int accel_every, void* stream) {
  if (N < 1 || A < 1 || layout < kGlobal || layout > kCluster
      || (tail && h == nullptr)
      || (layout == kCluster && (N < 2 || N > ahtt::kEgmClusterMaxN))
      || ahtt::next_pow2(2 * N * knots_of(A, tail != 0)) / 256
             > (1 << ahtt::kChunkLevels))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto fn) {
    return fn(m0, c0, a, lvl, P, scal, h, m_out, c_out, iters, diff, ws,
              tail, C, N, A, tol, max_iter, accel_every, stream);
  };
  switch (layout) {
    case kGlobal: return run(launch_layout<T, kGlobal>);
    case kShared: return run(launch_layout<T, kShared>);
    default: return run(launch_layout<T, kCluster>);
  }
}

}  // namespace

extern "C" {

// Bytes of one lane's workspace in one block, with or without the tail:
// the wrapper takes the shared layout when it fits one block's share.
unsigned long long egm_policy_grid_workspace_bytes(int N, int A, int tail,
                                                   int f64) {
  return f64 ? workspace_bytes<double>(N, A, tail != 0, false)
             : workspace_bytes<float>(N, A, tail != 0, false);
}

// Bytes of shared memory each block of a cluster lane takes, with or
// without the tail, or ~0 where the lane cannot be split over a cluster
// (fewer than 2 or more than 16 labor states): the wrapper takes the
// cluster layout when the lane does not fit one block but this fits.
unsigned long long egm_policy_grid_cluster_bytes(int N, int A, int tail,
                                                 int f64) {
  if (N < 2 || N > ahtt::kEgmClusterMaxN) return ~0ull;
  return f64 ? workspace_bytes<double>(N, A, tail != 0, true)
             : workspace_bytes<float>(N, A, tail != 0, true);
}

// Blocks of a cluster lane with N labor states.
int egm_policy_grid_cluster_blocks(int N) {
  return ahtt::egm_cluster_blocks(N);
}

#define EGM_ENTRY(NAME, T)                                                   \
  int NAME(const void* m0, const void* c0, const void* a, const void* lvl,   \
           const void* P, const void* scal, const void* h, void* m_out,      \
           void* c_out, void* iters, void* diff, void* ws, int layout,       \
           int tail, int C, int N, int A, double tol, int max_iter,          \
           int accel_every, void* stream) {                                  \
    return launch<T>(m0, c0, a, lvl, P, scal, h, m_out, c_out, iters, diff,  \
                     ws, layout, tail, C, N, A, tol, max_iter, accel_every,  \
                     stream);                                                \
  }

EGM_ENTRY(egm_policy_grid_f32, float)
EGM_ENTRY(egm_policy_grid_f64, double)

#undef EGM_ENTRY

}  // extern "C"
