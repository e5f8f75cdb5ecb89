// egm_policy_grid: the infinite-horizon EGM policy fixed point, one thread
// block per lane.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, egm_policy_pallas
// (single lane, launched here with C = 1) and egm_policy_pallas_grid (one
// program instance per lane).  The loop is egm_device.cuh's
// egm_fixed_point (household.egm_step under accelerated_policy_fixed_point).
//
// What bounds it on an H100: neither bytes nor FLOPs.  A lane reads about
// 4 KB once and then runs a few hundred dependent steps on 2*N*(A+1)
// knots; each step is a binary search, two pows and an N-term dot per
// (state, asset) pair plus one to three block-wide reductions.  The bound
// is the latency of that dependent chain of barriers.  The design keeps
// everything the chain touches in shared memory when it fits (3 iterates x
// 2 fields x N(A+1) knots plus the [N, A] marginal-value block: about
// 13 KB in f64 at N=7, A=32), so no step goes to device memory, and
// computes the 7x7 expectation in its own body, as the TPU kernel does.
// Above one block's share (the fine grid, A=1000, N=15: 1.2 MB in f64) the
// same loop runs on a global workspace that the wrapper allocates, with
// the same bits.  Lanes are independent blocks: a lane exits at its own
// convergence, and its bits do not depend on its batchmates.  One block
// per lane fills 12 of 132 SMs on the Table II sweep; spreading a lane
// over more SMs is later work.
//
// Compile without --use_fast_math and with --fmad=false: c^(-gamma) and
// x^(-1/gamma) set the policy, and every product-then-sum is rounded as
// the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "egm_device.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__host__ __device__ size_t workspace_bytes(int N, int A) {
  return ahtt::egm_workspace_elems(N, A, A + 1) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
egm_policy_kernel(const T* __restrict__ m0, const T* __restrict__ c0,
                  const T* __restrict__ a_g, const T* __restrict__ lvl_g,
                  const T* __restrict__ P_g, const T* __restrict__ scal,
                  T* __restrict__ m_out, T* __restrict__ c_out,
                  int* __restrict__ iters_out, T* __restrict__ diff_out,
                  unsigned char* ws_g, int use_shared, int N, int A, T tol,
                  int max_iter, int accel_every) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kThreads / 32];
  const int K = A + 1;
  const int NK = N * K;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  unsigned char* row = use_shared
      ? smem_raw
      : ws_g + (size_t)lane * ahtt::ws_row_bytes(workspace_bytes<T>(N, A));
  const ahtt::EgmWorkspace<T> w(reinterpret_cast<T*>(row), N, A, K);
  const ahtt::EgmResult<T> r = ahtt::egm_fixed_point<T>(
      w, red, m0 + (size_t)lane * NK, c0 + (size_t)lane * NK,
      a_g + (size_t)lane * A, lvl_g + (size_t)lane * N,
      P_g + (size_t)lane * N * N, scal + (size_t)lane * 5, nullptr, N, A,
      false, tol, max_iter, accel_every);
  // the certified iterate is the last plain step (p0 if no step ran)
  for (int j = tid; j < NK; j += blockDim.x) {
    m_out[(size_t)lane * NK + j] = w.new_m[j];
    c_out[(size_t)lane * NK + j] = w.new_c[j];
  }
  if (tid == 0) {
    iters_out[lane] = r.iters;
    diff_out[lane] = r.diff;
  }
}

template <typename T>
int launch(const void* m0, const void* c0, const void* a, const void* lvl,
           const void* P, const void* scal, void* m_out, void* c_out,
           void* iters, void* diff, void* ws, int use_shared, int C, int N,
           int A, double tol, int max_iter, int accel_every, void* stream) {
  const size_t smem = use_shared ? workspace_bytes<T>(N, A) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        egm_policy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  egm_policy_kernel<T><<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)m0, (const T*)c0, (const T*)a, (const T*)lvl, (const T*)P,
      (const T*)scal, (T*)m_out, (T*)c_out, (int*)iters, (T*)diff,
      (unsigned char*)ws, use_shared, N, A, (T)tol, max_iter, accel_every);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one lane's workspace: the wrapper puts it in shared memory when
// it fits one block's share, else allocates it in global memory.
unsigned long long egm_policy_grid_workspace_bytes(int N, int A, int f64) {
  return f64 ? workspace_bytes<double>(N, A) : workspace_bytes<float>(N, A);
}

int egm_policy_grid_f32(const void* m0, const void* c0, const void* a,
                        const void* lvl, const void* P, const void* scal,
                        void* m_out, void* c_out, void* iters, void* diff,
                        void* ws, int use_shared, int C, int N, int A,
                        double tol, int max_iter, int accel_every,
                        void* stream) {
  return launch<float>(m0, c0, a, lvl, P, scal, m_out, c_out, iters, diff,
                       ws, use_shared, C, N, A, tol, max_iter, accel_every,
                       stream);
}

int egm_policy_grid_f64(const void* m0, const void* c0, const void* a,
                        const void* lvl, const void* P, const void* scal,
                        void* m_out, void* c_out, void* iters, void* diff,
                        void* ws, int use_shared, int C, int N, int A,
                        double tol, int max_iter, int accel_every,
                        void* stream) {
  return launch<double>(m0, c0, a, lvl, P, scal, m_out, c_out, iters, diff,
                        ws, use_shared, C, N, A, tol, max_iter, accel_every,
                        stream);
}

}  // extern "C"
