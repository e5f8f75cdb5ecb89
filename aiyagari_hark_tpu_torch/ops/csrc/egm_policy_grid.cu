// egm_policy_grid: the infinite-horizon EGM policy fixed point, one thread
// block per lane.
//
// Replaces: aiyagari_hark_tpu/ops/pallas_kernels.py, egm_policy_pallas
// (single lane, launched here with C = 1) and egm_policy_pallas_grid (one
// program instance per lane).  The iteration is models/household.py's
// egm_step under accelerated_policy_fixed_point: Anderson(1) extrapolation
// of both knot fields every `accel_every` steps, rejected when it breaks
// strict knot monotonicity or consumption positivity; the loop returns the
// last plain iterate, which its sup-norm diff certifies.
//
// What bounds it on an H100: neither bytes nor FLOPs.  A lane reads about
// 4 KB once and then runs a few hundred dependent steps on 2*N*(A+1)
// knots; each step is a binary search, two pows and an N-term dot per
// (state, asset) pair plus one to three block-wide reductions.  The bound
// is the latency of that dependent chain of barriers.  The design keeps
// everything the chain touches in shared memory (3 iterates x 2 fields x
// N(A+1) knots plus the [N, A] marginal-value block: about 13 KB in f64 at
// N=7, A=32), so no step goes to device memory, and computes the 7x7
// expectation in its own body, as the TPU kernel does.  Lanes are
// independent blocks: a lane exits at its own convergence, and its bits do
// not depend on its batchmates.  One block per lane fills 12 of 132 SMs on
// the Table II sweep; spreading a lane over more SMs is later work.
//
// Compile without --use_fast_math and with --fmad=false: c^(-gamma) and
// x^(-1/gamma) set the policy, and every product-then-sum is rounded as
// the plain PyTorch version rounds it.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
egm_policy_kernel(const T* __restrict__ m0, const T* __restrict__ c0,
                  const T* __restrict__ a_g, const T* __restrict__ lvl_g,
                  const T* __restrict__ P_g, const T* __restrict__ scal,
                  T* __restrict__ m_out, T* __restrict__ c_out,
                  int* __restrict__ iters_out, T* __restrict__ diff_out,
                  int N, int A, T tol, int max_iter, int accel_every) {
  using ahtt::nan_max;
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int K = A + 1;
  const int NK = N * K;
  const int NA = N * A;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // shared layout: three iterates (policy, previous, new) x two fields,
  // the marginal values [N', A], and the lane's constants
  T* pol_m = sm;
  T* pol_c = pol_m + NK;
  T* prv_m = pol_c + NK;
  T* prv_c = prv_m + NK;
  T* new_m = prv_c + NK;
  T* new_c = new_m + NK;
  T* vp = new_c + NK;
  T* a = vp + NA;
  T* lvl = a + A;
  T* P = lvl + N;
  T* red = P + N * N;
  T* tree_a = red + 32;                   // pairwise-sum buffers
  T* tree_b = tree_a + ahtt::next_pow2(2 * NK);

  const T* m0l = m0 + (size_t)lane * NK;
  const T* c0l = c0 + (size_t)lane * NK;
  for (int j = tid; j < NK; j += nthr) {
    const T m = m0l[j], c = c0l[j];
    pol_m[j] = m; prv_m[j] = m; new_m[j] = m;
    pol_c[j] = c; prv_c[j] = c; new_c[j] = c;
  }
  for (int j = tid; j < A; j += nthr) a[j] = a_g[(size_t)lane * A + j];
  for (int j = tid; j < N; j += nthr) lvl[j] = lvl_g[(size_t)lane * N + j];
  for (int j = tid; j < N * N; j += nthr) P[j] = P_g[(size_t)lane * N * N + j];

  const T* s = scal + (size_t)lane * 5;
  const T R = s[0], W = s[1], beta = s[2], gam = s[3], b = s[4];
  const T ngam = -gam;
  const T ninv = T(-1) / gam;
  const T bR = beta * R;
  const T eps = T(1e-7);
  const T tiny = ahtt::Limits<T>::tiny();
  const T big = ahtt::Limits<T>::big();
  const T lam_max = T(0.995);
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
      vp[j] = ahtt::tpow(f0 + slope * (x - x0), ngam);
    }
    __syncthreads();
    // (2) expectation over next states, FOC inversion, endogenous knots
    for (int j = tid; j < NA; j += nthr) {
      const int st = j / A;
      const int i = j - st * A;
      T e = P[st * N] * vp[i];
      for (int sp = 1; sp < N; ++sp) e = e + P[st * N + sp] * vp[sp * A + i];
      const T cn = ahtt::tpow(bR * e, ninv);
      new_c[st * K + i + 1] = cn;
      new_m[st * K + i + 1] = a[i] + cn;
    }
    for (int st = tid; st < N; st += nthr) {
      new_c[st * K] = eps;
      new_m[st * K] = b + eps;
    }
    __syncthreads();
    // (3) sup-norm over both fields
    T dl = T(0);
    for (int j = tid; j < NK; j += nthr) {
      dl = nan_max(dl, (T)fabs(new_m[j] - pol_m[j]));
      dl = nan_max(dl, (T)fabs(new_c[j] - pol_c[j]));
    }
    const T d = ahtt::block_reduce(dl, red, ahtt::MaxOp());
    const bool accel = accel_every > 0 && ((it + 1) % accel_every) == 0;
    if (accel) {
      // Anderson rate over both fields, flattened m then c:
      // <d2,d1> / max(<d1,d1>, tiny), each dot a pairwise tree sum
      for (int j = tid; j < NK; j += nthr) {
        tree_a[j] = (new_m[j] - pol_m[j]) * (pol_m[j] - prv_m[j]);
        tree_a[NK + j] = (new_c[j] - pol_c[j]) * (pol_c[j] - prv_c[j]);
      }
      const T num = ahtt::tree_sum(tree_a, tree_b, 2 * NK);
      for (int j = tid; j < NK; j += nthr) {
        const T dm = pol_m[j] - prv_m[j];
        const T dc = pol_c[j] - prv_c[j];
        tree_a[j] = dm * dm;
        tree_a[NK + j] = dc * dc;
      }
      const T den = ahtt::tree_sum(tree_a, tree_b, 2 * NK);
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
  // the certified iterate is the last plain step (p0 if no step ran)
  for (int j = tid; j < NK; j += nthr) {
    m_out[(size_t)lane * NK + j] = new_m[j];
    c_out[(size_t)lane * NK + j] = new_c[j];
  }
  if (tid == 0) {
    iters_out[lane] = it;
    diff_out[lane] = diff;
  }
}

template <typename T>
size_t egm_smem_bytes(int N, int A) {
  const size_t K = (size_t)A + 1;
  const size_t p = (size_t)ahtt::next_pow2(2 * N * (A + 1));
  return (6 * (size_t)N * K + (size_t)N * A + A + N + (size_t)N * N + 32
          + p + p / 2) * sizeof(T);
}

template <typename T>
int launch(const void* m0, const void* c0, const void* a, const void* lvl,
           const void* P, const void* scal, void* m_out, void* c_out,
           void* iters, void* diff, int C, int N, int A, double tol,
           int max_iter, int accel_every, void* stream) {
  const size_t smem = egm_smem_bytes<T>(N, A);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        egm_policy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  egm_policy_kernel<T><<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)m0, (const T*)c0, (const T*)a, (const T*)lvl, (const T*)P,
      (const T*)scal, (T*)m_out, (T*)c_out, (int*)iters, (T*)diff, N, A,
      (T)tol, max_iter, accel_every);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one lane needs; the wrapper refuses sizes above the
// 227 KB a block may use.
unsigned long long egm_policy_grid_smem_bytes(int N, int A, int f64) {
  return f64 ? egm_smem_bytes<double>(N, A) : egm_smem_bytes<float>(N, A);
}

int egm_policy_grid_f32(const void* m0, const void* c0, const void* a,
                        const void* lvl, const void* P, const void* scal,
                        void* m_out, void* c_out, void* iters, void* diff,
                        int C, int N, int A, double tol, int max_iter,
                        int accel_every, void* stream) {
  return launch<float>(m0, c0, a, lvl, P, scal, m_out, c_out, iters, diff,
                       C, N, A, tol, max_iter, accel_every, stream);
}

int egm_policy_grid_f64(const void* m0, const void* c0, const void* a,
                        const void* lvl, const void* P, const void* scal,
                        void* m_out, void* c_out, void* iters, void* diff,
                        int C, int N, int A, double tol, int max_iter,
                        int accel_every, void* stream) {
  return launch<double>(m0, c0, a, lvl, P, scal, m_out, c_out, iters, diff,
                        C, N, A, tol, max_iter, accel_every, stream);
}

}  // extern "C"
