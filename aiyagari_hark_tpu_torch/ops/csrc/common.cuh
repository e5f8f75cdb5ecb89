// Helpers shared by the fixed-point kernels: NaN-propagating max, the
// exact pow overloads, and block-wide reductions in a fixed order.
//
// A reduction's order depends only on the data of its own block, so one
// lane's bits never depend on the other lanes of a launch or on the run
// (no atomics anywhere).
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace ahtt {

// finfo(T).tiny and finfo(T).max, usable in device code.
template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float big() { return FLT_MAX; }
};
template <> struct Limits<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double big() { return DBL_MAX; }
};

// jnp.max / jnp.maximum semantics: NaN wins.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// jnp.minimum semantics: NaN wins.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// pow in the iterate's own type, never a fast approximation.
__device__ __forceinline__ float tpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double tpow(double x, double y) { return pow(x, y); }

struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nan_max(a, b); }
};

// Block-wide reduction.  Every thread of the block must call it (it holds
// barriers) and every thread gets the same value: the warps reduce by a
// butterfly, then each thread folds the warp partials in warp order.
// `red` is shared scratch of at least blockDim.x / 32 elements.  The
// leading barrier also orders this call after every earlier read of `red`
// and after every shared or global write made before it.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, T* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nw; ++w) r = op(r, red[w]);
  return r;
}

// Smallest power of two >= m (m >= 1).
__host__ __device__ __forceinline__ int next_pow2(int m) {
  int p = 1;
  while (p < m) p <<= 1;
  return p;
}

// Bytes of one lane's row in a global workspace of `bytes` per lane: rows
// start 16-byte aligned (ops.kernels._workspace allocates the same).
__host__ __device__ __forceinline__ size_t ws_row_bytes(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Sum of a[0..m) by the pairwise tree the plain PyTorch versions use
// (household.pairwise_sum): pad with zeros to p = next_pow2(m), then level
// by level x[i] = x[2i] + x[2i+1].  Both engines therefore round every
// partial sum identically.  `a` holds p elements, `b` p/2; every thread of
// the block must call it, after writing its share of a[0..m).
template <typename T>
__device__ T tree_sum(T* a, T* b, int m) {
  const int p = next_pow2(m);
  for (int i = m + threadIdx.x; i < p; i += blockDim.x) a[i] = T(0);
  __syncthreads();
  T* src = a;
  T* dst = b;
  for (int len = p >> 1; len >= 1; len >>= 1) {
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      dst[i] = src[2 * i] + src[2 * i + 1];
    __syncthreads();
    T* t = src; src = dst; dst = t;
  }
  const T r = src[0];
  __syncthreads();   // every thread has read the sum before `a` is reused
  return r;
}

}  // namespace ahtt
