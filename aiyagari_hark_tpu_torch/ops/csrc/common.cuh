// Helpers shared by the fixed-point kernels: NaN-propagating max, the
// exact pow overloads, the explicitly rounded product, and block-wide
// reductions in a fixed order.
//
// A reduction's order depends only on the data of its own lane, so one
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

// pow in the iterate's own type, never a fast approximation.  The kernels
// are compiled with contraction on (--fmad=true), as PyTorch's own
// kernels are: libdevice's double pow then rounds as torch.pow does on
// the card.  Built without contraction, it differed from torch.pow on 4
// of the 779,520 inputs of the 12-cell f64 EGM check at the reference
// width, and the kernel from its plain version by up to 1.08e-12
// (scripts/torch_pow_probe.py shows both).
__device__ __forceinline__ float tpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double tpow(double x, double y) { return pow(x, y); }

// A product rounded on its own.  With contraction on, `a * b + c` may be
// fused into one fma; every product the kernels write goes through mul
// (an explicitly rounded multiply, never fused), so it rounds as
// PyTorch's separate elementwise kernels round it.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// Block-wide NaN-propagating max of values >= +0 (so no -0 and the order
// of the folds changes no bit) into a fresh buffer, with one barrier: the
// warps reduce by a butterfly, then every warp folds the warp partials by
// a butterfly too.  Every thread of the block must call it and gets the
// same value; the barrier also orders every shared or global write made
// before it.  `red` is shared scratch of blockDim.x / 32 elements that no
// thread may still be reading: a caller that reduces once per step
// alternates two buffers.
template <typename T>
__device__ __forceinline__ T block_max_fresh(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[lane < nw ? lane : 0];
  for (int o = 16; o > 0; o >>= 1)
    r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, o));
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

// Sum of m leaves by the pairwise tree the plain PyTorch versions use
// (household.pairwise_sum: pad with zeros to p = next_pow2(m), then level
// by level x[i] = x[2i] + x[2i+1]), without a buffer.  Let nt =
// min(blockDim.x, p) threads each own p / nt contiguous leaves (zeros past
// m): a thread sums its chunk pairwise in registers (chunk_pairwise),
// which gives one node of the tree, and tree_combine joins the nt nodes
// level by level with warp shuffles -- at offset o, lane 2jo adds lane
// 2jo+o, exactly the tree's neighbours -- then the warp partials the same
// way in every warp.  IEEE addition is commutative, so every partial sum
// rounds as in pairwise_sum.
constexpr int kChunkLevels = 16;   // a chunk holds at most 2^16 leaves

// Pairwise sum of leaf(lo), ..., leaf(lo + len - 1), len a power of two,
// as a binary counter: acc[lv] keeps the pending left subtree of 2^lv
// leaves.  The levels are unrolled, so acc lives in registers.
template <typename T, typename Leaf>
__device__ __forceinline__ T chunk_pairwise(Leaf leaf, int lo, int len) {
  T acc[kChunkLevels];
  T v = T(0);
  for (int i = 0; i < len; ++i) {
    v = leaf(lo + i);
#pragma unroll
    for (int lv = 0; lv < kChunkLevels; ++lv) {
      if (((i >> lv) & 1) == 0) {
        acc[lv] = v;
        break;
      }
      v = acc[lv] + v;
    }
  }
  return v;   // after the last leaf: the whole chunk
}

// Pairwise levels of `width` consecutive lanes (a power of two <= 32):
// lane 0 of each group ends with the group's subtree.
template <typename T>
__device__ __forceinline__ T warp_tree(T v, int width) {
  for (int o = 1; o < width; o <<= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The root of the tree whose nodes threads 0..nt-1 hold (nt a power of two
// <= blockDim.x <= 1024; other threads pass anything).  Every thread of the
// block must call it and gets the root; one barrier.  `part` is shared
// scratch of blockDim.x / 32 elements that no thread may still be reading.
template <typename T>
__device__ __forceinline__ T tree_combine(T v, int nt, T* part) {
  const int lane = threadIdx.x & 31;
  v = warp_tree(v, nt < 32 ? nt : 32);
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = nt > 32 ? nt >> 5 : 1;
  T u = lane < nw ? part[lane] : T(0);
  u = warp_tree(u, nw);
  return __shfl_sync(0xffffffffu, u, 0);
}

}  // namespace ahtt
