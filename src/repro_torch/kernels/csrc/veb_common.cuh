// Helpers shared by the ΔTree kernels for Hopper (veb_walk.cu, veb_scan.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace veb {

constexpr int kMaxHeight = 12;   // pos table 2**12 int32 = 16 KB of shared memory
constexpr int kThreads = 256;    // chosen without measurement

// The successor-candidate identity and the walk sentinel of a row dtype: the
// tree's ROUTE_LEFT (int32: INT32_MAX; packed int64 map mode: 1 << 62).
template <typename T> struct Big;
template <> struct Big<int32_t> { static constexpr int32_t value = 2147483647; };
template <> struct Big<int64_t> { static constexpr int64_t value = int64_t(1) << 62; };

// Copies the vEB position table (n int32) into the block's shared memory.
__device__ __forceinline__ void stage_pos(int* s_pos, const int* pos, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) s_pos[j] = pos[j];
  __syncthreads();
}

// The result of one blind descent through a ΔNode row.
template <typename T> struct Descent {
  int lb;     // last occupied BFS position: the leaf the eager walk stops at
  T lv;       // the value stored there (0 = EMPTY when nothing is occupied)
  T rcand;    // min left-turn router above it (Big when none)
};

// One blind descent of query v through `row` (vEB order): H router loads
// through the position table, always routing right through EMPTY (0), with
// last-occupied tracking; then the post-hoc fold of the routers passed on a
// left turn into the successor candidate.  The H routers stay in a fully
// unrolled register array.
template <typename T>
__device__ __forceinline__ Descent<T> descend(const T* __restrict__ row,
                                              const int* s_pos, T v, int height) {
  const int bottom0 = 1 << (height - 1);
  T routers[kMaxHeight];
  int bs[kMaxHeight];
  int b = 1, lb = 1;
  T lv = 0;
#pragma unroll
  for (int l = 0; l < kMaxHeight; ++l) {
    if (l < height) {
      const T router = row[s_pos[b]];
      routers[l] = router;
      bs[l] = b;
      if (router != 0) { lb = b; lv = router; }
      if (b < bottom0) b = 2 * b + (v >= router ? 1 : 0);
    }
  }
  T rcand = Big<T>::value;
#pragma unroll
  for (int l = 0; l < kMaxHeight; ++l) {
    if (l < height) {
      const T router = routers[l];
      if (router != 0 && bs[l] != lb && v < router && router < rcand) rcand = router;
    }
  }
  return Descent<T>{lb, lv, rcand};
}

}  // namespace veb
