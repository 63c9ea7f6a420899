// ΔTree walk kernels for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/veb_search.py:
//   veb_walk_fused  <- veb_search.py::veb_walk_fused (_fused_kernel)
//   veb_walk_rows   <- veb_search.py::veb_walk_rows  (_kernel)
// The plain PyTorch versions beside them are
// src/repro_torch/kernels/ref.py::ref_delta_walk_fused / ref_veb_walk_rows;
// results are bit-identical integers.
//
// What bounds them on an H100: a walk needs, per visited ΔNode, the H router
// values on its descent path plus one child id; that is all it must move.
// Each of those loads depends on the one before it (the next position is
// computed from the router just read), so at the main path's batch of 1024
// queries the fused walk is bound by latency: hops x H dependent loads from
// device memory (or L2) per lane, with far too few lanes in flight to cover
// them.  This first design does nothing about that: one thread per query,
// the arena read in place from device memory, no staging of the hot top
// ΔNodes in shared memory, no cooperative row loads.  Only the vEB position
// table (2**H int32) is staged in shared memory, once per block.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include "veb_common.cuh"

namespace {

using veb::Big;
using veb::kMaxHeight;
using veb::kThreads;
using veb::stage_pos;

// All walk rounds in one launch.  Per lane: a blind descent of H router
// loads through the vEB position table (EMPTY routes right), last-occupied
// tracking, the post-hoc fold of left-turn routers into the successor
// candidate, then the bottom-slot child hop.  A lane loops until its walk
// ends inside a ΔNode or it has run max_rounds rounds; a query equal to the
// sentinel is born resolved.  A resolved lane's state never changes again,
// so these per-lane loops give the Pallas kernel's tile-wide loop results.
template <typename T>
__global__ void __launch_bounds__(kThreads)
walk_fused_kernel(const T* __restrict__ value, const int32_t* __restrict__ child,
                  const int32_t* __restrict__ roots, const T* __restrict__ queries,
                  const int32_t* __restrict__ pos, int k, int m, int ub, int lc,
                  int height, int max_rounds, T* __restrict__ leaf_val_out,
                  int32_t* __restrict__ leaf_b_out, int32_t* __restrict__ final_dn_out,
                  int32_t* __restrict__ hops_out, T* __restrict__ cand_out) {
  extern __shared__ int s_pos[];
  stage_pos(s_pos, pos, 1 << height);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;

  const T big = Big<T>::value;
  const int bottom0 = 1 << (height - 1);
  const T v = queries[i];
  int dn = roots[i];
  bool resolved = (v == big);
  T leaf_val = 0;
  int leaf_b = 1;
  int final_dn = dn;
  int hops = 0;
  T cand = big;

  for (int r = 0; r < max_rounds && !resolved; ++r) {
    const int dnc = min(max(dn, 0), m - 1);
    const veb::Descent<T> d =
        veb::descend(value + static_cast<int64_t>(dnc) * ub, s_pos, v, height);
    const int lb = d.lb;
    const int nxt = lb >= bottom0
        ? child[static_cast<int64_t>(dnc) * lc + (lb - bottom0)] : -1;
    ++hops;
    if (d.rcand < cand) cand = d.rcand;
    if (nxt < 0) {
      resolved = true;
      leaf_val = d.lv;
      leaf_b = lb;
      final_dn = dn;
    } else {
      dn = nxt;
    }
  }
  leaf_val_out[i] = leaf_val;
  leaf_b_out[i] = leaf_b;
  final_dn_out[i] = final_dn;
  hops_out[i] = hops;
  cand_out[i] = cand;
}

// One full in-ΔNode descent per query over rows gathered by the caller
// (rows (K, ubp), childrows (K, cp)): H-1 levels of router + left-child
// loads, then the leaf and its bottom-slot child.
template <typename T>
__global__ void __launch_bounds__(kThreads)
walk_rows_kernel(const T* __restrict__ rows, const int32_t* __restrict__ childrows,
                 const T* __restrict__ queries, const int32_t* __restrict__ pos,
                 int k, int ubp, int cp, int height, T* __restrict__ leaf_val_out,
                 int32_t* __restrict__ leaf_b_out, int32_t* __restrict__ next_dn_out,
                 T* __restrict__ cand_out) {
  extern __shared__ int s_pos[];
  stage_pos(s_pos, pos, 1 << height);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;

  const T big = Big<T>::value;
  const int bottom0 = 1 << (height - 1);
  const T v = queries[i];
  const T* row = rows + static_cast<int64_t>(i) * ubp;
  int b = 1;
  T cand = big;
  for (int l = 0; l < height - 1; ++l) {
    const T router = row[s_pos[b]];
    const T left = row[s_pos[min(2 * b, 2 * bottom0 - 1)]];
    const bool internal = b < bottom0 && left != 0;
    const bool go_right = v >= router;
    if (internal && !go_right && router < cand) cand = router;
    if (internal) b = 2 * b + (go_right ? 1 : 0);
  }
  leaf_val_out[i] = row[s_pos[b]];
  leaf_b_out[i] = b;
  next_dn_out[i] = b >= bottom0
      ? childrows[static_cast<int64_t>(i) * cp + (b - bottom0)] : -1;
  cand_out[i] = cand;
}

template <typename T>
int launch_fused(const void* value, const void* child, const void* roots,
                 const void* queries, const void* pos, int k, int m, int ub, int lc,
                 int height, int max_rounds, void* leaf_val, void* leaf_b,
                 void* final_dn, void* hops, void* cand, void* stream) {
  if (height < 1 || height > kMaxHeight) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    const int blocks = (k + kThreads - 1) / kThreads;
    const size_t smem = sizeof(int) << height;
    walk_fused_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(value), static_cast<const int32_t*>(child),
        static_cast<const int32_t*>(roots), static_cast<const T*>(queries),
        static_cast<const int32_t*>(pos), k, m, ub, lc, height, max_rounds,
        static_cast<T*>(leaf_val), static_cast<int32_t*>(leaf_b),
        static_cast<int32_t*>(final_dn), static_cast<int32_t*>(hops),
        static_cast<T*>(cand));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* rows, const void* childrows, const void* queries,
                const void* pos, int k, int ubp, int cp, int height, void* leaf_val,
                void* leaf_b, void* next_dn, void* cand, void* stream) {
  if (height < 1 || height > kMaxHeight) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    const int blocks = (k + kThreads - 1) / kThreads;
    const size_t smem = sizeof(int) << height;
    walk_rows_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(rows), static_cast<const int32_t*>(childrows),
        static_cast<const T*>(queries), static_cast<const int32_t*>(pos), k, ubp, cp,
        height, static_cast<T*>(leaf_val), static_cast<int32_t*>(leaf_b),
        static_cast<int32_t*>(next_dn), static_cast<T*>(cand));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int veb_walk_fused_i32(const void* value, const void* child, const void* roots,
                       const void* queries, const void* pos, int k, int m, int ub,
                       int lc, int height, int max_rounds, void* leaf_val, void* leaf_b,
                       void* final_dn, void* hops, void* cand, void* stream) {
  return launch_fused<int32_t>(value, child, roots, queries, pos, k, m, ub, lc, height,
                               max_rounds, leaf_val, leaf_b, final_dn, hops, cand, stream);
}

int veb_walk_fused_i64(const void* value, const void* child, const void* roots,
                       const void* queries, const void* pos, int k, int m, int ub,
                       int lc, int height, int max_rounds, void* leaf_val, void* leaf_b,
                       void* final_dn, void* hops, void* cand, void* stream) {
  return launch_fused<int64_t>(value, child, roots, queries, pos, k, m, ub, lc, height,
                               max_rounds, leaf_val, leaf_b, final_dn, hops, cand, stream);
}

int veb_walk_rows_i32(const void* rows, const void* childrows, const void* queries,
                      const void* pos, int k, int ubp, int cp, int height, void* leaf_val,
                      void* leaf_b, void* next_dn, void* cand, void* stream) {
  return launch_rows<int32_t>(rows, childrows, queries, pos, k, ubp, cp, height, leaf_val,
                              leaf_b, next_dn, cand, stream);
}

int veb_walk_rows_i64(const void* rows, const void* childrows, const void* queries,
                      const void* pos, int k, int ubp, int cp, int height, void* leaf_val,
                      void* leaf_b, void* next_dn, void* cand, void* stream) {
  return launch_rows<int64_t>(rows, childrows, queries, pos, k, ubp, cp, height, leaf_val,
                              leaf_b, next_dn, cand, stream);
}

}  // extern "C"
