// ΔTree emit-cursor range-scan kernel for Hopper (sm_90a), bound through a
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/veb_search.py::
// veb_scan_fused (body _scan_kernel).  Its plain PyTorch version is
// src/repro_torch/kernels/ref.py::ref_delta_scan_fused, which documents the
// FIND / VERIFY pass logic; results are bit-identical integers.
//
// What bounds it on an H100: per lane, every emitted item costs two root-to-
// leaf walks (FIND for the next candidate, VERIFY of that candidate), each
// round of a walk H dependent router loads plus one child id.  A dense lane
// at max_out = 128 runs over a thousand rounds in sequence, so at the main
// path's batch (512 lanes, fewer threads than the card has cores) the scan is
// bound by the latency of those dependent loads, mostly L2 hits after the
// first pass (consecutive passes revisit the same top ΔNodes); the bytes it
// must move (the distinct routers, child ids and marks its lanes touch, plus
// inputs and outputs) take microseconds.  This first design does nothing
// about that: one thread per lane, each looping on its own lane, the arena
// read in place, only the vEB position table staged in shared memory.
// Staging the hot top ΔNodes and cooperative row loads are later work.
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

// One thread per lane.  Each lane runs its own round loop: a round is one
// blind descent of its current ΔNode (veb::descend) and the child hop; a
// resolved FIND pass folds the live leaf and either ends the lane or starts
// a VERIFY pass for the candidate; a resolved VERIFY pass emits a live hit
// (or sets `more` when the row is full) or chases a tombstone, then starts
// the next FIND pass.  A done lane's state never changes in the Pallas
// kernel's tile-wide loop, so per-lane loops give its results; a lane that
// reaches max_rounds keeps its partial row with `more` false.  Rows are
// written straight to out[lane * max_out + n], and padded with the sentinel
// after the loop.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_fused_kernel(const T* __restrict__ value, const uint8_t* __restrict__ mark,
                  const int32_t* __restrict__ child, const int32_t* __restrict__ roots,
                  const T* __restrict__ starts, const T* __restrict__ his,
                  const int32_t* __restrict__ pos, int k, int m, int ub, int lc,
                  int height, int max_out, int max_rounds, T pmask,
                  T* __restrict__ out, int32_t* __restrict__ n_out,
                  int32_t* __restrict__ hops_out, uint8_t* __restrict__ more_out) {
  extern __shared__ int s_pos[];
  stage_pos(s_pos, pos, 1 << height);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;

  const T big = Big<T>::value;
  const int bottom0 = 1 << (height - 1);
  const int dn0 = roots[i];
  const T hi = his[i];
  T* row_out = out + static_cast<int64_t>(i) * max_out;
  int dn = dn0;
  bool verify = false;
  T q = starts[i];        // FIND: the cursor; VERIFY: the candidate (qpack)
  T cursor = q;           // the start, then the last emitted key (qpack)
  T cand = big;
  int n = 0, hops = 0;
  bool more = false;
  bool done = (q == big);  // sentinel lanes are born done

  for (int r = 0; r < max_rounds && !done; ++r) {
    const int dnc = min(max(dn, 0), m - 1);
    const int64_t base = static_cast<int64_t>(dnc) * ub;
    const veb::Descent<T> d = veb::descend(value + base, s_pos, q, height);
    const int nxt = d.lb >= bottom0
        ? child[static_cast<int64_t>(dnc) * lc + (d.lb - bottom0)] : -1;
    ++hops;
    if (!verify && d.rcand < cand) cand = d.rcand;
    if (nxt >= 0) {           // the pass goes on in the child ΔNode
      dn = nxt;
      continue;
    }
    const bool leaf_live = d.lv != 0 && mark[base + s_pos[d.lb]] == 0;
    if (!verify) {            // FIND resolved: fold the leaf, stop or verify
      if (leaf_live && d.lv > cursor && d.lv < cand) cand = d.lv;
      if (cand == big || cand > hi) {
        done = true;
        continue;
      }
      q = cand | pmask;
      verify = true;
    } else {                  // VERIFY resolved: emit a live hit, or chase
      if (leaf_live && (d.lv | pmask) == q) {
        if (n >= max_out) {
          more = true;
          done = true;
          continue;
        }
        row_out[n++] = d.lv;
      }
      cursor = q;
      verify = false;
    }
    dn = dn0;
    cand = big;
  }
  for (int j = n; j < max_out; ++j) row_out[j] = big;
  n_out[i] = n;
  hops_out[i] = hops;
  more_out[i] = more ? 1 : 0;
}

template <typename T>
int launch_scan(const void* value, const void* mark, const void* child, const void* roots,
                const void* starts, const void* his, const void* pos, int k, int m, int ub,
                int lc, int height, int max_out, int max_rounds, long long pmask, void* out,
                void* n, void* hops, void* more, void* stream) {
  if (height < 1 || height > kMaxHeight || max_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    const int blocks = (k + kThreads - 1) / kThreads;
    const size_t smem = sizeof(int) << height;
    scan_fused_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(value), static_cast<const uint8_t*>(mark),
        static_cast<const int32_t*>(child), static_cast<const int32_t*>(roots),
        static_cast<const T*>(starts), static_cast<const T*>(his),
        static_cast<const int32_t*>(pos), k, m, ub, lc, height, max_out, max_rounds,
        static_cast<T>(pmask), static_cast<T*>(out), static_cast<int32_t*>(n),
        static_cast<int32_t*>(hops), static_cast<uint8_t*>(more));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int veb_scan_fused_i32(const void* value, const void* mark, const void* child,
                       const void* roots, const void* starts, const void* his,
                       const void* pos, int k, int m, int ub, int lc, int height,
                       int max_out, int max_rounds, long long pmask, void* out, void* n,
                       void* hops, void* more, void* stream) {
  return launch_scan<int32_t>(value, mark, child, roots, starts, his, pos, k, m, ub, lc,
                              height, max_out, max_rounds, pmask, out, n, hops, more,
                              stream);
}

int veb_scan_fused_i64(const void* value, const void* mark, const void* child,
                       const void* roots, const void* starts, const void* his,
                       const void* pos, int k, int m, int ub, int lc, int height,
                       int max_out, int max_rounds, long long pmask, void* out, void* n,
                       void* hops, void* more, void* stream) {
  return launch_scan<int64_t>(value, mark, child, roots, starts, his, pos, k, m, ub, lc,
                              height, max_out, max_rounds, pmask, out, n, hops, more,
                              stream);
}

}  // extern "C"
