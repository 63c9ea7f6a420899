// ΔTree emit-cursor range-scan kernel for Hopper (sm_90a), bound through a
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/veb_search.py::
// veb_scan_fused (body _scan_kernel).  Its plain PyTorch version is
// src/repro_torch/kernels/ref.py::ref_delta_scan_fused, which documents the
// FIND / VERIFY passes; the four outputs (out, n, hops, more) are
// bit-identical to it.  tests/test_torch_scan_lane.py holds a per-lane
// Python model of the loop below against it on the CPU.
//
// The plain version walks every pass from the lane's root, one ΔNode a
// round: FIND(cursor) gives a candidate, VERIFY(candidate) settles it, and
// the FIND that follows walks the same query again.  This design keeps
// every output and walks far less:
//
// * One walk an item.  VERIFY(q) and the FIND(q) after it descend the same
//   query from the same root, so one walk settles both: its leaf decides
//   the item, and the left-turn routers folded on the way, with the leaf,
//   give the next candidate.  `hops` adds the path's length twice, as the
//   plain version counts it.
// * Passes restart where the path diverges.  The next query q' is above q,
//   so both descend alike through every router outside (q, q'].  Warp
//   lane t keeps entry t of the lane's last path: the ΔNode, the smallest
//   internal router above q on its descent, and the fold of the ΔNodes
//   above it.  A ballot finds the first ΔNode with a router in (q, q'];
//   the pass restarts there with the fold above it and counts the ΔNodes
//   above as rounds.  With no such ΔNode it restarts at the deepest one
//   held: the last of the path, or entry kStack - 1 of a deeper path.
// * ΔNode rows in shared memory.  A lane is a warp.  It loads a row (every
//   slot's value and mark, and the child ids) in one coalesced sweep,
//   stores it in BFS order and descends over shared memory, each thread
//   repeating the same descent so that nothing is broadcast.  Four lanes
//   share a block (kLanes; on an H100 1, 2 and 4 read alike, 8 and 16
//   slower), fewer where tall rows would overfill the shared memory.  The
//   root row of a block's first lane is staged once per block; a restart
//   in the row already held loads nothing.
// * The cap.  A walk that would run past max_rounds stops: the lane keeps
//   the row it had, with hops = max_rounds and more false, as the plain
//   version stops it.
// * Tall ΔNodes (height > veb::kSmemHeight, up to veb::kMaxHeight = 30:
//   Table 1's UB=N tree is 22) fit no shared memory: the kTall
//   instantiation reads value, mark and child in place, each slot through
//   the position table in global memory (InPlace), and allocates nothing
//   a lane.  The passes, restarts and the cap are the same code.
//
// What bounds it on an H100: latency, not bytes (the distinct rows read,
// inputs and outputs move in well under a microsecond).  A lane waits on
// one global row load (an L2 or HBM round trip) for each ΔNode new to its
// path, and on a serial chain for each item once its path settles: a
// descent of H dependent shared-memory loads, the leaf's mark and child,
// a ballot and two shuffles (≈ 0.6 µs an item at height 7 on an H100
// SXM).  A batch of 512 lanes occupies 512 of the card's 8448 warp
// slots, so nothing hides either wait.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <type_traits>

#include "veb_common.cuh"

namespace {

using veb::Big;
using veb::kMaxHeight;
using veb::kSmemHeight;

constexpr int kStack = 32;              // path entries a lane keeps: one a warp lane
constexpr int kLanes = 4;               // lanes (warps) a block, fewer where rows fill
                                        // the shared memory (3 at height 12, int64)
constexpr int kMaxSmem = 232448;        // a block's shared memory on sm_90 (227 KB)
constexpr int kDefaultSmem = 48 * 1024;  // above this only after the opt-in
constexpr unsigned kFull = 0xffffffffu;

// The identity of a "smallest router above q" (no such router).
template <typename T> struct Top;
template <> struct Top<int32_t> { static constexpr int32_t value = 2147483647; };
template <> struct Top<int64_t> { static constexpr int64_t value = 9223372036854775807LL; };

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Bytes of one staged ΔNode row: values and marks by BFS slot (slot 0
// unused), then the bottom slots' child ids.
__host__ __device__ inline int row_bytes(int height, int elt) {
  const int nb = 1 << height;
  return align16(nb * elt) + align16(nb) + align16((nb >> 1) * 4);
}

// A block's dynamic shared memory: the storage-to-BFS table, the staged
// root row and one row a lane.
__host__ __device__ inline int smem_bytes(int height, int elt, int lanes) {
  return align16((1 << height) * 4) + (lanes + 1) * row_bytes(height, elt);
}

// A ΔNode row staged in shared memory, by BFS slot.
template <typename T> struct Row {
  T* val;          // val[b]: the router at BFS slot b
  uint8_t* mark;   // mark[b]: its deletion mark
  int32_t* child;  // child[b - bottom0]: the ΔNode below bottom slot b
  __device__ __forceinline__ T v(int b) const { return val[b]; }
  __device__ __forceinline__ uint8_t m(int b) const { return mark[b]; }
  __device__ __forceinline__ int32_t c(int j) const { return child[j]; }
};

// A ΔNode row read in place from the arena (tall ΔNodes): BFS slot b is
// storage slot pos[b].
template <typename T> struct InPlace {
  const T* val;
  const uint8_t* mark;
  const int32_t* child;
  const int32_t* pos;
  __device__ __forceinline__ T v(int b) const { return val[pos[b]]; }
  __device__ __forceinline__ uint8_t m(int b) const { return mark[pos[b]]; }
  __device__ __forceinline__ int32_t c(int j) const { return child[j]; }
};

template <typename T>
__device__ __forceinline__ Row<T> row_at(unsigned char* p, int height) {
  const int nb = 1 << height;
  Row<T> r;
  r.val = reinterpret_cast<T*>(p);
  r.mark = p + align16(nb * static_cast<int>(sizeof(T)));
  r.child = reinterpret_cast<int32_t*>(p + align16(nb * static_cast<int>(sizeof(T))) +
                                       align16(nb));
  return r;
}

// Copies ΔNode dn's row into `r`, thread t of nt: values and marks from vEB
// storage order into BFS order (s_bfs), child ids as they are.  Each thread
// issues a sweep's loads before its stores, so a row of up to 4 * nt
// slots costs one round trip.
template <typename T>
__device__ __forceinline__ void load_row(const Row<T>& r, const T* __restrict__ value,
                                         const uint8_t* __restrict__ mark,
                                         const int32_t* __restrict__ child,
                                         const int* s_bfs, int dn, int ub, int lc, int t,
                                         int nt) {
  const T* vrow = value + static_cast<int64_t>(dn) * ub;
  const uint8_t* mrow = mark + static_cast<int64_t>(dn) * ub;
  const int32_t* crow = child + static_cast<int64_t>(dn) * lc;
  for (int j0 = 0; j0 < ub; j0 += 4 * nt) {
    T v[4];
    uint8_t mk[4];
    int32_t c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * nt + t;
      if (j < ub) {
        v[u] = vrow[j];
        mk[u] = mrow[j];
      }
      if (j < lc) c[u] = crow[j];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * nt + t;
      if (j < ub) {
        const int b = s_bfs[j];
        r.val[b] = v[u];
        r.mark[b] = mk[u];
      }
      if (j < lc) r.child[j] = c[u];
    }
  }
}

// One warp a lane; every thread of the warp runs the lane's loop on the
// same values, so control flow stays uniform and ballots and shuffles see
// the whole warp.  Thread t holds entry t of the path stack in registers.
// kTall: rows are read in place (InPlace) and nothing is staged.
template <typename T, bool kTall>
__global__ void __launch_bounds__(kLanes * 32)
scan_fused_kernel(const T* __restrict__ value, const uint8_t* __restrict__ mark,
                  const int32_t* __restrict__ child, const int32_t* __restrict__ roots,
                  const T* __restrict__ starts, const T* __restrict__ his,
                  const int32_t* __restrict__ pos, int k, int m, int height, int max_out,
                  int max_rounds, T pmask, T* __restrict__ out, int32_t* __restrict__ n_out,
                  int32_t* __restrict__ hops_out, uint8_t* __restrict__ more_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  using R = std::conditional_t<kTall, InPlace<T>, Row<T>>;
  const int ub = (1 << height) - 1, lc = 1 << (height - 1), bottom0 = lc;
  const int lanes = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int first = blockIdx.x * lanes;
  int* s_bfs = nullptr;
  Row<T> root_row{}, own{};
  int root_dn = -1;  // the staged root's ΔNode (none for kTall)
  if constexpr (!kTall) {
    s_bfs = reinterpret_cast<int*>(smem);
    unsigned char* rows = smem + align16((1 << height) * 4);
    const int rb = row_bytes(height, sizeof(T));
    root_row = row_at<T>(rows, height);
    own = row_at<T>(rows + (1 + w) * rb, height);
    for (int b = threadIdx.x + 1; b <= ub; b += blockDim.x) s_bfs[pos[b]] = b;
    root_dn = min(max(roots[min(first, k - 1)], 0), m - 1);
    __syncthreads();
    load_row(root_row, value, mark, child, s_bfs, root_dn, ub, lc, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  const int i = first + w;
  if (i >= k) return;

  const T big = Big<T>::value;
  const T start = starts[i], hi = his[i];
  const int dn0 = min(max(roots[i], 0), m - 1);
  T* row_out = out + static_cast<int64_t>(i) * max_out;
  int n = 0, hops = 0;
  bool more = false;
  int st_dn = dn0;           // entry t: the ΔNode at depth t of the last path,
  T st_gt = Top<T>::value;   // the smallest internal router above q on it,
  T st_above = big;          // and the fold of the ΔNodes above it
  int own_dn = -1;           // the ΔNode held in `own`
  if (start != big && max_rounds > 0) {
    T q = start;             // the first pass: FIND(start); then VERIFY + FIND(q)
    int j = 0, dn = dn0;     // where the pass starts: depth and ΔNode
    T fold = big;            // the fold of the ΔNodes above depth j
    bool verify = false;
    for (;;) {
      const int budget = max_rounds - hops;
      int depth = j, lb = 1;
      T lv = 0;
      R r{};
      bool cut = false;
      for (;;) {             // one ΔNode a round, as the plain version counts
        if (++depth > budget) {
          cut = true;
          break;
        }
        if constexpr (kTall) {
          r = InPlace<T>{value + static_cast<int64_t>(dn) * ub,
                         mark + static_cast<int64_t>(dn) * ub,
                         child + static_cast<int64_t>(dn) * lc, pos};
        } else if (dn == own_dn) {
          r = own;
        } else if (dn == root_dn) {
          r = root_row;
        } else {
          __syncwarp();
          load_row(own, value, mark, child, s_bfs, dn, ub, lc, t, 32);
          __syncwarp();
          own_dn = dn;
          r = own;
        }
        // the blind descent of ref.ref_delta_walk_fused over the row,
        // folding each occupied router once a later one replaces it
        // as the leaf
        int b = 1;
        lb = 1;
        lv = 0;
        T rc = big, gt = Top<T>::value;
        for (int l = 0; l < height; ++l) {
          const T x = r.v(b);
          if (x != 0) {
            if (lv != 0 && q < lv && lv < rc) rc = lv;
            lb = b;
            lv = x;
          }
          if (b < bottom0) {
            if (q < x && x < gt) gt = x;
            b = 2 * b + (q >= x ? 1 : 0);
          }
        }
        if (t == depth - 1) {
          st_dn = dn;
          st_gt = gt;
          st_above = fold;
        }
        if (rc < fold) fold = rc;
        const int nxt = lb >= bottom0 ? r.c(lb - bottom0) : -1;
        if (nxt < 0) break;
        dn = min(max(nxt, 0), m - 1);
      }
      if (cut) {
        hops = max_rounds;
        break;
      }
      const int len = depth;
      hops += len;
      const bool live = lv != 0 && r.m(lb) == 0;
      if (verify) {          // VERIFY settles: emit, fill the row, or chase
        if (live && (lv | pmask) == q) {
          if (n >= max_out) {
            more = true;
            break;
          }
          if (t == 0) row_out[n] = lv;
          ++n;
        }
        if (len > max_rounds - hops) {
          hops = max_rounds;
          break;
        }
        hops += len;         // the FIND from the new cursor q: the same path
      }
      T cand = fold;
      if (live && q < lv && lv < cand) cand = lv;
      if (cand == big || cand > hi) break;
      const T qn = cand | pmask;
      const unsigned div = __ballot_sync(kFull, t < min(len, kStack) && st_gt <= qn);
      j = div ? __ffs(div) - 1 : min(len, kStack) - 1;
      dn = __shfl_sync(kFull, st_dn, j);
      fold = __shfl_sync(kFull, st_above, j);
      q = qn;
      verify = true;
    }
  }
  for (int c = n + t; c < max_out; c += 32) row_out[c] = big;
  if (t == 0) {
    n_out[i] = n;
    hops_out[i] = hops;
    more_out[i] = more ? 1 : 0;
  }
}

template <typename T>
int launch_scan(const void* value, const void* mark, const void* child, const void* roots,
                const void* starts, const void* his, const void* pos, int k, int m,
                int height, int max_out, int max_rounds, long long pmask, void* out,
                void* n, void* hops, void* more, void* stream) {
  if (height < 1 || height > kMaxHeight || max_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    const bool tall = height > kSmemHeight;
    int lanes = kLanes;
    while (!tall && lanes > 1 && smem_bytes(height, sizeof(T), lanes) > kMaxSmem) --lanes;
    const int smem = tall ? 0 : smem_bytes(height, sizeof(T), lanes);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    auto* fn = tall ? scan_fused_kernel<T, true> : scan_fused_kernel<T, false>;
    if (smem > kDefaultSmem) {
      const cudaError_t e =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (k + lanes - 1) / lanes;
    fn<<<blocks, lanes * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(value), static_cast<const uint8_t*>(mark),
        static_cast<const int32_t*>(child), static_cast<const int32_t*>(roots),
        static_cast<const T*>(starts), static_cast<const T*>(his),
        static_cast<const int32_t*>(pos), k, m, height, max_out, max_rounds,
        static_cast<T>(pmask), static_cast<T*>(out), static_cast<int32_t*>(n),
        static_cast<int32_t*>(hops), static_cast<uint8_t*>(more));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int veb_scan_fused_i32(const void* value, const void* mark, const void* child,
                       const void* roots, const void* starts, const void* his,
                       const void* pos, int k, int m, int height, int max_out,
                       int max_rounds, long long pmask, void* out, void* n, void* hops,
                       void* more, void* stream) {
  return launch_scan<int32_t>(value, mark, child, roots, starts, his, pos, k, m, height,
                              max_out, max_rounds, pmask, out, n, hops, more, stream);
}

int veb_scan_fused_i64(const void* value, const void* mark, const void* child,
                       const void* roots, const void* starts, const void* his,
                       const void* pos, int k, int m, int height, int max_out,
                       int max_rounds, long long pmask, void* out, void* n, void* hops,
                       void* more, void* stream) {
  return launch_scan<int64_t>(value, mark, child, roots, starts, his, pos, k, m, height,
                              max_out, max_rounds, pmask, out, n, hops, more, stream);
}

}  // extern "C"
