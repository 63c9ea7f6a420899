// ΔTree walk kernels for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/veb_search.py:
//   veb_walk_fused  <- veb_search.py::veb_walk_fused (_fused_kernel)
//   veb_walk_rows   <- veb_search.py::veb_walk_rows  (_kernel)
// The plain PyTorch versions beside them are
// src/repro_torch/kernels/ref.py::ref_delta_walk_fused / ref_veb_walk_rows;
// results are bit-identical integers.  tests/test_torch_walk_lane.py holds a
// per-lane Python model of both kernels' loops against them on the CPU.
//
// What bounds them on an H100: latency, not bytes.  A walk needs, per
// visited ΔNode, the H routers on its path and one child id, and which
// router comes next depends on the one before.  Read router by router, a
// Fig. 12 search (5.0 ΔNodes of height 7) waits on about 40 dependent
// loads, and at the main path's batch of 1024 far too few lanes are in
// flight to hide them.  This design shortens the chain, one thread a
// query:
//
// * Walk vEB pieces, not routers.  A row is stored in vEB order, so a path
//   through a ΔNode crosses one contiguous piece of at most 15 slots at
//   each level of the vEB split (veb::piece_plan: 1 piece for H <= 4, 2 for
//   H = 5..8, 3 for H = 9, 4 for H = 10..16, up to 8 above).  A lane loads a whole piece
//   in one round trip (16-byte loads issued together, veb::load_run) and
//   descends through it in registers; with the last piece it also loads
//   the child ids of that piece's leaves, so the hop costs nothing more.
//   Height 7: 2 dependent loads a ΔNode instead of 8.
// * The root ΔNode staged once a block.  The fused kernel copies the
//   position table and the row and child ids of its first lane's root
//   into shared memory, every copy of the block in flight at once
//   (cp.async); on the main path every lane starts there.
// * Kernel 1 descends one gathered row a lane, stopping at the first node
//   whose left child is EMPTY.  At a piece boundary that left child is the
//   root of the next piece or of its sibling: the lane loads the piece the
//   router picks together with the sibling's root slot, and decides.
// * Block sizes: both kernels are built for 32, 64, 128 and 256 threads a
//   block (BlockSizes) and the wrapper picks one at launch (its q_tile;
//   kernels/autotune.py sweeps them).  The staged root is only a cache, so
//   every size gives the same bits.  On an H100 no size beats 64 beyond
//   the spread of repeated reads (tools/walk_sweep.py, PERF.md), so 64 is
//   the default.
// * Tall ΔNodes (height > veb::kSmemHeight, up to veb::kMaxHeight = 30:
//   Table 1's UB=N tree is 22): the position table stays in global
//   memory, so a piece costs one more dependent load (its root's
//   position), and the fused kernel stages no root: every row is read in
//   place (the kTall instantiations; heights 1-12 compile as before).
//   Staging the root where it still fits (heights 13-15) copied up to
//   192 KB a block to serve about 15 slots a lane: 5.6-13x slower at
//   K = 2^20 and 4-15 % at 1024 (tools/walk_sweep.py --height, PERF.md).
//
// What still bounds them: a non-root ΔNode costs two dependent loads that
// miss the caches when the tree is cold, one for its top piece and one for
// the piece below, and a Fig. 12 search visits four.  At K = 2^20 the card
// is full and the whole pieces, the selects that pick their slots and the
// registers they take cost more than reading router by router (PERF.md).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <type_traits>

#include "veb_common.cuh"

namespace {

using veb::Big;
using veb::copy_run;
using veb::kMaxHeight;
using veb::kPlanCount;
using veb::kSmemHeight;
using veb::load_run;
using veb::pick;
using veb::pick_id;

// The block sizes (threads, i.e. queries, a block) each kernel is built
// for; kernels/veb_search.py's BLOCK_SIZES lists the same.
template <int... N> struct Sizes {};
using BlockSizes = Sizes<32, 64, 128, 256>;
constexpr int kDefaultSmem = 48 * 1024;  // above this only after the opt-in

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Bytes of shared memory that hold a copy of n elements of elt bytes at
// any elt-aligned address (veb::copy_run keeps the address modulo 16).
__host__ __device__ constexpr int room(int n, int elt) { return align16(n * elt + 16 - elt); }

// A block's dynamic shared memory up to kSmemHeight: the vEB position
// table, then (fused kernel) the staged root row and its child ids.
__host__ __device__ constexpr int rows_smem(int height) { return room(1 << height, 4); }
__host__ __device__ constexpr int fused_smem(int height, int elt) {
  return rows_smem(height) + room((1 << height) - 1, elt) + room(1 << (height - 1), 4);
}

// The levels of one piece of the blind descent, in registers, by the rules
// of ref.ref_delta_walk_fused.  EMPTY (0) routes right; lb / lv track the
// last occupied node; an occupied router is folded into the candidate rc
// once a later one replaces it, if the query turned left there
// (v < router).  b is the path's node, j its index in the piece.
template <typename T, int P, int L = 0>
__device__ __forceinline__ void blind_levels(const T (&r)[(1 << P) - 1], T v, int bottom0,
                                             int& b, int& j, int& lb, T& lv, T& rc) {
  if constexpr (L < P) {
    const T x = pick<T, P, L>(r, j);
    if (x != 0) {
      if (lv != 0 && v < lv && lv < rc) rc = lv;
      lb = b;
      lv = x;
    }
    if (b < bottom0) {
      const int go = v >= x ? 1 : 0;
      b = 2 * b + go;
      j = 2 * j + go;
    }
    blind_levels<T, P, L + 1>(r, v, bottom0, b, j, lb, lv, rc);
  }
}

// One piece of a fused-walk round: the piece rooted at b (loaded from row,
// global or shared memory), and with the last piece the child ids of its
// leaves; sets nxt after the last piece.
template <typename T, int P>
__device__ __forceinline__ void fused_piece(const T* row, const int32_t* crow,
                                            const int* s_pos, bool last, T v, int bottom0,
                                            int& b, int& lb, T& lv, T& rc, int& nxt) {
  constexpr int kN = (1 << P) - 1, kC = 1 << (P - 1);
  const int root = b;
  T r[kN];
  int32_t c[kC];
  load_run<T, kN>(row + s_pos[root], r);
  if (last) load_run<int32_t, kC>(crow + root * kC - bottom0, c);
  int j = 1;
  blind_levels<T, P>(r, v, bottom0, b, j, lb, lv, rc);
  if (last) nxt = lb >= bottom0 ? pick_id<kC>(c, lb - root * kC) : -1;
}

// All walk rounds in one launch: a lane loops until its walk ends inside a
// ΔNode or it has run max_rounds rounds; a query equal to the sentinel is
// born resolved.  A resolved lane's state never changes again, so these
// per-lane loops give the Pallas kernel's tile-wide loop results.  kTall:
// the position table is read from global memory and nothing is staged.
template <typename T, int kThreads, bool kTall>
__global__ void __launch_bounds__(kThreads)
walk_fused_kernel(const T* __restrict__ value, const int32_t* __restrict__ child,
                  const int32_t* __restrict__ roots, const T* __restrict__ queries,
                  const int32_t* __restrict__ pos, int k, int m, int ub, int lc,
                  int height, int max_rounds, T* __restrict__ leaf_val_out,
                  int32_t* __restrict__ leaf_b_out, int32_t* __restrict__ final_dn_out,
                  int32_t* __restrict__ hops_out, T* __restrict__ cand_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T big = Big<T>::value;
  const int first = blockIdx.x * blockDim.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const int i = first + t;
  T v = big;
  int dn = 0;
  if (i < k) {
    v = queries[i];
    dn = roots[i];
  }
  const int* s_pos = pos;
  const T* s_row = nullptr;
  const int32_t* s_child = nullptr;
  int sdn = -1;  // the staged ΔNode (kTall: none)
  if constexpr (!kTall) {
    // the position table and the first lane's root row and child ids,
    // every copy of the block in flight at once
    sdn = min(max(roots[first], 0), m - 1);
    s_pos = copy_run(smem, pos, 1 << height, t, nt);
    unsigned char* area = smem + rows_smem(height);
    s_row = copy_run(area, value + static_cast<int64_t>(sdn) * ub, ub, t, nt);
    s_child = copy_run(area + room(ub, sizeof(T)), child + static_cast<int64_t>(sdn) * lc,
                       lc, t, nt);
    veb::wait_copies();
    __syncthreads();
  }
  if (i >= k) return;

  const int bottom0 = 1 << (height - 1);
  const uint64_t plan = veb::piece_plan(height);
  const int pieces = static_cast<int>(plan >> kPlanCount);
  bool resolved = (v == big);
  T leaf_val = 0;
  int leaf_b = 1;
  int final_dn = dn;
  int hops = 0;
  T cand = big;

  for (int round = 0; round < max_rounds && !resolved; ++round) {
    const int dnc = min(max(dn, 0), m - 1);
    const bool staged = !kTall && dnc == sdn;
    const T* row = staged ? s_row : value + static_cast<int64_t>(dnc) * ub;
    const int32_t* crow = staged ? s_child : child + static_cast<int64_t>(dnc) * lc;
    int b = 1, lb = 1, nxt = -1;
    T lv = 0, rc = big;
    for (int q = 0; q < pieces; ++q) {
      const bool last = q == pieces - 1;
#define PIECE(P) fused_piece<T, P>(row, crow, s_pos, last, v, bottom0, b, lb, lv, rc, nxt)
      switch ((plan >> (4 * q)) & 15) {
        case 1: PIECE(1); break;
        case 2: PIECE(2); break;
        case 3: PIECE(3); break;
        default: PIECE(4); break;
      }
#undef PIECE
    }
    ++hops;
    if (rc < cand) cand = rc;
    if (nxt < 0) {
      resolved = true;
      leaf_val = lv;
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

// The levels of one piece of kernel 1's descent: at each level above the
// piece's bottom, stop at b if its left child is EMPTY, else fold a left
// turn's router into cand and step.  Leaves x = the router at b.
template <typename T, int P, int L = 0>
__device__ __forceinline__ void rows_levels(const T (&r)[(1 << P) - 1], T v, int& b, int& j,
                                            T& x, T& cand, bool& done) {
  x = pick<T, P, L>(r, j);
  if constexpr (L + 1 < P) {
    if (pick<T, P, L + 1>(r, 2 * j) == 0) {
      done = true;
      return;
    }
    const int go = v >= x ? 1 : 0;
    if (!go && x < cand) cand = x;
    b = 2 * b + go;
    j = 2 * j + go;
    rows_levels<T, P, L + 1>(r, v, b, j, x, cand, done);
  }
}

// One piece of kernel 1.  Past the first piece, b is the last piece's
// bottom node and x its router: the lane loads the piece x routes to
// together with its sibling's root (b's left child, when x routes right),
// then stops at b if that left child is EMPTY.  With the last piece come
// the child ids of its leaves; the walk ends at its bottom.
template <typename T, int P>
__device__ __forceinline__ void rows_piece(const T* row, const int32_t* crow, const int* s_pos,
                                           bool head, bool last, T v, int bottom0, int& b,
                                           T& x, T& cand, int& nxt, bool& done) {
  constexpr int kN = (1 << P) - 1, kC = 1 << (P - 1);
  const int go = head ? 0 : (v >= x ? 1 : 0);
  const int root = head ? 1 : 2 * b + go;
  T r[kN];
  int32_t c[kC];
  load_run<T, kN>(row + s_pos[root], r);
  const T sibling = go ? row[s_pos[2 * b]] : T(0);
  if (last) load_run<int32_t, kC>(crow + root * kC - bottom0, c);
  if (!head) {
    if ((go ? sibling : r[0]) == 0) {
      done = true;
      return;
    }
    if (!go && x < cand) cand = x;
    b = root;
  }
  int j = 1;
  rows_levels<T, P>(r, v, b, j, x, cand, done);
  if (last) {
    done = true;
    if (b >= bottom0) nxt = pick_id<kC>(c, b - root * kC);
  }
}

// One full in-ΔNode descent per query over rows gathered by the caller
// (rows (K, ubp), childrows (K, cp)).  kTall: the position table is read
// from global memory.
template <typename T, int kThreads, bool kTall>
__global__ void __launch_bounds__(kThreads)
walk_rows_kernel(const T* __restrict__ rows, const int32_t* __restrict__ childrows,
                 const T* __restrict__ queries, const int32_t* __restrict__ pos,
                 int k, int ubp, int cp, int height, T* __restrict__ leaf_val_out,
                 int32_t* __restrict__ leaf_b_out, int32_t* __restrict__ next_dn_out,
                 T* __restrict__ cand_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* s_pos = pos;
  if constexpr (!kTall) {
    s_pos = copy_run(smem, pos, 1 << height, threadIdx.x, blockDim.x);
    veb::wait_copies();
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;

  const int bottom0 = 1 << (height - 1);
  const uint64_t plan = veb::piece_plan(height);
  const int pieces = static_cast<int>(plan >> kPlanCount);
  const T v = queries[i];
  const T* row = rows + static_cast<int64_t>(i) * ubp;
  const int32_t* crow = childrows + static_cast<int64_t>(i) * cp;
  int b = 1, nxt = -1;
  T x = 0, cand = Big<T>::value;
  bool done = false;
  for (int q = 0; q < pieces && !done; ++q) {
    const bool head = q == 0, last = q == pieces - 1;
#define PIECE(P) rows_piece<T, P>(row, crow, s_pos, head, last, v, bottom0, b, x, cand, nxt, done)
    switch ((plan >> (4 * q)) & 15) {
      case 1: PIECE(1); break;
      case 2: PIECE(2); break;
      case 3: PIECE(3); break;
      default: PIECE(4); break;
    }
#undef PIECE
  }
  leaf_val_out[i] = x;
  leaf_b_out[i] = b;
  next_dn_out[i] = nxt;
  cand_out[i] = cand;
}

// Launches fn in blocks of `threads` with smem bytes of dynamic shared
// memory, opting in above the default 48 KB.
template <typename... P, typename... A>
int launch(void (*fn)(P...), int k, int threads, int smem, void* stream, A... args) {
  if (k > 0) {
    if (smem > kDefaultSmem) {
      const cudaError_t e =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (k + threads - 1) / threads;
    fn<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

// go(std::integral_constant<int, N>) for the built block size N equal to
// threads; any other size is refused.
template <typename F, int... N>
int at_block_size(int threads, Sizes<N...>, F go) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  (void)((threads == N ? (err = go(std::integral_constant<int, N>{}), true) : false) || ...);
  return err;
}

template <typename T>
int launch_fused(const void* value, const void* child, const void* roots,
                 const void* queries, const void* pos, int k, int m, int ub, int lc,
                 int height, int max_rounds, void* leaf_val, void* leaf_b,
                 void* final_dn, void* hops, void* cand, int threads, void* stream) {
  if (height < 1 || height > kMaxHeight) return static_cast<int>(cudaErrorInvalidValue);
  const bool tall = height > kSmemHeight;
  const int smem = tall ? 0 : fused_smem(height, sizeof(T));
  return at_block_size(threads, BlockSizes{}, [&](auto n) {
    constexpr int N = decltype(n)::value;
    return launch(tall ? walk_fused_kernel<T, N, true> : walk_fused_kernel<T, N, false>, k, N,
                  smem, stream, static_cast<const T*>(value),
                  static_cast<const int32_t*>(child), static_cast<const int32_t*>(roots),
                  static_cast<const T*>(queries), static_cast<const int32_t*>(pos), k, m, ub,
                  lc, height, max_rounds, static_cast<T*>(leaf_val),
                  static_cast<int32_t*>(leaf_b), static_cast<int32_t*>(final_dn),
                  static_cast<int32_t*>(hops), static_cast<T*>(cand));
  });
}

template <typename T>
int launch_rows(const void* rows, const void* childrows, const void* queries,
                const void* pos, int k, int ubp, int cp, int height, void* leaf_val,
                void* leaf_b, void* next_dn, void* cand, int threads, void* stream) {
  if (height < 1 || height > kMaxHeight) return static_cast<int>(cudaErrorInvalidValue);
  const bool tall = height > kSmemHeight;
  const int smem = tall ? 0 : rows_smem(height);
  return at_block_size(threads, BlockSizes{}, [&](auto n) {
    constexpr int N = decltype(n)::value;
    return launch(tall ? walk_rows_kernel<T, N, true> : walk_rows_kernel<T, N, false>, k, N,
                  smem, stream, static_cast<const T*>(rows),
                  static_cast<const int32_t*>(childrows), static_cast<const T*>(queries),
                  static_cast<const int32_t*>(pos), k, ubp, cp, height,
                  static_cast<T*>(leaf_val), static_cast<int32_t*>(leaf_b),
                  static_cast<int32_t*>(next_dn), static_cast<T*>(cand));
  });
}

}  // namespace

extern "C" {

// threads: the block size, one of BlockSizes (cudaErrorInvalidValue
// otherwise).

int veb_walk_fused_i32(const void* value, const void* child, const void* roots,
                       const void* queries, const void* pos, int k, int m, int ub,
                       int lc, int height, int max_rounds, void* leaf_val, void* leaf_b,
                       void* final_dn, void* hops, void* cand, int threads, void* stream) {
  return launch_fused<int32_t>(value, child, roots, queries, pos, k, m, ub, lc, height,
                               max_rounds, leaf_val, leaf_b, final_dn, hops, cand, threads,
                               stream);
}

int veb_walk_fused_i64(const void* value, const void* child, const void* roots,
                       const void* queries, const void* pos, int k, int m, int ub,
                       int lc, int height, int max_rounds, void* leaf_val, void* leaf_b,
                       void* final_dn, void* hops, void* cand, int threads, void* stream) {
  return launch_fused<int64_t>(value, child, roots, queries, pos, k, m, ub, lc, height,
                               max_rounds, leaf_val, leaf_b, final_dn, hops, cand, threads,
                               stream);
}

int veb_walk_rows_i32(const void* rows, const void* childrows, const void* queries,
                      const void* pos, int k, int ubp, int cp, int height, void* leaf_val,
                      void* leaf_b, void* next_dn, void* cand, int threads, void* stream) {
  return launch_rows<int32_t>(rows, childrows, queries, pos, k, ubp, cp, height, leaf_val,
                              leaf_b, next_dn, cand, threads, stream);
}

int veb_walk_rows_i64(const void* rows, const void* childrows, const void* queries,
                      const void* pos, int k, int ubp, int cp, int height, void* leaf_val,
                      void* leaf_b, void* next_dn, void* cand, int threads, void* stream) {
  return launch_rows<int64_t>(rows, childrows, queries, pos, k, ubp, cp, height, leaf_val,
                              leaf_b, next_dn, cand, threads, stream);
}

}  // extern "C"
