// Helpers shared by the ΔTree kernels for Hopper (veb_walk.cu, veb_scan.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace veb {

// The tallest ΔNode whose vEB position table a block keeps in shared
// memory (2**12 int32 = 16 KB); taller ones read it from global memory.
constexpr int kSmemHeight = 12;
// The tallest ΔNode the kernels take: its BFS slot indices (< 2**30)
// stay in int32.
constexpr int kMaxHeight = 30;

// The successor-candidate identity and the walk sentinel of a row dtype: the
// tree's ROUTE_LEFT (int32: INT32_MAX; packed int64 map mode: 1 << 62).
template <typename T> struct Big;
template <> struct Big<int32_t> { static constexpr int32_t value = 2147483647; };
template <> struct Big<int64_t> { static constexpr int64_t value = int64_t(1) << 62; };

// ---------------------------------------------------------------------------
// The piece-wise descent of the walk kernels (veb_walk.cu).
//
// A ΔNode row is stored in vEB order (core/layout.py::veb_order): a subtree
// of height h is a top of height h/2 followed by the bottoms of height
// h - h/2, each stored contiguously with its root first.  Splitting again
// until every piece has height <= kPiece, a root-to-leaf path crosses one
// piece at each level of the split, and each piece is a contiguous run of
// at most 15 slots: a lane loads a whole piece at once (its loads are
// independent, so they cost one round trip) and descends through it in
// registers.
constexpr int kPiece = 4;

// The heights of the pieces a path crosses in a height-h ΔNode (h <= 32),
// top first, 4 bits each, and their count from bit kPlanCount: one piece
// for h <= 4, two for h = 5..8, three for h = 9, four for h = 10..16, up
// to eight above.  A half of height <= 16 splits into quarters of <= 8,
// and a quarter into pieces of <= 4, as `piece_plan` in
// tests/test_torch_walk_lane.py recurses.
constexpr int kPlanCount = 32;

__host__ __device__ constexpr uint64_t piece_plan(int h) {
  if (h <= kPiece) return uint64_t(h) | uint64_t(1) << kPlanCount;
  uint64_t plan = 0;
  int n = 0;
  for (int half = 0; half < 2; ++half) {
    const int x = half ? h - h / 2 : h / 2;
    if (x <= kPiece) {
      plan |= uint64_t(x) << (4 * n++);
      continue;
    }
    for (int quarter = 0; quarter < 2; ++quarter) {
      const int y = quarter ? x - x / 2 : x / 2;
      if (y <= kPiece) {
        plan |= uint64_t(y) << (4 * n++);
      } else {
        plan |= uint64_t(y / 2) << (4 * n++);
        plan |= uint64_t(y - y / 2) << (4 * n++);
      }
    }
  }
  return plan | uint64_t(n) << kPlanCount;
}

// The storage offset of local BFS node j (root 1) in a piece of height
// p <= 4.  The piece's top (height p/2) and bottoms (height p - p/2) have
// at most two levels, so each is in BFS order.
__host__ __device__ constexpr int piece_pos(int p, int j) {
  const int d = j >= 8 ? 3 : j >= 4 ? 2 : j >= 2 ? 1 : 0;
  const int ht = p / 2, hb = p - ht;
  if (d < ht) return j - 1;
  const int sub = j >> (d - ht);                     // its bottom's root
  const int local = (1 << (d - ht)) + j - (sub << (d - ht));
  return (1 << ht) - 1 + (sub - (1 << ht)) * ((1 << hb) - 1) + local - 1;
}

// A 16-byte word read whole, as its elements.
template <typename T> union Word {
  int4 v;
  T e[16 / sizeof(T)];
};

// v[s] = p[s] for s < N, p of any alignment to 16 bytes: 16-byte loads of
// the aligned words overlapping [p, p + N) (never a word outside them, so
// never a byte of another page), issued together, one round trip; the
// elements are picked out of the words by selects, so v stays in
// registers.  Generic addresses: p may be in global or shared memory.
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* p, T (&v)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kWords = (N + kPer - 1) / kPer + 1;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) /
                  static_cast<int>(sizeof(T));
  const int4* w = reinterpret_cast<const int4*>(p - mis);
  Word<T> x[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    x[k].v = make_int4(0, 0, 0, 0);
    if (k * kPer < mis + N) x[k].v = w[k];
  }
#pragma unroll
  for (int s = 0; s < N; ++s) {
    T e = x[s / kPer].e[s % kPer];
#pragma unroll
    for (int m = 1; m < kPer; ++m)
      if (mis == m) e = x[(s + m) / kPer].e[(s + m) % kPer];
    v[s] = e;
  }
}

// The router at local node j of level L (2^L <= j < 2^(L+1)) of a piece
// of height P held in registers (storage order): a chain of selects.
template <typename T, int P, int L>
__device__ __forceinline__ T pick(const T (&r)[(1 << P) - 1], int j) {
  T x = r[piece_pos(P, 1 << L)];
#pragma unroll
  for (int c = 1; c < (1 << L); ++c)
    if (j == (1 << L) + c) x = r[piece_pos(P, (1 << L) + c)];
  return x;
}

// The id at offset o < N of a run held in registers.
template <int N>
__device__ __forceinline__ int32_t pick_id(const int32_t (&c)[N], int o) {
  int32_t x = c[0];
#pragma unroll
  for (int s = 1; s < N; ++s)
    if (o == s) x = c[s];
  return x;
}

// Asynchronous 16-byte copies from global to shared memory (cp.async):
// the copies a thread issues are in flight together, and wait_copies()
// waits for all of them.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issues the copies of the 16-byte words that hold n elements at p (any
// alignment) into the shared memory at buf (16-byte aligned, room for
// n * sizeof(T) + 16 - sizeof(T) bytes rounded up to 16), thread t of nt,
// and returns the copy of p[0], whose address keeps p's modulo 16.  Only
// the aligned words overlapping [p, p + n) are read.
template <typename T>
__device__ __forceinline__ const T* copy_run(unsigned char* buf, const T* p, int n, int t,
                                             int nt) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(p) - mis;
  const int words = (mis + n * static_cast<int>(sizeof(T)) + 15) / 16;
  for (int k = t; k < words; k += nt) copy16(buf + 16 * k, src + 16 * k);
  return reinterpret_cast<const T*>(buf + mis);
}

}  // namespace veb
