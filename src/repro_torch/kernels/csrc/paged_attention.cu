// ΔTree-paged GQA decode attention for Hopper (sm_90a), bound through a plain
// C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/delta_paged_attention.py::
// paged_decode_attention (_kernel at :27).  The plain PyTorch version beside
// it is src/repro_torch/kernels/ref.py::ref_paged_decode_attention; it follows
// this kernel's semantics (a sequence of length 0 gives 0).
//
// What it computes: for each (batch row b, KV head h), softmax attention of
// the G = QH/KVH query heads of that group over the sequence's pages, which a
// (B, MAXP) block table resolves: scores in float32 scaled by 1/sqrt(D),
// tokens at or past seq_len masked to -1e30, output acc / max(l, 1e-30) in
// q's dtype.
//
// What bounds it on an H100: bytes.  Every mapped K and V element of every
// live sequence is read once; at G = 4 that is 8 flops per bf16 byte, below
// the ~20 flops per byte the float32 FMA units sustain at 3.35 TB/s, so plain
// FMAs suffice and no tensor-core instruction is used (a bf16 mma on P.V
// would also round the float32 weights the plain version keeps).  The least
// time is the K/V bytes over 3.35 TB/s.
//
// The first design (one 128-thread block per (b, h), four block barriers a
// page, float32 staging, one page in flight) took ~9 us a page a block.  This
// one answers each of those:
// 1. Split-K over pages.  The grid is (B * NSUB, KVH, S) (NSUB = 1 unless
//    G > 8, point 5): block s takes logical pages [s * pps, (s + 1) * pps)
//    of its (b, h).  S and pps come from the shapes and the SM count only
//    (the wrapper's `split_plan`), never from seq_lens' values, so planning
//    needs no host sync.  Each block writes its
//    partial max m, sum l and unnormalised acc to float32 scratch, and
//    paged_decode_merge_kernel (one block per (b, h)) folds them:
//    M = max m_s, out = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s,
//    1e-30).  A block whose chunk starts at or past ceil(len / PS) returns at
//    once, and the merge reads only the chunks below that bound, so an empty
//    chunk never reads a -1 table entry and length 0 gives exactly 0.  With
//    S = 1 the block writes the output itself and no merge is launched.
// 2. Warps that do not wait for one another.  Each of the block's 4 warps
//    takes every 4th page of the chunk and keeps its own online-softmax state
//    in registers.  Within a warp, DL = D * sizeof(T) / 16 lanes share a
//    token row (one 16-byte piece each) and 32 / DL token rows run side by
//    side; q for the group sits in registers, widened once.  A row's G
//    partial dots are reduce-scattered across its DL lanes with
//    __shfl_xor_sync (log2 DL steps), the page's max per head runs across
//    lanes with shuffles, and the weights go through a small warp-private
//    score buffer in shared memory.  Only __syncwarp orders a page's phases;
//    the block meets at one __syncthreads, at the end of the chunk, to merge
//    its warps' states.
// 3. Pages in flight.  Each warp owns a ring of kStages stages in shared
//    memory, each holding one page's K and V rows of head h, filled with
//    cp.async.cg 16-byte copies (neighbouring lanes copy neighbouring pieces
//    of a row) and consumed stage by stage with cp.async.wait_group, so two
//    pages load while one is scored.  A table entry that is -1 or >= NP below
//    ceil(len / PS) is a caller error: the copy zero-fills (src-size 0), it
//    never reads out of bounds.
// 4. Storage dtype kept.  K/V stay bf16 (or float32) in shared memory and are
//    widened in registers; scores, sums and acc are float32.  The launch opts
//    in to more than 48 KB of dynamic shared memory where it needs it.
// 5. Groups of more than 8 query heads a KV head (StarCoder2-15B: 48 / 4,
//    G = 12) split into NSUB = ceil(G / 8) sub-groups of GS = ceil(G / NSUB)
//    heads, one block each: blockIdx.x = b * NSUB + sub, so a group's blocks
//    are neighbours in launch order and read the same pages close together
//    in time, the later one possibly from L2.  One block holding all 16 heads would keep q and acc for 16
//    heads in registers (256 a thread in bf16 at D = 128: spills) and its
//    three-page rings in float32 would exceed 227 KB; a sub-group keeps the
//    G <= 8 kernel exactly.  G <= 8 is one sub-group, the grid unchanged,
//    and runs an instantiation without the sub-group arithmetic (SUB =
//    false): with it, Granite's B = 64 x 4096 batch read 2.2-2.6 % slower
//    (tools/paged_ab.py; NVIDIA H100 80GB HBM3, 700.00 W).  A split group
//    always has 5-8 heads a sub-group (GP = 8).
//
// Limits (the wrapper's `_check` raises on them before a launch): D *
// sizeof(T) a power of two from 32 to 512 bytes, the block's shared memory
// at most 227 KB, q / k_pages / v_pages 16-byte aligned.
//
// Entry points launch on the caller's stream, allocate nothing and return
// the first CUDA error so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // warps a block (tuned on the H100)
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;                 // pages a warp's ring holds
constexpr int kMaxG = 8;                   // query heads a block (a sub-group)
constexpr int kMaxSmem = 232448;           // 227 KB: the per-block opt-in ceiling
constexpr int kDefaultSmem = 48 * 1024;    // above this, opt in per function
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* block_tables;
  const int32_t* seq_lens;
  int np, ps, kvh, d, g, maxp, splits, pps;
  int nsub, gs;  // sub-groups a KV head's group splits into, heads in each
  float scale;
  float* part;   // (B * KVH * splits) records of [m (G), l (G), acc (G * D)]
  void* out;
};

// widen one 16-byte piece to float32
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4], float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8], __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {        // element 2i in the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// 16-byte global -> shared copy; zero-fills when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums N partial values across the lanes that differ in bits MASK, MASK/2,
// ..., 1 of the lane id.  While more than one value is live each step
// reduce-scatters (a lane keeps half, sends half); the rest all-reduce.  On
// return v[0 .. N / min(N, 2 * MASK)) are full sums of heads idx0 + i.
template <int N, int MASK>
__device__ __forceinline__ void reduce_rows(float* v, int lane, int& idx0) {
  if constexpr (MASK > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & MASK;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, MASK);
      }
      if (up) idx0 += H;
      reduce_rows<H, MASK / 2>(v, lane, idx0);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], MASK);
      reduce_rows<1, MASK / 2>(v, lane, idx0);
    }
  }
}

__host__ __device__ constexpr int min_c(int a, int b) { return a < b ? a : b; }

// Bytes of one warp's region: the K/V ring, then its scores (PS x GP) and
// the page's rescale factors (GP), padded to 16 bytes.
__host__ __device__ inline int warp_bytes(int ps, int d, int gp, int elt) {
  const int ring = kStages * 2 * ps * d * elt;
  return ring + ((ps * gp + gp) * 4 + 15) / 16 * 16;
}
// the block's dynamic shared memory: the warps' regions, then the merge area
__host__ __device__ inline int smem_bytes(int ps, int d, int gp, int elt) {
  return kWarps * warp_bytes(ps, d, gp, elt) + kWarps * (2 * gp + gp * d) * 4;
}

// the plan of point 5: sub-groups of at most kMaxG heads, as even as possible
__host__ __device__ inline int subgroups(int g) { return (g + kMaxG - 1) / kMaxG; }
__host__ __device__ inline int subgroup_heads(int g) {
  const int n = subgroups(g);
  return (g + n - 1) / n;
}

// One block per (b, sub-group, h, chunk s); without SUB the whole group.  DL
// lanes share a token row; GP is the block's heads rounded up to a power of
// two (padded heads read q = 0 and are never written).
template <typename T, int DL, int GP, bool SUB>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(Params p) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int TG = 32 / DL;                  // token rows side by side
  constexpr int NF = GP / min_c(GP, DL);       // sums a lane holds after the reduce
  const int bx = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int b = SUB ? bx / p.nsub : bx;
  const int g0 = SUB ? (bx - b * p.nsub) * p.gs : 0;   // the sub-group's first head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tg = lane / DL, dl = lane % DL;
  const int ps = p.ps, d = p.d, g = p.g, kvh = p.kvh;
  const int gn = SUB ? min(p.gs, g - g0) : g;  // its heads
  if (SUB && gn <= 0) return;

  const int len = max(p.seq_lens[b], 0);
  const int npages = min((len + ps - 1) / ps, p.maxp);
  const int c0 = s * p.pps;
  const int c1 = min(c0 + p.pps, npages);
  const int qh = kvh * g;
  if (c0 >= c1) {                              // empty chunk: the merge skips it
    if (p.splits == 1) {                       // ... or, unsplit, length 0 gives 0
      T* out = static_cast<T*>(p.out) + (static_cast<int64_t>(b) * qh + h * g + g0) * d;
      for (int i = threadIdx.x; i < gn * d; i += kThreads) out[i] = from_f32<T>(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const int wb = warp_bytes(ps, d, GP, sizeof(T));
  const int stage = 2 * ps * d;                // elements: K rows, then V rows
  T* ring = reinterpret_cast<T*>(smem + warp * wb);
  float* sc = reinterpret_cast<float*>(smem + warp * wb + kStages * stage * sizeof(T));
  float* al = sc + ps * GP;
  float* mw = reinterpret_cast<float*>(smem + kWarps * wb);   // (warps, GP)
  float* lw = mw + kWarps * GP;                               // (warps, GP)
  float* aw = lw + kWarps * GP;                               // (warps, GP, D)

  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  const int32_t* bt = p.block_tables + static_cast<int64_t>(b) * p.maxp;
  const T* qrow = static_cast<const T*>(p.q) + (static_cast<int64_t>(b) * qh + h * g + g0) * d;

  float qf[GP][VEC];
#pragma unroll
  for (int gi = 0; gi < GP; ++gi) {
    if (gi < gn) {
      widen(*reinterpret_cast<const uint4*>(qrow + gi * d + dl * VEC), qf[gi], T());
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) qf[gi][j] = 0.f;
    }
  }

  // this warp's pages: c0 + warp, c0 + warp + kWarps, ...
  const int n_my = c1 - c0 > warp ? (c1 - c0 - warp + kWarps - 1) / kWarps : 0;
  const int64_t tok_stride = static_cast<int64_t>(kvh) * d;
  auto load_page = [&](int k) {
    const int pg = bt[c0 + warp + k * kWarps];
    const bool ok = pg >= 0 && pg < p.np;
    const int64_t base = ok ? (static_cast<int64_t>(pg) * ps * kvh + h) * d : 0;
    T* sk = ring + (k % kStages) * stage;
    T* sv = sk + ps * d;
    for (int i = lane; i < ps * DL; i += 32) {
      const int row = i / DL, col = (i % DL) * VEC;
      const int64_t go = base + row * tok_stride + col;
      cp_async16(sk + row * d + col, kp + go, ok);
      cp_async16(sv + row * d + col, vp + go, ok);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_my) load_page(k);
    cp_async_commit();              // empty groups keep the count uniform
  }

  // softmax state of head lane % GP (l_run: this lane's share, summed at the end)
  float m_run = kNeg, l_run = 0.f;
  float acc[GP][VEC];
#pragma unroll
  for (int gi = 0; gi < GP; ++gi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[gi][j] = 0.f;

  for (int k = 0; k < n_my; ++k) {
    if (k + kStages - 1 < n_my) load_page(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // page k's copies (this lane's) have landed
    __syncwarp();                   // ... and every lane's
    const T* sk = ring + (k % kStages) * stage;
    const T* sv = sk + ps * d;
    const int tok0 = (c0 + warp + k * kWarps) * ps;

    // scores: row t's G dots, reduce-scattered over its DL lanes (every
    // lane runs every step, so the full-mask shuffles never diverge)
#pragma unroll 4
    for (int t0 = 0; t0 < ps; t0 += TG) {
      const int t = t0 + tg;
      const bool row = t < ps;
      float kf[VEC] = {};
      if (row) widen(*reinterpret_cast<const uint4*>(sk + t * d + dl * VEC), kf, T());
      float v[GP];
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) a = fmaf(qf[gi][j], kf[j], a);
        v[gi] = a;
      }
      int idx0 = 0;
      reduce_rows<GP, DL / 2>(v, lane, idx0);
      const bool valid = tok0 + t < len;
#pragma unroll
      for (int i = 0; i < NF; ++i)
        if (row && idx0 + i < gn) sc[t * GP + idx0 + i] = valid ? v[i] * p.scale : kNeg;
    }
    __syncwarp();

    // online softmax over the page: lane takes entries e = lane + 32 i, all
    // of head lane % GP (GP divides 32); the max runs across that head's lanes
    float mloc = kNeg;
    for (int e = lane; e < ps * GP; e += 32) mloc = fmaxf(mloc, sc[e]);
#pragma unroll
    for (int o = GP; o < 32; o <<= 1) mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
    const float m_new = fmaxf(m_run, mloc);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
    for (int e = lane; e < ps * GP; e += 32) {
      const float w = expf(sc[e] - m_new);
      sc[e] = w;
      psum += w;
    }
    l_run = fmaf(l_run, alpha, psum);
    m_run = m_new;
    if (lane < GP) al[lane] = alpha;
    __syncwarp();

    // acc = acc * alpha + weights @ V, on this lane's rows and dims
#pragma unroll
    for (int gi = 0; gi < GP; ++gi) {
      const float a = al[gi];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[gi][j] *= a;
    }
#pragma unroll 4
    for (int t = tg; t < ps; t += TG) {
      float vf[VEC];
      widen(*reinterpret_cast<const uint4*>(sv + t * d + dl * VEC), vf, T());
      float w[GP];
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) w[gi] = sc[t * GP + gi];
#pragma unroll
      for (int gi = 0; gi < GP; ++gi)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[gi][j] = fmaf(w[gi], vf[j], acc[gi][j]);
    }
    __syncwarp();                   // the stage and the scores are free again
  }
  cp_async_wait<0>();

  // the warp's state: l over the lanes of each head, acc over the token rows
#pragma unroll
  for (int o = GP; o < 32; o <<= 1) l_run += __shfl_xor_sync(kFull, l_run, o);
#pragma unroll
  for (int o = DL; o < 32; o <<= 1)
#pragma unroll
    for (int gi = 0; gi < GP; ++gi)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[gi][j] += __shfl_xor_sync(kFull, acc[gi][j], o);
  if (lane < GP) {
    mw[warp * GP + lane] = m_run;
    lw[warp * GP + lane] = l_run;
  }
  if (tg == 0) {
#pragma unroll
    for (int gi = 0; gi < GP; ++gi)
      if (gi < gn)
#pragma unroll
        for (int j = 0; j < VEC; ++j) aw[(warp * GP + gi) * d + dl * VEC + j] = acc[gi][j];
  }
  __syncthreads();

  // the block's warps merged (a warp without pages has m = -1e30, l = acc = 0)
  for (int i = threadIdx.x; i < gn * d; i += kThreads) {
    const int gi = i / d, c = i - gi * d;
    float m = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mw[w * GP + gi]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(mw[w * GP + gi] - m);
      l = fmaf(f, lw[w * GP + gi], l);
      a = fmaf(f, aw[(w * GP + gi) * d + c], a);
    }
    if (p.splits == 1) {
      T* out = static_cast<T*>(p.out);
      out[(static_cast<int64_t>(b) * qh + h * g + g0) * d + i] = from_f32<T>(a / fmaxf(l, 1e-30f));
    } else {   // the record of (b, h, s) holds all G heads; this block writes its own
      float* rec = p.part + (static_cast<int64_t>(b * kvh + h) * p.splits + s) * g * (d + 2);
      if (c == 0) {
        rec[g0 + gi] = m;
        rec[g + g0 + gi] = l;
      }
      rec[2 * g + g0 * d + i] = a;
    }
  }
}

// One block per (b, h): folds the partials of the chunks below ceil(len / PS).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_merge_kernel(Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.kvh, h = bh - b * p.kvh;
  const int g = p.g, d = p.d;
  const int len = max(p.seq_lens[b], 0);
  const int npages = min((len + p.ps - 1) / p.ps, p.maxp);
  const int nch = (npages + p.pps - 1) / p.pps;
  const int rs = g * (d + 2);
  const float* rec = p.part + static_cast<int64_t>(bh) * p.splits * rs;
  T* out = static_cast<T*>(p.out) + (static_cast<int64_t>(b) * p.kvh * g + h * g) * d;
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const int gi = i / d;
    float m = kNeg;
    for (int s = 0; s < nch; ++s) m = fmaxf(m, rec[s * rs + gi]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nch; ++s) {
      const float f = expf(rec[s * rs + gi] - m);
      l = fmaf(f, rec[s * rs + g + gi], l);
      a = fmaf(f, rec[s * rs + 2 * g + i], a);
    }
    out[i] = from_f32<T>(a / fmaxf(l, 1e-30f));   // no chunk: 0 / 1e-30 = 0
  }
}

template <typename T, int DL, int GP, bool SUB = false>
cudaError_t launch_split(const Params& p, int b, cudaStream_t st) {
  const int smem = smem_bytes(p.ps, p.d, GP, sizeof(T));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto* fn = paged_decode_split_kernel<T, DL, GP, SUB>;
  if (smem > kDefaultSmem) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  fn<<<dim3(b * p.nsub, p.kvh, p.splits), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int DL>
cudaError_t dispatch_g(const Params& p, int b, cudaStream_t st) {
  if (p.nsub > 1) return launch_split<T, DL, 8, true>(p, b, st);   // gs is 5-8
  if (p.gs <= 1) return launch_split<T, DL, 1>(p, b, st);
  if (p.gs <= 2) return launch_split<T, DL, 2>(p, b, st);
  if (p.gs <= 4) return launch_split<T, DL, 4>(p, b, st);
  if (p.gs <= kMaxG) return launch_split<T, DL, 8>(p, b, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
           const void* seq_lens, int b, int np, int ps, int kvh, int d, int g, int maxp,
           int splits, int pps, float scale, void* part, void* out, void* stream) {
  if (ps < 1 || d < 1 || g < 1 || kvh < 1 || maxp < 1 || splits < 1 || pps < 1 ||
      splits > 65535 || kvh > 65535 || static_cast<int64_t>(splits) * pps < maxp ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16 ||
      (d * static_cast<int>(sizeof(T))) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  Params p{q, k_pages, v_pages, static_cast<const int32_t*>(block_tables),
           static_cast<const int32_t*>(seq_lens), np, ps, kvh, d, g, maxp, splits, pps,
           subgroups(g), subgroup_heads(g), scale, static_cast<float*>(part), out};
  if (static_cast<int64_t>(b) * p.nsub > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (d * static_cast<int>(sizeof(T)) / 16) {   // lanes a token row
    case 2: e = dispatch_g<T, 2>(p, b, st); break;
    case 4: e = dispatch_g<T, 4>(p, b, st); break;
    case 8: e = dispatch_g<T, 8>(p, b, st); break;
    case 16: e = dispatch_g<T, 16>(p, b, st); break;
    case 32: e = dispatch_g<T, 32>(p, b, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  paged_decode_merge_kernel<T><<<b * kvh, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int paged_decode_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                               const void* block_tables, const void* seq_lens, int b,
                               int np, int ps, int kvh, int d, int g, int maxp, int splits,
                               int pps, float scale, void* part, void* out, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, seq_lens, b, np, ps, kvh, d, g,
                       maxp, splits, pps, scale, part, out, stream);
}

int paged_decode_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                const void* block_tables, const void* seq_lens, int b,
                                int np, int ps, int kvh, int d, int g, int maxp, int splits,
                                int pps, float scale, void* part, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, b, np, ps, kvh,
                               d, g, maxp, splits, pps, scale, part, out, stream);
}

// the block's dynamic shared memory for these shapes (the wrapper checks it)
int paged_decode_smem_bytes(int ps, int d, int g, int elt) {
  int gp = 1;
  while (gp < subgroup_heads(g)) gp *= 2;
  return smem_bytes(ps, d, gp, elt);
}

}  // extern "C"
