// ΔTree-paged GQA decode attention for Hopper (sm_90a), bound through a plain
// C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/delta_paged_attention.py::
// paged_decode_attention (_kernel).  The plain PyTorch version beside it is
// src/repro_torch/kernels/ref.py::ref_paged_decode_attention; it follows this
// kernel's semantics (a sequence of length 0 gives 0).
//
// What it computes: for each (batch row b, KV head h), online softmax over the
// G = QH/KVH query heads of that group, page by page through the sequence's
// block table: scores in float32 scaled by 1/sqrt(D), tokens at or past
// seq_len masked to -1e30, output acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: bytes.  A decode step reads every mapped K and V
// element of every live sequence once and does 4 flops per element per query
// head of the group (G = 4 at Granite width), far below the ~295 flops per
// byte where bf16 tensor cores would become the limit.  The least time is the
// K/V bytes over 3.35 TB/s.
//
// This first design is simple, not fast:
// - one thread block of 128 threads per (b, h): with B = 8 and KVH = 8 only
//   64 of the card's 132 SMs get work, and a long sequence runs on one SM;
// - the loop runs over the pages p < ceil(seq_len / PS) only; a -1 entry of
//   the block table is never dereferenced (the TPU kernel clamps it to page
//   0 and masks it).  An entry that is -1 or >= NP below that bound is a
//   caller error: it reads as zeros, never out of bounds;
// - each page's K and V rows of head h are staged in shared memory as
//   float32 (K rows padded by one float so the score loop is free of bank
//   conflicts); the next page's loads are issued into registers before the
//   current page is scored, so one page's load latency hides behind the
//   previous page's arithmetic;
// - scores, the running max, sum and accumulator live in shared memory in
//   float32; plain FMAs, no tensor cores.
// Making it fast (a warp per query group, cp.async/TMA page loads, split-K
// over long sequences) is later work.
//
// Entry points launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // chosen without measurement
constexpr int kSmemLimit = 48 * 1024;      // no opt-in to larger dynamic smem

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Issues the loads of one page's K/V elements (head h) into registers:
// element j of this thread sits at goff[j] inside the page.
template <typename T, int kPer>
__device__ __forceinline__ void load_page(const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages, int page, int np,
                                          int64_t page_stride, int n_el,
                                          const int (&goff)[kPer], float (&kr)[kPer],
                                          float (&vr)[kPer]) {
  const bool ok = page >= 0 && page < np;
  const int64_t base = ok ? static_cast<int64_t>(page) * page_stride : 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool in = ok && static_cast<int>(threadIdx.x) + j * kThreads < n_el;
    kr[j] = in ? to_f32(k_pages[base + goff[j]]) : 0.f;
    vr[j] = in ? to_f32(v_pages[base + goff[j]]) : 0.f;
  }
}

// kPer: page elements (PS * D) each thread stages; PS * D <= kPer * kThreads.
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ seq_lens, int np, int ps, int kvh,
                    int d, int g, int maxp, float scale, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int dp = d + 1;                 // padded K row
  float* q_s = smem;                    // (G, D)
  float* k_s = q_s + g * d;             // (PS, D + 1)
  float* v_s = k_s + ps * dp;           // (PS, D)
  float* p_s = v_s + ps * d;            // (G, PS) scores, then weights
  float* acc_s = p_s + g * ps;          // (G, D)
  float* m_s = acc_s + g * d;           // (G,) running max
  float* l_s = m_s + g;                 // (G,) running sum
  float* a_s = l_s + g;                 // (G,) this page's rescale factor

  const int64_t qoff = (static_cast<int64_t>(b) * kvh * g + static_cast<int64_t>(h) * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    q_s[i] = to_f32(q[qoff + i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = -1e30f;
    l_s[i] = 0.f;
  }

  const int len = max(seq_lens[b], 0);
  const int npages = min((len + ps - 1) / ps, maxp);
  const int n_el = ps * d;
  const int tok_stride = kvh * d;                       // between a page's tokens
  const int64_t page_stride = static_cast<int64_t>(ps) * tok_stride;
  const int32_t* bt = block_tables + static_cast<int64_t>(b) * maxp;

  // per staged element: its offset inside a page (head h) and its K slot
  int goff[kPer];
  int kslot[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads;
    const int t = e / d;
    goff[j] = t * tok_stride + h * d + (e - t * d);
    kslot[j] = e + t;
  }
  float kr[kPer];
  float vr[kPer];

  if (npages > 0)
    load_page<T, kPer>(k_pages, v_pages, bt[0], np, page_stride, n_el, goff, kr, vr);
  __syncthreads();                       // q_s, acc_s, m_s, l_s ready
  for (int p = 0; p < npages; ++p) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < n_el) {
        k_s[kslot[j]] = kr[j];
        v_s[e] = vr[j];
      }
    }
    __syncthreads();
    if (p + 1 < npages)   // in flight while page p is scored
      load_page<T, kPer>(k_pages, v_pages, bt[p + 1], np, page_stride, n_el, goff, kr, vr);

    // scores of the G x PS (query head, token) pairs
    const int base = p * ps;
    for (int pair = tid; pair < g * ps; pair += kThreads) {
      const int gi = pair / ps;
      const int t = pair - gi * ps;
      const float* qr = q_s + gi * d;
      const float* kr_s = k_s + t * dp;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr_s[c], s);
      p_s[pair] = (base + t < len) ? s * scale : -1e30f;
    }
    __syncthreads();

    // online softmax per query head
    for (int gi = tid; gi < g; gi += kThreads) {
      float* row = p_s + gi * ps;
      const float m_old = m_s[gi];
      float m_new = m_old;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, row[t]);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float w = expf(row[t] - m_new);
        row[t] = w;
        sum += w;
      }
      l_s[gi] = alpha * l_s[gi] + sum;
      m_s[gi] = m_new;
      a_s[gi] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + weights @ V
    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d;
      const int c = i - gi * d;
      const float* w = p_s + gi * ps;
      float a = acc_s[i] * a_s[gi];
      for (int t = 0; t < ps; ++t) a = fmaf(w[t], v_s[t * d + c], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d;
    out[qoff + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[gi], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* seq_lens, int b, int np, int ps,
           int kvh, int d, int g, int maxp, float scale, void* out, void* stream) {
  if (ps < 1 || d < 1 || g < 1 || kvh < 1 || maxp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(g) * d * 2 + static_cast<size_t>(ps) * (d + 1) +
                       static_cast<size_t>(ps) * d + static_cast<size_t>(g) * ps + 3 * g);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int n_el = ps * d;
  if (b > 0) {
    const dim3 grid(b, kvh);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k_pages);
    const T* vt = static_cast<const T*>(v_pages);
    const int32_t* btt = static_cast<const int32_t*>(block_tables);
    const int32_t* sl = static_cast<const int32_t*>(seq_lens);
    T* o = static_cast<T*>(out);
    if (n_el <= 16 * kThreads) {
      paged_decode_kernel<T, 16><<<grid, kThreads, smem, st>>>(
          qt, kt, vt, btt, sl, np, ps, kvh, d, g, maxp, scale, o);
    } else if (n_el <= 32 * kThreads) {
      paged_decode_kernel<T, 32><<<grid, kThreads, smem, st>>>(
          qt, kt, vt, btt, sl, np, ps, kvh, d, g, maxp, scale, o);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int paged_decode_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                               const void* block_tables, const void* seq_lens, int b,
                               int np, int ps, int kvh, int d, int g, int maxp,
                               float scale, void* out, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, seq_lens, b, np, ps, kvh, d, g,
                       maxp, scale, out, stream);
}

int paged_decode_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                const void* block_tables, const void* seq_lens, int b,
                                int np, int ps, int kvh, int d, int g, int maxp,
                                float scale, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, b, np, ps, kvh,
                               d, g, maxp, scale, out, stream);
}

}  // extern "C"
