// Paged single-query decode kernels for Hopper (sm_90a): the inhibitor
// (paper eq. 5-7) and the Softmax dot-product baseline, each walking a
// row's block table over a shared pool of KV pages.
//
// Replaces the TPU kernels of src/repro/kernels/paged.py:
//   paged_inhibitor_kernel        <- _paged_inhibitor_kernel (paged.py:124)
//   paged_attention_split_kernel  <- _paged_attention_kernel (paged.py:259)
//   + paged_attention_merge_kernel
//
// Layouts (row-major, contiguous):
//   q, out        (batch, 1, heads, head_dim)               T
//   k_pool,v_pool (num_pages, page_size, kv_heads, head_dim) T
//   tables        (batch, table_width) int32; entry 0 = trash page
//   lengths       (batch,) int32: valid KV rows, the new token included
// T is float or __nv_bfloat16; all arithmetic is float32.
//
// The query sits at position len-1, so the attendable keys are [k_lo,
// k_hi) with k_hi = min(len, P*ps) and k_lo = max(0, len - window) under
// a sliding window.  Keys outside that range are left out by predicate,
// never multiplied by 0: garbage, inf or nan in a page's tail past the
// cursor cannot reach a sum, and table entries past the cursor (trash
// page 0) are never read at all.  A row with len = 0 writes 0.
//
// Inhibitor (paged_inhibitor_kernel).  One block per (row, kv_head); it
// serves the `group = heads / kv_heads` query heads that share the KV head
// (head = kv_head * group + g).  The block loads its own lengths[row] and
// walks table entries [k_lo / ps, ceil(k_hi / ps)) by pointer arithmetic
// (this replaces the TPU grid's scalar-prefetched index maps), staging
// `pages_per_step` pages of K and V at a time into shared memory as
// float.  One warp per (g, key) pair reduces the score over head_dim with
// shuffles; then each thread owns one (g, dim) output element and
// accumulates it in a float register.  Per attendable pair it evaluates
// eq. 6 / eq. 7 directly: relu(v - z) unsigned; relu(v+ - z) + min(v- +
// z, 0) signed.  The fused eq. 9 / 10 forms of the reference are the same
// sums decomposed for vectorised hardware (identical for z >= 0, which
// the relu shift guarantees); per element the direct form is cheaper and
// rounds less.  Output / max(count, 1) when normalizing.  Inhibition
// partials are plain sums: a later split of a long context over several
// blocks combines partial sums and counts by addition, with no rescaling.
//
// Softmax, split over pages (flash-decoding).  One block of 4 warps per
// (row, kv head, split), n_splits = ceil(table_width / pages_per_step)
// (at least 1), fixed at launch from the table width: the host never
// reads lengths.  Split s covers keys [s * pages_per_step * ps, (s + 1) *
// pages_per_step * ps).  A block
// whose split holds no attendable key writes an empty partial (m = -1e30,
// l = 0) and exits.  Inside a block nothing is staged in shared memory:
// each lane loads 16 bytes of a key row (8 bf16 or 4 float) straight from
// the pool, so L = head_dim / 8 lanes (bf16; head_dim / 4 in float32)
// cover one key and a warp 32 / L keys per load, 4 loads of K and V in
// flight per lane before any is used (2 above 4 query heads per kv head,
// whose q and sums take twice the registers; groups 1-8 are built, which
// covers every config of the reference).  Each lane keeps its 16 bytes of
// q for each of the group's query heads in registers; a partial dot reduces
// over the key's L lanes by xor shuffles; then the online softmax (running
// max from -1e30, running sum, rescaled float32 accumulator) per key and
// head.  The lanes of a warp that hold the same dims merge by shuffles,
// the 4 warps through shared memory.  With one split the block writes
// acc / max(l, 1e-20) itself; otherwise it writes its partial (m, l, acc)
// to float32 scratch, and paged_attention_merge_kernel rescales the
// partials of each (row, head) to their common max and writes acc /
// max(l, 1e-20), reading only partials with l > 0: a row of length 0
// writes 0.
//
// Bound on this card.  Each KV byte is read once; per (query head, key,
// dim) the inhibitor does ~7 float32 operations on CUDA cores (|q-k|
// sub/abs/add, then select, add/sub, clamp, accumulate) and the Softmax
// ~4 (two FMAs plus the exp share).  At group 3 and 2-byte KV that is
// about 5 and 3 operations per KV byte, below the H100's ~20 float32
// operations per byte of HBM bandwidth: both kernels are bound by the
// bytes of the valid pages, about 1.1 MB at the serve shape (0.3 us).  At
// that size neither kernel is near its bound: a launch and a chain of
// dependent loads (length, table entry, key row) cost microseconds.  The
// inhibitor still launches only batch * kv_heads blocks and stages with
// plain loads, so its time is the longest row's walk; splitting it (its
// partials add) is later work.  The Softmax's split spreads the longest
// row over n_splits blocks; what stands between it and its bound is the
// second launch of the merge, the dependent-load latency inside a split
// and the launch itself (a CUDA graph of the decode step would hide the
// last).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct DecodeArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* lengths;
  void* out;
  int heads;
  int kv_heads;
  int head_dim;
  int page_size;
  int table_width;
  int pages_per_step;
  float scale;
  float shift;
  int is_signed;
  int normalize;
  int window;  // < 0: no sliding window
};

// Shared-memory carve-up, in floats:
//   qs[group*d] | ks[kb*d] | vs[kb*d] | zs[group*kb] | m[group] | l[group]
//   | alpha[group]       (kb = pages_per_step * page_size)
__host__ __device__ inline size_t smem_floats(int group, int d, int kb) {
  return (size_t)group * d + 2 * (size_t)kb * d + (size_t)group * kb +
         3 * (size_t)group;
}

struct Walk {
  int len, k_lo, k_hi, first_page, last_page;
};

__device__ __forceinline__ Walk make_walk(const DecodeArgs& a, int row) {
  Walk w;
  w.len = a.lengths[row];
  w.k_hi = min(w.len, a.table_width * a.page_size);
  w.k_lo = a.window >= 0 ? max(0, w.len - a.window) : 0;
  w.first_page = w.k_lo / a.page_size;
  w.last_page = (w.k_hi + a.page_size - 1) / a.page_size;  // exclusive
  return w;
}

// Stage pages [p0, p0 + np) of this row's table, kv head kvh, as float.
template <typename T>
__device__ __forceinline__ void stage_pages(const DecodeArgs& a,
                                            const int* table, int kvh,
                                            int p0, int nk, float* ks,
                                            float* vs) {
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const int d = a.head_dim, ps = a.page_size;
  for (int i = threadIdx.x; i < nk * d; i += blockDim.x) {
    const int j = i / d, e = i - (i / d) * d;
    const size_t page = (size_t)table[p0 + j / ps];
    const size_t src =
        ((page * ps + (size_t)(j % ps)) * a.kv_heads + kvh) * d + e;
    ks[i] = to_f32<T>(kp[src]);
    vs[i] = to_f32<T>(vp[src]);
  }
}

template <typename T>
__global__ void paged_inhibitor_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int group = a.heads / a.kv_heads;
  const int d = a.head_dim, ps = a.page_size;
  const int kb = a.pages_per_step * ps;
  float* qs = smem;
  float* ks = qs + group * d;
  float* vs = ks + (size_t)kb * d;
  float* zs = vs + (size_t)kb * d;

  const int row = blockIdx.x / a.kv_heads;
  const int kvh = blockIdx.x - row * a.kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const bool owner = tid < group * d;
  const int g = tid / d, dd = tid - (tid / d) * d;

  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  const size_t qo_base = ((size_t)row * a.heads + (size_t)kvh * group) * d;
  for (int i = tid; i < group * d; i += blockDim.x)
    qs[i] = to_f32<T>(q[qo_base + i]);

  const Walk w = make_walk(a, row);
  const int* table = a.tables + (size_t)row * a.table_width;
  const float inv_scale = 1.0f / a.scale;
  float acc = 0.0f;
  int cnt = 0;
  __syncthreads();

  for (int p0 = w.first_page; p0 < w.last_page; p0 += a.pages_per_step) {
    const int nk = min(a.pages_per_step, w.last_page - p0) * ps;
    stage_pages<T>(a, table, kvh, p0, nk, ks, vs);
    __syncthreads();
    // scores Z = relu(sum_d |q - k| / gamma - alpha): one warp per pair
    for (int pr = warp; pr < group * nk; pr += nwarps) {
      const int gg = pr / nk, j = pr - (pr / nk) * nk;
      float s = 0.0f;
      for (int e = lane; e < d; e += 32)
        s += fabsf(qs[gg * d + e] - ks[j * d + e]);
      s = warp_sum(s);
      if (lane == 0) {
        float z = s * inv_scale;
        if (a.shift != 0.0f) z = fmaxf(z - a.shift, 0.0f);
        zs[gg * kb + j] = z;
      }
    }
    __syncthreads();
    if (owner) {
      const int kbase = p0 * ps;
      const int j_lo = max(0, w.k_lo - kbase);
      const int j_hi = min(nk, w.k_hi - kbase);
      for (int j = j_lo; j < j_hi; ++j) {
        const float z = zs[g * kb + j];
        const float v = vs[j * d + dd];
        if (a.is_signed)
          acc += v > 0.0f ? fmaxf(v - z, 0.0f) : fminf(v + z, 0.0f);
        else
          acc += fmaxf(v - z, 0.0f);
      }
      cnt += max(0, j_hi - j_lo);
    }
    __syncthreads();  // the next round overwrites ks / vs / zs
  }
  if (owner) {
    float o = acc;
    if (a.normalize) o = o / fmaxf((float)cnt, 1.0f);
    out[qo_base + tid] = from_f32<T>(o);
  }
}

// ---------------------------------------------------------------------------
// Softmax split over pages
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 4;
constexpr float kNegInf = -1e30f;

// 16 bytes of the pool as float32: 8 bf16 or 4 float
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

// Partials in float32 scratch, for n_splits > 1: `count` = batch * heads
// * n_splits entries (index (row * heads + head) * n_splits + split) of
// m | l | acc[head_dim].
struct Partials {
  float *m, *l, *acc;
  __device__ Partials(float* base, size_t count)
      : m(base), l(base + count), acc(base + 2 * count) {}
};

// shared memory: m[warps][G] | l[warps][G] | acc[warps][G][d]
__host__ __device__ inline size_t split_smem_bytes(int group, int d) {
  return sizeof(float) * (size_t)kSplitWarps * group * (2 + d);
}

template <typename T, int G>
__global__ void __launch_bounds__(kSplitWarps * 32)
    paged_attention_split_kernel(DecodeArgs a, int batch, float* scratch) {
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte load
  // key loads in flight per lane: 4, or 2 above 4 query heads per kv
  // head, whose q and sums take twice the registers
  constexpr int U = G > 4 ? 2 : 4;
  extern __shared__ float split_smem[];
  const int d = a.head_dim, ps = a.page_size;
  const int lpk = d / E;              // lanes per key row
  const int kpw = 32 / lpk;           // keys per warp load
  const int row = blockIdx.x / a.kv_heads;
  const int kvh = blockIdx.x - row * a.kv_heads;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / lpk, col = (lane - slot * lpk) * E;
  const size_t head0 = (size_t)row * a.heads + (size_t)kvh * G;
  const Partials part(scratch, (size_t)batch * a.heads * n_splits);
  T* out = static_cast<T*>(a.out);

  const Walk w = make_walk(a, row);
  const int span = a.pages_per_step * ps;
  const int s_lo = max(w.k_lo, split * span);
  const int s_hi = min(w.k_hi, (split + 1) * span);
  if (s_lo >= s_hi) {   // no attendable key in this split
    if (n_splits > 1) {
      if (threadIdx.x < G) {
        const size_t p = (head0 + threadIdx.x) * n_splits + split;
        part.m[p] = kNegInf;
        part.l[p] = 0.0f;
      }
    } else {
      for (int i = threadIdx.x; i < G * d; i += blockDim.x)
        out[head0 * d + i] = from_f32<T>(0.0f);
    }
    return;
  }

  const T* qg = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const int* table = a.tables + (size_t)row * a.table_width;
  const float inv_scale = 1.0f / a.scale;
  float qr[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load16(qg + (head0 + g) * d + col, qr[g]);
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

  const int step = kSplitWarps * kpw;   // keys per block-wide load
  for (int base = s_lo + warp * kpw; base < s_hi;
       base += U * step) {   // warp-uniform
    float kx[U][E], vx[U][E];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * step + slot;
      live[u] = j < s_hi;
      if (live[u]) {
        const size_t src =
            (((size_t)table[j / ps] * ps + j % ps) * a.kv_heads + kvh) * d +
            col;
        load16(kp + src, kx[u]);
        load16(vp + src, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kx[u][e] = vx[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qr[g][e] * kx[u][e];
        for (int o = 1; o < lpk; o <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (live[u]) {   // uniform over the key's lanes
          s *= inv_scale;
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = fmaf(p, vx[u][e], acc[g][e] * corr);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warp's key slots (lanes lpk apart hold the same dims)
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float c_s = expf(m[g] - m_new), c_o = expf(m_o - m_new);
      l[g] = l[g] * c_s + l_o * c_o;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * c_s + a_o * c_o;
      }
      m[g] = m_new;
    }
  }
  // merge the warps through shared memory
  float* sm_m = split_smem;
  float* sm_l = sm_m + kSplitWarps * G;
  float* sm_acc = sm_l + kSplitWarps * G;
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sm_acc[(warp * G + g) * d + col + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * d; i += blockDim.x) {
    const int g = i / d, e = i - g * d;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kSplitWarps; ++wi) mx = fmaxf(mx, sm_m[wi * G + g]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kSplitWarps; ++wi) {
      const float c = expf(sm_m[wi * G + g] - mx);
      ls += sm_l[wi * G + g] * c;
      as += sm_acc[(wi * G + g) * d + e] * c;
    }
    if (n_splits == 1) {
      out[head0 * d + i] = from_f32<T>(as / fmaxf(ls, 1e-20f));
    } else {
      const size_t p = (head0 + g) * n_splits + split;
      part.acc[p * d + e] = as;
      if (e == 0) {
        part.m[p] = mx;
        part.l[p] = ls;
      }
    }
  }
}

// One block per (row, head), one thread per dim: the partials of every
// split rescaled to their common max; out = acc / max(l, 1e-20).
template <typename T>
__global__ void paged_attention_merge_kernel(DecodeArgs a, int batch,
                                             int n_splits,
                                             const float* scratch) {
  const int d = a.head_dim, e = threadIdx.x;
  const size_t rh = blockIdx.x;   // row * heads + head
  const Partials part(const_cast<float*>(scratch),
                      (size_t)batch * a.heads * n_splits);
  const float* pm = part.m + rh * n_splits;
  const float* pl = part.l + rh * n_splits;
  const float* pa = part.acc + rh * n_splits * d;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, pm[s]);
  float ls = 0.0f, as = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float l = pl[s];
    if (l > 0.0f) {   // an empty split's acc is never written
      const float c = expf(pm[s] - mx);
      ls += l * c;
      as += pa[(size_t)s * d + e] * c;
    }
  }
  static_cast<T*>(a.out)[rh * d + e] = from_f32<T>(as / fmaxf(ls, 1e-20f));
}

template <typename T, int G>
cudaError_t launch_split(const DecodeArgs& a, int batch, float* scratch,
                         cudaStream_t stream) {
  const int n_splits =
      max(1, (a.table_width + a.pages_per_step - 1) / a.pages_per_step);
  const dim3 grid(batch * a.kv_heads, n_splits);
  paged_attention_split_kernel<T, G>
      <<<grid, kSplitWarps * 32, split_smem_bytes(G, a.head_dim), stream>>>(
          a, batch, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  paged_attention_merge_kernel<T>
      <<<batch * a.heads, a.head_dim, 0, stream>>>(a, batch, n_splits,
                                                   scratch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_split(const DecodeArgs& a, int batch, float* scratch,
                           cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int lpk = a.head_dim / E;
  if (a.head_dim % E || lpk < 1 || lpk > 32 || (lpk & (lpk - 1)) ||
      a.pages_per_step < 1)
    return cudaErrorInvalidValue;
  switch (a.heads / a.kv_heads) {
    case 1: return launch_split<T, 1>(a, batch, scratch, stream);
    case 2: return launch_split<T, 2>(a, batch, scratch, stream);
    case 3: return launch_split<T, 3>(a, batch, scratch, stream);
    case 4: return launch_split<T, 4>(a, batch, scratch, stream);
    case 5: return launch_split<T, 5>(a, batch, scratch, stream);
    case 6: return launch_split<T, 6>(a, batch, scratch, stream);
    case 7: return launch_split<T, 7>(a, batch, scratch, stream);
    case 8: return launch_split<T, 8>(a, batch, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_inhibitor(const DecodeArgs& a, int batch,
                             cudaStream_t stream) {
  const int group = a.heads / a.kv_heads;
  const int threads = ((group * a.head_dim + 31) / 32) * 32;
  const int kb = a.pages_per_step * a.page_size;
  const size_t smem = sizeof(float) * smem_floats(group, a.head_dim, kb);
  void (*kern)(DecodeArgs) = paged_inhibitor_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<batch * a.kv_heads, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t code
// (0 = launched); the launch is asynchronous on `stream`.
extern "C" int paged_inhibitor_decode(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int table_width,
    int pages_per_step, float scale, float shift, int is_signed,
    int normalize, int window, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, tables, lengths, out, heads,
                     kv_heads, head_dim, page_size, table_width,
                     pages_per_step, scale, shift, is_signed, normalize,
                     window};
  switch (dtype) {
    case 0: return (int)launch_inhibitor<float>(a, batch,
                                                (cudaStream_t)stream);
    case 1: return (int)launch_inhibitor<__nv_bfloat16>(
        a, batch, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split Softmax: pages_per_step pages per split, n_splits =
// max(1, ceil(table_width / pages_per_step)); `scratch` holds batch * heads *
// n_splits * (head_dim + 2) floats (unused with one split).
// head_dim * element size / 16 must be a power of two <= 32, group <= 4
// (instantiated for the groups the configs and tests reach);
// q and the pools 16-byte aligned.
extern "C" int paged_attention_decode(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int table_width,
    int pages_per_step, float scale, int window, void* scratch,
    void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, tables, lengths, out, heads,
                     kv_heads, head_dim, page_size, table_width,
                     pages_per_step, scale, 0.0f, 0, 0, window};
  float* part = static_cast<float*>(scratch);
  switch (dtype) {
    case 0: return (int)dispatch_split<float>(a, batch, part,
                                              (cudaStream_t)stream);
    case 1: return (int)dispatch_split<__nv_bfloat16>(a, batch, part,
                                                      (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes one launch needs (the wrapper checks the limit).
extern "C" long long paged_decode_smem_bytes(int group, int head_dim,
                                             int page_size,
                                             int pages_per_step) {
  return (long long)(sizeof(float) *
                     smem_floats(group, head_dim, page_size * pages_per_step));
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
