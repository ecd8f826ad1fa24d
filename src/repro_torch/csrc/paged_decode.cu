// Paged single-query decode kernels for Hopper (sm_90a): the inhibitor
// (paper eq. 5-7) and the Softmax dot-product baseline, each walking a
// row's block table over a shared pool of KV pages.
//
// Replaces the TPU kernels of src/repro/kernels/paged.py:
//   paged_inhibitor_kernel  <- _paged_inhibitor_kernel (paged.py:124)
//   paged_attention_kernel  <- _paged_attention_kernel (paged.py:259)
//
// Layouts (row-major, contiguous):
//   q, out        (batch, 1, heads, head_dim)               T
//   k_pool,v_pool (num_pages, page_size, kv_heads, head_dim) T
//   tables        (batch, table_width) int32; entry 0 = trash page
//   lengths       (batch,) int32: valid KV rows, the new token included
// T is float or __nv_bfloat16; all arithmetic is float32.
//
// Design.  One block per (row, kv_head); it serves the `group =
// heads / kv_heads` query heads that share the KV head (head = kv_head *
// group + g).  The block loads its own lengths[row] and walks table
// entries [k_lo / ps, ceil(k_hi / ps)) by pointer arithmetic (this
// replaces the TPU grid's scalar-prefetched index maps), staging
// `pages_per_step` pages of K and V at a time into shared memory as
// float.  One warp per (g, key) pair reduces the score over head_dim with
// shuffles; then each thread owns one (g, dim) output element and
// accumulates it in a float register.  The query sits at position len-1,
// so the attendable keys are [k_lo, k_hi) with k_hi = min(len, P*ps) and
// k_lo = max(0, len - window) under a sliding window.  Keys outside that
// range are left out by predicate, never multiplied by 0: garbage, inf or
// nan in a page's tail past the cursor cannot reach a sum, and table
// entries past the cursor (trash page 0) are never read at all.  A row
// with len = 0 writes 0.
//
// Inhibitor.  Per attendable pair the kernel evaluates eq. 6 / eq. 7
// directly: relu(v - z) unsigned; relu(v+ - z) + min(v- + z, 0) signed.
// The fused eq. 9 / 10 forms of the reference are the same sums
// decomposed for vectorised hardware (identical for z >= 0, which the
// relu shift guarantees); per element the direct form is cheaper and
// rounds less.  Output / max(count, 1) when normalizing.  Inhibition
// partials are plain sums: a later split of a long context over several
// blocks combines partial sums and counts by addition, with no rescaling.
//
// Softmax.  Online recurrence per query head: running max and
// denominator in shared memory, updated once per staged round by one
// thread per head; a round with no attendable key contributes nothing
// (the reference's fully-masked-page rule, paged.py:293-296); out =
// acc / max(l, 1e-20).
//
// Bound on this card.  Each KV byte is read once; per (query head, key,
// dim) the inhibitor does ~7 float32 operations on CUDA cores (|q-k|
// sub/abs/add, then select, add/sub, clamp, accumulate) and the Softmax
// ~4 (two FMAs plus the exp share).  At group 3 and 2-byte KV that is
// about 5 and 3 operations per KV byte, below the H100's ~20 float32
// operations per byte of HBM bandwidth: both kernels are bound by the
// bytes of the valid pages.  This first version launches only
// batch * kv_heads blocks and stages with plain loads; splitting long
// contexts over blocks and cp.async/TMA staging come later.

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

template <typename T>
__global__ void paged_attention_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int group = a.heads / a.kv_heads;
  const int d = a.head_dim, ps = a.page_size;
  const int kb = a.pages_per_step * ps;
  float* qs = smem;
  float* ks = qs + group * d;
  float* vs = ks + (size_t)kb * d;
  float* zs = vs + (size_t)kb * d;
  float* m_run = zs + (size_t)group * kb;
  float* l_run = m_run + group;
  float* alpha_s = l_run + group;

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
  if (tid < group) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }

  const Walk w = make_walk(a, row);
  const int* table = a.tables + (size_t)row * a.table_width;
  const float inv_scale = 1.0f / a.scale;
  float acc = 0.0f;
  __syncthreads();

  for (int p0 = w.first_page; p0 < w.last_page; p0 += a.pages_per_step) {
    const int nk = min(a.pages_per_step, w.last_page - p0) * ps;
    const int kbase = p0 * ps;
    const int j_lo = max(0, w.k_lo - kbase);
    const int j_hi = min(nk, w.k_hi - kbase);
    stage_pages<T>(a, table, kvh, p0, nk, ks, vs);
    __syncthreads();
    for (int pr = warp; pr < group * nk; pr += nwarps) {
      const int gg = pr / nk, j = pr - (pr / nk) * nk;
      float s = 0.0f;
      for (int e = lane; e < d; e += 32) s += qs[gg * d + e] * ks[j * d + e];
      s = warp_sum(s);
      if (lane == 0) zs[gg * kb + j] = s * inv_scale;
    }
    __syncthreads();
    // online-softmax bookkeeping: one thread per query head of the group
    if (tid < group) {
      float* zg = zs + (size_t)tid * kb;
      if (j_hi > j_lo) {
        float mx = -INFINITY;
        for (int j = j_lo; j < j_hi; ++j) mx = fmaxf(mx, zg[j]);
        const float m_prev = m_run[tid];
        const float m_new = fmaxf(m_prev, mx);
        const float alpha = m_prev == -INFINITY ? 0.0f : expf(m_prev - m_new);
        float lsum = 0.0f;
        for (int j = 0; j < nk; ++j) {
          const float p = (j >= j_lo && j < j_hi) ? expf(zg[j] - m_new) : 0.0f;
          zg[j] = p;
          lsum += p;
        }
        l_run[tid] = l_run[tid] * alpha + lsum;
        m_run[tid] = m_new;
        alpha_s[tid] = alpha;
      } else {
        for (int j = 0; j < nk; ++j) zg[j] = 0.0f;
        alpha_s[tid] = 1.0f;
      }
    }
    __syncthreads();
    if (owner) {
      acc *= alpha_s[g];
      for (int j = j_lo; j < j_hi; ++j) acc += zs[g * kb + j] * vs[j * d + dd];
    }
    __syncthreads();
  }
  if (owner) out[qo_base + tid] = from_f32<T>(acc / fmaxf(l_run[g], 1e-20f));
}

template <typename T>
cudaError_t launch(bool inhibitor, const DecodeArgs& a, int batch,
                   cudaStream_t stream) {
  const int group = a.heads / a.kv_heads;
  const int threads = ((group * a.head_dim + 31) / 32) * 32;
  const int kb = a.pages_per_step * a.page_size;
  const size_t smem = sizeof(float) * smem_floats(group, a.head_dim, kb);
  void (*kern)(DecodeArgs) =
      inhibitor ? paged_inhibitor_kernel<T> : paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<batch * a.kv_heads, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(bool inhibitor, int dtype, const DecodeArgs& a,
                     int batch, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<float>(inhibitor, a, batch, stream);
    case 1: return launch<__nv_bfloat16>(inhibitor, a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
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
  return (int)dispatch(true, dtype, a, batch, (cudaStream_t)stream);
}

extern "C" int paged_attention_decode(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int table_width,
    int pages_per_step, float scale, int window, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, tables, lengths, out, heads,
                     kv_heads, head_dim, page_size, table_width,
                     pages_per_step, scale, 0.0f, 0, 0, window};
  return (int)dispatch(false, dtype, a, batch, (cudaStream_t)stream);
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
