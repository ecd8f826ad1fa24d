// Paged single-query decode kernels for Hopper (sm_90a): the inhibitor
// (paper eq. 5-7) and the Softmax dot-product baseline, each walking a
// row's block table over a shared pool of KV pages.
//
// Replaces the TPU kernels of src/repro/kernels/paged.py:
//   paged_inhibitor_split_kernel  <- _paged_inhibitor_kernel (paged.py:124)
//   + paged_inhibitor_merge_kernel
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
// page 0) are never read at all.  A row with no attendable key writes 0.
//
// One design, twice: both kernels are split over pages (flash-decoding).
// One block of 4 warps per (row, kv head, split), n_splits =
// ceil(table_width / pages_per_step) (at least 1), fixed at launch from
// the table width: the host never reads lengths.  Split s covers keys
// [s * pages_per_step * ps, (s + 1) * pages_per_step * ps).  The block
// serves the `group = heads / kv_heads` query heads that share its kv
// head (head = kv_head * group + g).  Nothing is staged in shared
// memory: each lane loads 16 bytes of a key row (8 bf16 or 4 float)
// straight from the pool, so L = head_dim / 8 lanes (bf16; head_dim / 4
// in float32) cover one key and a warp 32 / L keys per load, 4 loads of
// K and V in flight per lane before any is used (2 above 4 query heads
// per kv head, whose q and sums take twice the registers; groups 1-8
// are built, which covers every config of the reference).  A key past
// the split's end is not loaded: its lanes hold zeros.  Each lane keeps
// its 16 bytes of q for each of the group's query heads in registers as
// float; a partial score over its dims reduces over the key's L lanes by
// xor shuffles.  The lanes of a warp that hold the same dims merge by
// shuffles, the 4 warps through shared memory.  With one split the
// block writes the output itself; otherwise it writes a float32 partial
// per (row, head, split) to scratch, and a small merge kernel, one block
// per (row, head) and one thread per dim, reads the partials of the
// splits that hold an attendable key, in split order, and writes the
// output.  A split that holds no attendable key writes nothing (the
// Softmax: an empty partial) and exits.  Sums are in a fixed order:
// results do not change from run to run.
//
// Inhibitor (paged_inhibitor_split_kernel).  Per (head, key): z =
// max(sum_d |q - k| / gamma - alpha, 0).  For z >= 0 each term of eq. 6
// / eq. 7 folds to a branch-free form, as in the flash inhibitor kernel
// (flash_prefill.cu):
//   signed:   v > 0 ? relu(v - z) : min(v + z, 0) = v - sgn(v) min(|v|, z)
//   unsigned: relu(v - z)                         = v - min(v, z)
// so the block keeps sum_j v once per (kv head, dim), shared by the
// group's heads, and per (head, key, dim) one min and one fma into a
// float32 register: acc += s * min(a, z) with (a, s) = (|v|, -sgn v)
// signed and (v, -1) unsigned, formed once per (key, dim).  A key past
// the split's end holds v = 0 and adds exact zeros.  The partial of a
// (row, head, split) is sum v + acc: inhibition partials are plain sums,
// so the merge adds them (no running max, no rescaling) and divides by
// the count k_hi - k_lo, which it computes from lengths and the window:
// the partials carry no count.
//
// Softmax (paged_attention_split_kernel).  Per (head, key) the dot q.k
// over the key's lanes, then the online softmax (running max from
// -1e30, running sum, rescaled float32 accumulator) per key and head.
// The block's partial is (m, l, acc); with one split it writes acc /
// max(l, 1e-20) itself, and paged_attention_merge_kernel rescales the
// partials of each (row, head) to their common max and writes acc /
// max(l, 1e-20), reading only partials with l > 0.
//
// Bound on this card.  Each KV byte is read once.  Per (query head,
// key, dim) the inhibitor issues 4 float32 instructions on the CUDA
// cores (q - k, an add of its absolute value, min, fma), none of them
// an FMA but the last, plus one add per (kv head, key, dim) for sum v;
// the Softmax 2 FMAs.  At group 3 and 2-byte KV that is about 3.3
// instructions per KV byte for the inhibitor and 1.5 for the Softmax,
// below the H100's 10 per byte of HBM bandwidth at one instruction per
// lane and cycle: both kernels are bound by the bytes of the valid
// pages, about 1.03 MB at the serve shape (0.3 us).  At that size
// neither kernel is near its bound: a launch, the merge's second launch
// and a chain of dependent loads (length, table entry, key row) cost
// microseconds; a CUDA graph of the decode step would hide the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
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

struct Walk {
  int k_lo, k_hi;   // the attendable keys [k_lo, k_hi)
};

__device__ __forceinline__ Walk make_walk(const DecodeArgs& a, int row) {
  const int len = a.lengths[row];
  Walk w;
  w.k_hi = min(len, a.table_width * a.page_size);
  w.k_lo = a.window >= 0 ? max(0, len - a.window) : 0;
  return w;
}

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

// The lane's share of one block-wide load: up to U keys of K and V, 16
// bytes each, all in flight before any is used.  Keys at or past s_hi
// are not loaded; their lanes hold zeros and live[u] is false.
template <typename T, int U, int E>
__device__ __forceinline__ void load_keys(const DecodeArgs& a,
                                          const int* table, int kvh, int col,
                                          int first, int step, int s_hi,
                                          float (&kx)[U][E],
                                          float (&vx)[U][E], bool (&live)[U]) {
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const int ps = a.page_size;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = first + u * step;
    live[u] = j < s_hi;
    if (live[u]) {
      const size_t src =
          (((size_t)table[j / ps] * ps + j % ps) * a.kv_heads + kvh) *
              a.head_dim + col;
      load16(kp + src, kx[u]);
      load16(vp + src, vx[u]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kx[u][e] = vx[u][e] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Inhibitor split over pages
// ---------------------------------------------------------------------------

// shared memory: sum_v[warps][d] | acc[warps][G][d]
__host__ __device__ inline size_t inhibitor_smem_bytes(int group, int d) {
  return sizeof(float) * (size_t)kSplitWarps * (group + 1) * d;
}

// Partials in float32 scratch, for n_splits > 1: sum v + acc of each
// (row, head, split) at ((row * heads + head) * n_splits + split) * d.
template <typename T, int G>
__global__ void __launch_bounds__(kSplitWarps * 32)
    paged_inhibitor_split_kernel(DecodeArgs a, float* scratch) {
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int U = G > 4 ? 2 : 4;    // key loads in flight per lane
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
  T* out = static_cast<T*>(a.out);

  const Walk w = make_walk(a, row);
  const int span = a.pages_per_step * ps;
  const int s_lo = max(w.k_lo, split * span);
  const int s_hi = min(w.k_hi, (split + 1) * span);
  if (s_lo >= s_hi) {   // no attendable key: the merge never reads it
    if (n_splits == 1)
      for (int i = threadIdx.x; i < G * d; i += blockDim.x)
        out[head0 * d + i] = from_f32<T>(0.0f);
    return;
  }

  const T* qg = static_cast<const T*>(a.q);
  const int* table = a.tables + (size_t)row * a.table_width;
  const float inv_scale = 1.0f / a.scale, shift = a.shift;
  const bool is_signed = a.is_signed != 0;
  float qr[G][E], acc[G][E], sv[E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load16(qg + (head0 + g) * d + col, qr[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sv[e] = 0.0f;

  const int step = kSplitWarps * kpw;   // keys per block-wide load
  for (int base = s_lo + warp * kpw; base < s_hi;
       base += U * step) {   // warp-uniform
    float kx[U][E], vx[U][E];
    bool live[U];
    load_keys<T, U, E>(a, table, kvh, col, base + slot, step, s_hi, kx, vx,
                       live);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // per (key, dim), shared by the group's heads
      float av[E], ns[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = vx[u][e];
        sv[e] += v;
        av[e] = is_signed ? fabsf(v) : v;
        ns[e] = is_signed ? -copysignf(1.0f, v) : -1.0f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += fabsf(qr[g][e] - kx[u][e]);
        for (int o = 1; o < lpk; o <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        const float z = fmaxf(s * inv_scale - shift, 0.0f);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(ns[e], fminf(av[e], z), acc[g][e]);
      }
    }
  }

  // merge the warp's key slots (lanes lpk apart hold the same dims)
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sv[e] += __shfl_xor_sync(0xffffffffu, sv[e], o);
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  // merge the warps through shared memory
  float* sm_sv = split_smem;
  float* sm_acc = sm_sv + kSplitWarps * d;
  if (slot == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sm_sv[warp * d + col + e] = sv[e];
#pragma unroll
      for (int g = 0; g < G; ++g)
        sm_acc[(warp * G + g) * d + col + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * d; i += blockDim.x) {
    const int g = i / d, e = i - g * d;
    float t = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kSplitWarps; ++wi)
      t += sm_sv[wi * d + e] + sm_acc[(wi * G + g) * d + e];
    if (n_splits == 1)
      out[head0 * d + i] = from_f32<T>(
          a.normalize ? t / (float)(w.k_hi - w.k_lo) : t);
    else
      scratch[((head0 + g) * n_splits + split) * d + e] = t;
  }
}

// One block per (row, head), one thread per dim: the partials of the
// splits overlapping [k_lo, k_hi), added in split order; out = sum /
// count (count = k_hi - k_lo) when normalizing.
template <typename T>
__global__ void paged_inhibitor_merge_kernel(DecodeArgs a, int n_splits,
                                             const float* scratch) {
  const int d = a.head_dim, e = threadIdx.x;
  const size_t rh = blockIdx.x;   // row * heads + head
  const Walk w = make_walk(a, (int)(rh / a.heads));
  const int span = a.pages_per_step * a.page_size;
  const float* p = scratch + rh * n_splits * d + e;
  float t = 0.0f;
  if (w.k_lo < w.k_hi)
    for (int s = w.k_lo / span; s <= (w.k_hi - 1) / span; ++s)
      t += p[(size_t)s * d];
  if (a.normalize) t /= (float)max(w.k_hi - w.k_lo, 1);
  static_cast<T*>(a.out)[rh * d + e] = from_f32<T>(t);
}

// ---------------------------------------------------------------------------
// Softmax split over pages
// ---------------------------------------------------------------------------

// Partials in float32 scratch, for n_splits > 1: `count` = batch * heads
// * n_splits entries (index (row * heads + head) * n_splits + split) of
// m | l | acc[head_dim].
struct Partials {
  float *m, *l, *acc;
  __device__ Partials(float* base, size_t count)
      : m(base), l(base + count), acc(base + 2 * count) {}
};

// shared memory: m[warps][G] | l[warps][G] | acc[warps][G][d]
__host__ __device__ inline size_t attention_smem_bytes(int group, int d) {
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
    load_keys<T, U, E>(a, table, kvh, col, base + slot, step, s_hi, kx, vx,
                       live);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int G, bool INHIBITOR>
cudaError_t launch_split(const DecodeArgs& a, int batch, float* scratch,
                         cudaStream_t stream) {
  const int n_splits =
      max(1, (a.table_width + a.pages_per_step - 1) / a.pages_per_step);
  const dim3 grid(batch * a.kv_heads, n_splits);
  const int threads = kSplitWarps * 32;
  if constexpr (INHIBITOR)
    paged_inhibitor_split_kernel<T, G>
        <<<grid, threads, inhibitor_smem_bytes(G, a.head_dim), stream>>>(
            a, scratch);
  else
    paged_attention_split_kernel<T, G>
        <<<grid, threads, attention_smem_bytes(G, a.head_dim), stream>>>(
            a, batch, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  if constexpr (INHIBITOR)
    paged_inhibitor_merge_kernel<T>
        <<<batch * a.heads, a.head_dim, 0, stream>>>(a, n_splits, scratch);
  else
    paged_attention_merge_kernel<T>
        <<<batch * a.heads, a.head_dim, 0, stream>>>(a, batch, n_splits,
                                                     scratch);
  return cudaGetLastError();
}

template <typename T, bool INHIBITOR>
cudaError_t dispatch_split(const DecodeArgs& a, int batch, float* scratch,
                           cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int lpk = a.head_dim / E;
  if (a.head_dim % E || lpk < 1 || lpk > 32 || (lpk & (lpk - 1)) ||
      a.pages_per_step < 1)
    return cudaErrorInvalidValue;
  switch (a.heads / a.kv_heads) {
    case 1: return launch_split<T, 1, INHIBITOR>(a, batch, scratch, stream);
    case 2: return launch_split<T, 2, INHIBITOR>(a, batch, scratch, stream);
    case 3: return launch_split<T, 3, INHIBITOR>(a, batch, scratch, stream);
    case 4: return launch_split<T, 4, INHIBITOR>(a, batch, scratch, stream);
    case 5: return launch_split<T, 5, INHIBITOR>(a, batch, scratch, stream);
    case 6: return launch_split<T, 6, INHIBITOR>(a, batch, scratch, stream);
    case 7: return launch_split<T, 7, INHIBITOR>(a, batch, scratch, stream);
    case 8: return launch_split<T, 8, INHIBITOR>(a, batch, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool INHIBITOR>
int dispatch_dtype(int dtype, const DecodeArgs& a, int batch, void* scratch,
                   void* stream) {
  float* part = static_cast<float*>(scratch);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)dispatch_split<float, INHIBITOR>(a, batch, part, s);
    case 1: return (int)dispatch_split<__nv_bfloat16, INHIBITOR>(a, batch,
                                                                 part, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entries: dtype 0 float32, 1 bfloat16; pages_per_step pages per
// split, n_splits = max(1, ceil(table_width / pages_per_step));
// head_dim * element size / 16 must be a power of two <= 32 and 1 <=
// group <= 8; q and the pools 16-byte aligned.  Each returns a
// cudaError_t code (0 = launched); the launches are asynchronous on
// `stream`.

// The inhibitor: `scratch` holds batch * heads * n_splits * head_dim
// floats (unused with one split).
extern "C" int paged_inhibitor_decode(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int table_width,
    int pages_per_step, float scale, float shift, int is_signed,
    int normalize, int window, void* scratch, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, tables, lengths, out, heads,
                     kv_heads, head_dim, page_size, table_width,
                     pages_per_step, scale, shift, is_signed, normalize,
                     window};
  return dispatch_dtype<true>(dtype, a, batch, scratch, stream);
}

// The Softmax: `scratch` holds batch * heads * n_splits * (head_dim + 2)
// floats (unused with one split).
extern "C" int paged_attention_decode(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int table_width,
    int pages_per_step, float scale, int window, void* scratch,
    void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, tables, lengths, out, heads,
                     kv_heads, head_dim, page_size, table_width,
                     pages_per_step, scale, 0.0f, 0, 0, window};
  return dispatch_dtype<false>(dtype, a, batch, scratch, stream);
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
