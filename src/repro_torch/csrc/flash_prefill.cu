// Blockwise prefill / training forward kernels for Hopper (sm_90a): the
// inhibitor (paper eq. 5-7) and the Softmax dot-product baseline, over
// contiguous (batch, n, heads, head_dim) operands.
//
// Replaces the TPU kernels
//   flash_inhibitor_kernel <- _flash_inhibitor_kernel
//                             (src/repro/kernels/inhibitor.py:99)
//   flash_attention_kernel <- _flash_attention_kernel
//                             (src/repro/kernels/flash.py:35)
//
// Layouts (row-major, contiguous):
//   q, out  (batch, n_q, heads, head_dim)      T
//   k, v    (batch, n_k, kv_heads, head_dim)   T
//   cursors (2, batch) int32 or null: row 0 query offsets, row 1 KV valid
//           lengths (the decode-cache form; null = offset 0, all n_k keys)
// T is float or __nv_bfloat16; all arithmetic is float32.
//
// Masking.  Query i of row r sits at position q_off[r] + i.  Key j is
// attended iff j < min(kv_valid[r], n_k), and, when causal (a window
// implies causality), j <= pos, and, with a window, j > pos - window.
// Masked pairs are left out by predicate, never multiplied by 0: nan or
// inf past a cursor cannot reach a sum, and keys past the last key any
// query of the tile attends are never read.  The key count of each query
// is the closed form of the same predicate.
//
// Design.  One block per (row, kv head, tile of block_q queries): the
// TPU's sequential kv grid axis becomes a loop inside the block over
// 32-key tiles, from the tile holding the first key any query of the
// block attends to the last (tiles wholly above the causal diagonal,
// below the window or past the cursor are skipped).  All `group = heads /
// kv_heads` query heads of the kv head share each staged K/V tile, as on
// the TPU.  Shared memory holds Q (group*block_q rows), the K and V tile
// (rows padded to head_dim + 1 floats, so the 32 lanes reading 32 keys
// hit 32 banks) and the tile's scores.  Per tile:
//   1. stage K, V as float;
//   2. scores: one warp per query row, one lane per key, the sum over
//      head_dim from shared memory;
//   3. accumulate: each thread owns one head_dim column e and up to 16
//      query rows, its outputs in float32 registers; it reads V[j][e] once
//      per key and the rows' scores as warp broadcasts.
// The inhibitor evaluates the direct form relu(v - z) (unsigned) or
// relu(v+ - z) + min(v- + z, 0) = (v > 0 ? relu(v - z) : min(v + z, 0))
// (signed), identical to the fused eq. 9 / 10 for z >= 0 (the relu shift
// guarantees it), cheaper per element and rounding less; out / max(count,
// 1) when normalizing.  Its sums are plain: no rescaling between tiles.
// The Softmax kernel keeps a running max (from -1e30), a running sum and
// a rescaled accumulator per row: the score warp also does the row's
// online-softmax bookkeeping with shuffles.  A row with no attended key
// writes 0 (flash.py:92-95); out = acc / max(l, 1e-20).
//
// Bound on this card.  At the training shapes (b 8, n 1024 causal, 9 / 3
// heads, d 64, bf16) the inhibitor does ~7 float32 operations per (query
// head, attended key, d): 2.4e9 such elements, 17 GFLOP, about 0.25 ms at
// the 67 TFLOP/s of the CUDA cores, against 25 MB of operands (7.5 us at
// 3.35 TB/s): bound by operations, which no tensor core can take (a sum of
// absolute differences is no product).  The Softmax kernel's 9.7 GFLOP
// would take 10 us on the bf16 tensor cores; this first version runs
// them on the CUDA cores in float32.  Both are limited in practice by the
// shared-memory loads of steps 2 and 3 (about one per operation); a
// register-tiled score phase, mma.sync / wgmma for the Softmax products
// and cp.async / TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 32;   // keys per staged tile: one per lane
constexpr int kMaxAcc = 16;   // output rows per thread
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* cursors;  // (2, batch) or null
  void* out;
  int batch;
  int n_q;
  int n_k;
  int heads;
  int kv_heads;
  int block_q;
  float scale;
  float shift;
  int is_signed;
  int normalize;
  int causal;
  int window;  // < 0: no sliding window
};

// Shared-memory carve-up, in floats (R = group * block_q, dp = d + 1):
//   qs[R*dp] | ks[32*dp] | vs[32*dp] | zs[R*32] | m[R] | l[R] | alpha[R]
__host__ __device__ inline size_t smem_floats(int group, int block_q, int d) {
  const size_t r = (size_t)group * block_q, dp = (size_t)d + 1;
  return r * dp + 2 * (size_t)kBlockK * dp + r * kBlockK + 3 * r;
}

// Per-query attendable key range [lo, hi): the mask predicate in closed
// form.  Queries past n_q get an empty range.
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange key_range(const PrefillArgs& a, int q_off,
                                              int kv_valid, int qi) {
  KeyRange kr{0, 0};
  if (qi >= a.n_q) return kr;
  const int pos = q_off + qi;
  kr.hi = kv_valid;
  if (a.causal || a.window >= 0) kr.hi = min(kr.hi, pos + 1);
  if (a.window >= 0) kr.lo = max(0, pos - a.window + 1);
  return kr;
}

// Block-level state shared by both kernels: where the block's queries and
// keys lie and the key-tile range it walks.
template <int D>
struct BlockCtx {
  int row, kvh, group, R, q0, q_off, kv_valid, k_first, k_end;

  __device__ explicit BlockCtx(const PrefillArgs& a) {
    row = blockIdx.x / a.kv_heads;
    kvh = blockIdx.x - row * a.kv_heads;
    group = a.heads / a.kv_heads;
    R = group * a.block_q;
    q0 = blockIdx.y * a.block_q;
    q_off = a.cursors ? a.cursors[row] : 0;
    kv_valid = a.cursors ? min(a.n_k, a.cursors[a.batch + row]) : a.n_k;
    // union of the block's query ranges: first query's lo, last's hi
    const int last = min(a.n_q, q0 + a.block_q) - 1;
    const KeyRange first_r = key_range(a, q_off, kv_valid, q0);
    const KeyRange last_r = key_range(a, q_off, kv_valid, last);
    k_first = (first_r.lo / kBlockK) * kBlockK;
    k_end = max(0, last_r.hi);
  }
};

template <typename T, int D>
__device__ __forceinline__ void stage_q(const PrefillArgs& a,
                                        const BlockCtx<D>& c, float* qs) {
  const T* q = static_cast<const T*>(a.q);
  for (int idx = threadIdx.x; idx < c.R * D; idx += kThreads) {
    const int r = idx / D, e = idx - (idx / D) * D;
    const int g = r / a.block_q, i = r - g * a.block_q;
    const int qi = c.q0 + i;
    float val = 0.0f;
    if (qi < a.n_q)
      val = to_f32<T>(q[(((size_t)c.row * a.n_q + qi) * a.heads +
                         (size_t)c.kvh * c.group + g) * D + e]);
    qs[r * (D + 1) + e] = val;
  }
}

template <typename T, int D>
__device__ __forceinline__ void stage_kv(const PrefillArgs& a,
                                         const BlockCtx<D>& c, int k0, int nk,
                                         float* ks, float* vs) {
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int j = idx / D, e = idx - (idx / D) * D;
    float kv = 0.0f, vv = 0.0f;
    if (j < nk) {
      const size_t src =
          (((size_t)c.row * a.n_k + k0 + j) * a.kv_heads + c.kvh) * D + e;
      kv = to_f32<T>(k[src]);
      vv = to_f32<T>(v[src]);
    }
    ks[j * (D + 1) + e] = kv;
    vs[j * (D + 1) + e] = vv;
  }
}

// Output ownership: thread t owns column e = t % D of rows
// r = t / D + s * (kThreads / D), s < kMaxAcc (rows past R are idle).
template <int D>
struct Owner {
  static constexpr int kRowsPerPass = kThreads / D;
  int e, r0;
  __device__ Owner() : e(threadIdx.x % D), r0(threadIdx.x / D) {}
  __device__ __forceinline__ int row(int s) const {
    return r0 + s * kRowsPerPass;
  }
};

template <typename T, int D>
__device__ __forceinline__ void write_out(const PrefillArgs& a,
                                          const BlockCtx<D>& c,
                                          const Owner<D>& w, int s,
                                          float val) {
  const int r = w.row(s);
  const int g = r / a.block_q, i = r - g * a.block_q;
  T* out = static_cast<T*>(a.out);
  out[(((size_t)c.row * a.n_q + c.q0 + i) * a.heads +
       (size_t)c.kvh * c.group + g) * D + w.e] = from_f32<T>(val);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_inhibitor_kernel(PrefillArgs a) {
  extern __shared__ float smem[];
  constexpr int dp = D + 1;
  const BlockCtx<D> c(a);
  float* qs = smem;
  float* ks = qs + (size_t)c.R * dp;
  float* vs = ks + kBlockK * dp;
  float* zs = vs + kBlockK * dp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Owner<D> w;
  stage_q<T, D>(a, c, qs);

  float acc[kMaxAcc];
  int lo[kMaxAcc], hi[kMaxAcc];
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) {
    acc[s] = 0.0f;
    const int r = w.row(s);
    const KeyRange kr =
        r < c.R ? key_range(a, c.q_off, c.kv_valid,
                            c.q0 + r % a.block_q)
                : KeyRange{0, 0};
    lo[s] = kr.lo;
    hi[s] = kr.hi;
  }
  const float inv_scale = 1.0f / a.scale;

  for (int k0 = c.k_first; k0 < c.k_end; k0 += kBlockK) {
    const int nk = min(kBlockK, c.k_end - k0);
    __syncthreads();  // q staged; the previous tile's readers are done
    stage_kv<T, D>(a, c, k0, nk, ks, vs);
    __syncthreads();
    // scores Z = relu(sum_d |q - k| / gamma - alpha): warp per row
    for (int r = warp; r < c.R; r += kWarps) {
      const float* qr = qs + r * dp;
      const float* kr = ks + lane * dp;
      float sum = 0.0f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) sum += fabsf(qr[e] - kr[e]);
      float z = sum * inv_scale;
      if (a.shift != 0.0f) z = fmaxf(z - a.shift, 0.0f);
      zs[r * kBlockK + lane] = z;
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float v = vs[j * dp + w.e];
      const int kp = k0 + j;
#pragma unroll
      for (int s = 0; s < kMaxAcc; ++s) {
        if (kp >= lo[s] && kp < hi[s]) {
          const float z = zs[w.row(s) * kBlockK + j];
          if (a.is_signed)
            acc[s] += v > 0.0f ? fmaxf(v - z, 0.0f) : fminf(v + z, 0.0f);
          else
            acc[s] += fmaxf(v - z, 0.0f);
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) {
    const int r = w.row(s);
    if (r >= c.R || c.q0 + r % a.block_q >= a.n_q) continue;
    float o = acc[s];
    if (a.normalize) o = o / fmaxf((float)max(0, hi[s] - lo[s]), 1.0f);
    write_out<T, D>(a, c, w, s, o);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(PrefillArgs a) {
  extern __shared__ float smem[];
  constexpr int dp = D + 1;
  const BlockCtx<D> c(a);
  float* qs = smem;
  float* ks = qs + (size_t)c.R * dp;
  float* vs = ks + kBlockK * dp;
  float* zs = vs + kBlockK * dp;
  float* m_run = zs + (size_t)c.R * kBlockK;
  float* l_run = m_run + c.R;
  float* alpha_s = l_run + c.R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Owner<D> w;
  stage_q<T, D>(a, c, qs);
  for (int r = threadIdx.x; r < c.R; r += kThreads) {
    m_run[r] = kNegInf;
    l_run[r] = 0.0f;
  }

  float acc[kMaxAcc];
  int lo[kMaxAcc], hi[kMaxAcc];
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) {
    acc[s] = 0.0f;
    const int r = w.row(s);
    const KeyRange kr =
        r < c.R ? key_range(a, c.q_off, c.kv_valid,
                            c.q0 + r % a.block_q)
                : KeyRange{0, 0};
    lo[s] = kr.lo;
    hi[s] = kr.hi;
  }
  const float inv_scale = 1.0f / a.scale;

  for (int k0 = c.k_first; k0 < c.k_end; k0 += kBlockK) {
    const int nk = min(kBlockK, c.k_end - k0);
    __syncthreads();
    stage_kv<T, D>(a, c, k0, nk, ks, vs);
    __syncthreads();
    // scores and the online-softmax bookkeeping: warp per row
    for (int r = warp; r < c.R; r += kWarps) {
      const float* qr = qs + r * dp;
      const float* kr = ks + lane * dp;
      float dot = 0.0f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) dot += qr[e] * kr[e];
      const KeyRange rr =
          key_range(a, c.q_off, c.kv_valid, c.q0 + r % a.block_q);
      const int kp = k0 + lane;
      const bool live = lane < nk && kp >= rr.lo && kp < rr.hi;
      const float sc = dot * inv_scale;
      const float mx = warp_max(live ? sc : -INFINITY);
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = live ? expf(sc - m_new) : 0.0f;
      const float lsum = warp_sum(p);
      zs[r * kBlockK + lane] = p;
      if (lane == 0) {
        const float alpha = m_prev == kNegInf ? 0.0f : expf(m_prev - m_new);
        l_run[r] = l_run[r] * alpha + lsum;
        m_run[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxAcc; ++s)
      if (w.row(s) < c.R) acc[s] *= alpha_s[w.row(s)];
    for (int j = 0; j < nk; ++j) {
      const float v = vs[j * dp + w.e];
      const int kp = k0 + j;
#pragma unroll
      for (int s = 0; s < kMaxAcc; ++s)
        if (kp >= lo[s] && kp < hi[s])
          acc[s] += zs[w.row(s) * kBlockK + j] * v;
    }
  }
  __syncthreads();  // l_run is final (and initialised when no tile ran)
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) {
    const int r = w.row(s);
    if (r >= c.R || c.q0 + r % a.block_q >= a.n_q) continue;
    write_out<T, D>(a, c, w, s, acc[s] / fmaxf(l_run[r], 1e-20f));
  }
}

template <typename T, int D>
cudaError_t launch(bool inhibitor, const PrefillArgs& a,
                   cudaStream_t stream) {
  const int group = a.heads / a.kv_heads;
  const size_t smem = sizeof(float) * smem_floats(group, a.block_q, D);
  void (*kern)(PrefillArgs) =
      inhibitor ? flash_inhibitor_kernel<T, D> : flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.batch * a.kv_heads, (a.n_q + a.block_q - 1) / a.block_q);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(bool inhibitor, int head_dim, const PrefillArgs& a,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(inhibitor, a, stream);
    case 32: return launch<T, 32>(inhibitor, a, stream);
    case 64: return launch<T, 64>(inhibitor, a, stream);
    case 128: return launch<T, 128>(inhibitor, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(bool inhibitor, int dtype, int head_dim,
                     const PrefillArgs& a, cudaStream_t stream) {
  switch (dtype) {
    case 0: return dispatch_d<float>(inhibitor, head_dim, a, stream);
    case 1: return dispatch_d<__nv_bfloat16>(inhibitor, head_dim, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; head_dim 16, 32, 64 or 128.  Returns a
// cudaError_t code (0 = launched); the launch is asynchronous on `stream`.
extern "C" int flash_inhibitor_prefill(
    int dtype, const void* q, const void* k, const void* v,
    const int* cursors, void* out, int batch, int n_q, int n_k, int heads,
    int kv_heads, int head_dim, int block_q, float scale, float shift,
    int is_signed, int normalize, int causal, int window, void* stream) {
  const PrefillArgs a{q,     k,     v,     cursors,   out,   batch,
                      n_q,   n_k,   heads, kv_heads,  block_q, scale,
                      shift, is_signed, normalize, causal, window};
  return (int)dispatch(true, dtype, head_dim, a, (cudaStream_t)stream);
}

extern "C" int flash_attention_prefill(
    int dtype, const void* q, const void* k, const void* v,
    const int* cursors, void* out, int batch, int n_q, int n_k, int heads,
    int kv_heads, int head_dim, int block_q, float scale, int causal,
    int window, void* stream) {
  const PrefillArgs a{q,   k,   v,     cursors,  out,     batch,
                      n_q, n_k, heads, kv_heads, block_q, scale,
                      0.0f, 0,  0,     causal,   window};
  return (int)dispatch(false, dtype, head_dim, a, (cudaStream_t)stream);
}

// Shared-memory bytes one launch needs (the wrapper checks the limit).
extern "C" long long flash_prefill_smem_bytes(int group, int block_q,
                                              int head_dim) {
  return (long long)(sizeof(float) * smem_floats(group, block_q, head_dim));
}

// Most output elements (group * block_q * head_dim) one block can hold.
extern "C" int flash_prefill_max_outputs() { return kMaxAcc * kThreads; }
