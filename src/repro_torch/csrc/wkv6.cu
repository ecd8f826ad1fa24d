// RWKV-6 (Finch) WKV chunked scan from a zero state, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   wkv6_kernel <- _wkv6_kernel (src/repro/kernels/rwkv6.py:43)
//
// Per (batch, head) row, with state S (n x n) and n = head_dim:
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// Layouts (row-major, contiguous):
//   r, k, v (batch, t, heads, n)   T (float or __nv_bfloat16)
//   w       (batch, t, heads, n)   float, the decay in [0, 1]
//   u       (heads, n)             float, the bonus
//   out     (batch, t, heads, n)   float
//   state   (batch, heads, n, n)   float, the state after position t-1
// All arithmetic is float32.
//
// Design.  The TPU kernel carries S in VMEM scratch across a sequential
// grid axis of chunks.  CUDA blocks run in no order and hand nothing to
// one another, so one block owns one (batch, head) row and loops over
// its chunks itself; S stays in shared memory for the whole sequence
// and is written to device memory once, at the end.  Per chunk of L
// positions (the chunked form of the TPU kernel, the same arithmetic as
// the plain version, repro_torch.nn.ssm.wkv6_chunk):
//   1. stage r, k, v, log(max(w, 1e-30)) as float; positions past t read
//      as k = v = 0 and log w = 0, so they add nothing to S;
//   2. cw = cumulative log decay per channel, cw_prev = cw - log w
//      (one thread per channel);
//   3. A[t][s] = sum_e r[t][e] k[s][e] exp(min(cw_prev[t][e] - cw[s][e], 0))
//      for s < t (one warp per row t, one lane per s), and the diagonal
//      bonus A[t][t] = sum_e r[t][e] u[e] k[t][e];
//   4. in place: r <- r exp(cw_prev), k <- k exp(cw_L - cw);
//   5. o[t][m] = sum_e r[t][e] S[e][m] + sum_{s<=t} A[t][s] v[s][m]
//      (one thread per column m and every (threads / n)-th row);
//   6. S[e][m] <- exp(cw_L[e]) S[e][m] + sum_s k[s][e] v[s][m].
// Every exponent is a difference of the cumulative log decay with the
// later index subtracted, so <= 0 (step 3 clamps the rounding of cw_prev):
// no exp overflows at any decay, and nothing is rescaled.  Rows of r, k
// and the two cumulative sums are padded to n + 1 floats, so the 32 lanes
// of step 3, reading 32 positions s of one channel, hit 32 banks; in
// steps 5 and 6 a warp reads one row broadcast and n consecutive columns.
//
// Bound on this card.  At the train shape (batch 8, t 1024, 64 heads of
// 64, bf16 r/k/v) the least float32 work is the chunked form at its
// cheapest chunk, 5 positions: about 4.5 n^2 operations per position
// and head (the recurrence at one position per chunk takes 5 n^2, this
// kernel's 32-position chunks 5.6 n^2), 9.7 GFLOP in all: 0.145 ms at
// the 67 TFLOP/s of the CUDA cores, beside 478 MB of operands (0.143 ms
// at 3.35 TB/s).  This first version runs all three products on the
// CUDA cores from shared memory, one load per operation, with 512
// blocks for 132 SMs; putting them on the tensor cores (mma.sync /
// wgmma over 32 x 64 x 64 tiles) and overlapping the next
// chunk's loads (cp.async / TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr float kWFloor = 1e-30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Wkv6Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  float* out;
  float* state;
  int batch;
  int t;
  int heads;
  int chunk;
};

// Shared-memory floats for head_dim n and chunk L: S, four padded (L, n+1)
// arrays (r, k, cw, cw_prev), v (L, n), A (L, L+1) and u.
size_t smem_floats(int n, int chunk) {
  return (size_t)n * n + 4 * (size_t)chunk * (n + 1) + (size_t)chunk * n +
         (size_t)chunk * (chunk + 1) + n;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(Wkv6Args a) {
  extern __shared__ float smem[];
  constexpr int P = N + 1;
  const int L = a.chunk;
  float* S = smem;
  float* rs = S + N * N;
  float* ks = rs + L * P;
  float* cw = ks + L * P;
  float* cwp = cw + L * P;
  float* vs = cwp + L * P;
  float* A = vs + L * N;
  float* us = A + L * (L + 1);

  const int row = blockIdx.x;                 // b * heads + h
  const int h = row % a.heads;
  const int b = row / a.heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t pos_stride = (size_t)a.heads * N;
  const size_t base = ((size_t)b * a.t * a.heads + h) * N;

  for (int i = tid; i < N * N; i += kThreads) S[i] = 0.f;
  for (int i = tid; i < N; i += kThreads) us[i] = a.u[h * N + i];

  const int n_chunks = (a.t + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    // 1. stage the chunk (the previous chunk's last reads ended in a sync)
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, e = i % N;
      float rv = 0.f, kv = 0.f, vv = 0.f, lw = 0.f;
      if (t0 + t < a.t) {
        const size_t off = base + (size_t)(t0 + t) * pos_stride + e;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        lw = logf(fmaxf(a.w[off], kWFloor));
      }
      rs[t * P + e] = rv;
      ks[t * P + e] = kv;
      vs[t * N + e] = vv;
      cw[t * P + e] = lw;
    }
    __syncthreads();
    // 2. cumulative log decay per channel
    for (int e = tid; e < N; e += kThreads) {
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = cw[t * P + e];
        run += lw;
        cw[t * P + e] = run;
        cwp[t * P + e] = run - lw;
      }
    }
    __syncthreads();
    // 3. the strictly lower intra-chunk matrix and the diagonal bonus
    for (int t = warp; t < L; t += kWarps) {
      for (int s = lane; s < L; s += 32) {
        float acc = 0.f;
        if (s < t) {
#pragma unroll 8
          for (int e = 0; e < N; ++e)
            acc += rs[t * P + e] * ks[s * P + e] *
                   expf(fminf(cwp[t * P + e] - cw[s * P + e], 0.f));
        } else if (s == t) {
#pragma unroll 8
          for (int e = 0; e < N; ++e)
            acc += rs[t * P + e] * us[e] * ks[t * P + e];
        }
        A[t * (L + 1) + s] = acc;
      }
    }
    __syncthreads();
    // 4. decay-scaled r (for the carry) and k (for the state update)
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, e = i % N;
      rs[t * P + e] *= expf(cwp[t * P + e]);
      ks[t * P + e] *= expf(cw[(L - 1) * P + e] - cw[t * P + e]);
    }
    __syncthreads();
    // 5. outputs: the carry through S, then the intra-chunk sum
    {
      const int m = tid % N;
      for (int t = tid / N; t < L; t += kThreads / N) {
        float acc = 0.f;
#pragma unroll 8
        for (int e = 0; e < N; ++e) acc += rs[t * P + e] * S[e * N + m];
        for (int s = 0; s <= t; ++s) acc += A[t * (L + 1) + s] * vs[s * N + m];
        if (t0 + t < a.t) a.out[base + (size_t)(t0 + t) * pos_stride + m] = acc;
      }
    }
    __syncthreads();
    // 6. the state update
    {
      const int m = tid % N;
      for (int e = tid / N; e < N; e += kThreads / N) {
        float acc = expf(cw[(L - 1) * P + e]) * S[e * N + m];
        for (int s = 0; s < L; ++s) acc += ks[s * P + e] * vs[s * N + m];
        S[e * N + m] = acc;
      }
    }
    __syncthreads();
  }
  float* st = a.state + (size_t)row * N * N;
  for (int i = tid; i < N * N; i += kThreads) st[i] = S[i];
}

template <typename T, int N>
cudaError_t launch(const Wkv6Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(N, a.chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, N><<<a.batch * a.heads, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int n, const Wkv6Args& a, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<T, 8>(a, stream);
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch the WKV scan on `stream`; returns the launch's cudaError_t (0 on
// success).  dtype: 0 float, 1 bfloat16 (r, k, v); head_dim in {8, 16,
// 32, 64}; 1 <= chunk <= 64 (at most 116 KB of shared memory a block).
extern "C" int wkv6_chunked_fwd(int dtype, const void* r, const void* k,
                                const void* v, const float* w,
                                const float* u, float* out, float* state,
                                int batch, int t, int heads, int head_dim,
                                int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || batch < 0 || t < 0 || heads < 0)
    return (int)cudaErrorInvalidValue;
  const Wkv6Args a{r, k, v, w, u, out, state, batch, t, heads, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_n<float>(head_dim, a, s);
  if (dtype == 1) return (int)dispatch_n<__nv_bfloat16>(head_dim, a, s);
  return (int)cudaErrorInvalidValue;
}
