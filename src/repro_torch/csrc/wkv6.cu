// RWKV-6 (Finch) WKV chunked scan from a zero state, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   wkv6_tc_kernel <- _wkv6_kernel (src/repro/kernels/rwkv6.py:43)
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
// The chunked form (the TPU kernel's, and the plain version's,
// repro_torch.nn.ssm.wkv6_chunk).  Per chunk of L positions, with
// C[i] = sum_{l<i} log2 w_l over the chunk (C[0] = 0; w floored at 1e-30,
// positions past t or past L contribute log w = 0 and k = v = 0):
//   carry  o_i  = (r_i 2^{C[i]}) S
//   intra  o_i += sum_{j<i} A[i][j] v_j + (sum_e r_ie u_e k_ie) v_i,
//          A[i][j] = sum_e r_ie k_je 2^{C[i]_e - C[j+1]_e}
//   state  S    = diag(2^{C[L]}) S + sum_j (k_j 2^{C[L] - C[j+1]})^T v_j
// Every exponent is a sum of log-decays over the positions it spans, so
// <= 0 (each is clamped at 0 against the rounding of the differences):
// no exp overflows at any decay, and nothing is rescaled.
//
// Bound on this card (chip_smoke.py wkv_bound).  At the train shape (b 8,
// t 1024, 64 heads of 64, bf16 r/k/v) the operands are 478 MB (r, k, v
// bf16, w, out and the state f32): 0.143 ms at 3.35 TB/s.  The least
// operations, each unit at its peak, at the chunk length that needs the
// least (2): 4 L n^2 + 2 L^2 n flops of products per chunk, three TF32
// passes at 495 TFLOP/s, 0.053 ms; a log and two exps per (position,
// channel) at the MUFU's 16 a cycle per SM, 0.028 ms; the scan, the
// scalings, the bonus and the state's decay at one float32 instruction
// per lane and cycle, 0.037 ms.  The units run side by side: bound by the
// bytes, 0.143 ms.  The first, CUDA-core form of this kernel (2.63 ms)
// stood at 18.4x it.
//
// What held that kernel back (it had no profiler on this card: read from
// its source, then timed phase by phase here with clock64 and by leaving
// phases out), and what this one does about it:
//   * Its three products ran on the CUDA cores, one or two shared-memory
//     loads per FMA.  Here they run on the tensor cores (mma.sync m16n8k8
//     TF32) in the transposed form O^T = S^T R~^T + V^T A^T and S^T =
//     S^T diag(2^{C[L]}) + V^T K~: each warp owns the S^T rows of 16 value
//     columns m (all n channels e) in its mma accumulators for the whole
//     sequence.  With the channels of each 8-channel k-step taken in the
//     order 0, 2, 4, 6, 1, 3, 5, 7, an accumulator fragment of S^T is the
//     A fragment of the carry product as it stands: S never goes to
//     shared memory, and the decayed S is the state update's accumulator.
//   * TF32 keeps 10 mantissa bits, too few for the 5e-5 tolerance (one
//     pass lands 6-13 tolerances off, tests/test_torch_wkv_design.py), so
//     each float32 operand is split x = hi + lo and a b = a_hi b_hi + a_hi
//     b_lo + a_lo b_hi, accumulated in float32; bf16 V is exact in TF32,
//     so products with V take two passes.  hi is x cut to its 10 leading
//     mantissa bits by a mask and lo the exact rest, which the tensor core
//     cuts to TF32 in turn: two full-rate instructions, where
//     cvt.rna.tf32 runs at the conversion units' quarter rate.
//   * Its intra-chunk matrix idled half of each warp and took one exp per
//     (pair, channel).  Here the chunk is cut into sub-chunks of 8.  For
//     each key sub-chunk J (c = C at its end), all later rows at once are
//     a tensor-core product, 16 rows a task:
//       A[i][j] = sum_e (r_ie 2^{C[i]_e - c_e}) (k_je 2^{c_e - C[j+1]_e}),
//     both exponents <= 0, one exp per operand element.  A diagonal 8 x 8
//     block takes no exp: for fixed i, j = i-1, i-2, ..., the weight
//     2^{C[i] - C[j+1]} is the running product of the floored w_l over
//     j < l < i (each factor in (0, 1]: no overflow, and an underflow only
//     where the exact product is smaller still).  Lanes own the row pair
//     (3 - p, 4 + p) and n / 8 channels: 7 steps on every lane.  The bonus
//     A[i][i] = sum_e r u k is exact.  With sub-chunks of 16 (the first
//     tensor-core form: 15-step chains, the tensor-core block on one
//     warp) A took 0.13 of 0.31 ms at b 2; with a task per 8-column tile
//     and sub-chunks of 8, 0.07 of 0.25 (PERF.md).
//   * Its cumulative log decay was serial (64 threads, 32 positions each).
//     Here 8-lane segments of a warp scan 8 positions of one channel by
//     shuffles, all of a warp's rows and channels side by side, and the
//     rows' totals are added after.
//   * It loaded each chunk synchronously behind 6 barriers.  Here a chunk
//     takes 3 barriers and its loads are cp.async (16 bytes a copy, one
//     array a loop, positions past t or past the chunk zero-filled and
//     read by predicate only): the next chunk's r, k and w are in flight
//     while this chunk's products run, and this chunk's v while its scan
//     and A run.  Each array is staged once, not twice (a double buffer
//     would take 76 KB a block and allow two blocks an SM, not four).
//   * The padded chunk (16, 32 or 64) is a template parameter: with loop
//     bounds known, every tile loop unrolls without the runtime guards
//     the scheduler cannot look past.
//   * No column split.  Columns m of S evolve independently, so a block
//     could own 32 of them (2 warps) and recompute A, which does not
//     depend on m: twice the blocks, the scan and A done twice.  Timed,
//     that grid was slower at both main-path shapes (b 8 and b 2 x 1024,
//     64 heads: 1.9x and 1.5x the whole-row time; PERF.md), as the scan
//     and A, not the products, hold a block; rows stay whole.
//
// Registers and spills (ptxas -v, sm_90a; chip_smoke.py's build line):
// see PERF.md.  The whole-row bf16 kernel at n 64 is held to 128
// registers (__launch_bounds__ with 4 blocks an SM, which its 54 KB of
// shared memory allows) and spills nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 64;
constexpr float kWFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

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
  int async_copy;   // every operand 16-byte aligned: cp.async, else loads
};

// Shared memory of one block, in bytes from the base, for a chunk padded
// to lp positions (a multiple of 16).  Row strides are chosen so that the
// accesses of each phase fall in distinct banks (see the kernel):
//   r, k  staged rows of n elements + 16 bytes
//   w     staged rows of n floats + 16 bytes
//   v     staged rows of n elements + 16 (bf16) or 32 (float) bytes
//   C     lp + 1 rows of n + 4 floats (row 0 is 0)
//   Rt,Kt lp rows of n + 8 floats: r 2^{C[i]}, k 2^{C[L] - C[i+1]}
//   A     lp rows of lp + 4 floats
//   dec, u  n floats each
struct Layout {
  int rs, ws, vs, cs, ts, as;
  size_t r, k, w, v, c, rt, kt, a, dec, u, total;
};

__host__ __device__ inline Layout make_layout(int lp, int n, int elem) {
  Layout l;
  l.rs = n * elem + 16;
  l.ws = n * 4 + 16;
  l.vs = n * elem + (elem == 2 ? 16 : 32);
  l.cs = n + 4;
  l.ts = n + 8;
  l.as = lp + 4;
  l.r = 0;
  l.k = l.r + (size_t)lp * l.rs;
  l.w = l.k + (size_t)lp * l.rs;
  l.v = l.w + (size_t)lp * l.ws;
  l.c = l.v + (size_t)lp * l.vs;
  l.rt = l.c + sizeof(float) * (size_t)(lp + 1) * l.cs;
  l.kt = l.rt + sizeof(float) * (size_t)lp * l.ts;
  l.a = l.kt + sizeof(float) * (size_t)lp * l.ts;
  l.dec = l.a + sizeof(float) * (size_t)lp * l.as;
  l.u = l.dec + sizeof(float) * (size_t)n;
  l.total = l.u + sizeof(float) * (size_t)n;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared.  Asynchronous (cp.async, zero-filled where
// !valid) when the operands are 16-byte aligned; else by 2-byte loads,
// which every element type allows.
__device__ __forceinline__ void copy16(unsigned char* dst, const void* src,
                                       bool valid, bool async_copy) {
  if (async_copy) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    const unsigned short* s = static_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = valid ? s[i] : (unsigned short)0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x by the SFU (relative error about 2^-22; results below 2^-126 flush
// to 0, where every product they scale is below float32's range too)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo, hi x's 10 leading mantissa bits (truncated), lo the exact
// rest; the tensor core reads a TF32 operand's 19 leading bits, so lo
// keeps 10 more: about 21 of float32's 24.  Two full-rate instructions,
// where cvt.rna.tf32 runs at the conversion units' quarter rate.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16x8 float32) += a (16x8 TF32, row) * b (8x8 TF32, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)(*reinterpret_cast<const unsigned short*>(p)) << 16);
}

// CNT consecutive elements (CNT * sizeof(T) a power of two, aligned) as
// float
template <int CNT>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[CNT]) {
  if constexpr (CNT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CNT; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x;
      x[i + 1] = f.y;
      x[i + 2] = f.z;
      x[i + 3] = f.w;
    }
  } else if constexpr (CNT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = *p;
  }
}

template <int CNT>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p,
                                       float (&x)[CNT]) {
  if constexpr (CNT % 8 == 0) {
#pragma unroll
    for (int i = 0; i < CNT; i += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i + 2 * j] = bf16_lo(w[j]);
        x[i + 2 * j + 1] = bf16_hi(w[j]);
      }
    }
  } else if constexpr (CNT == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    x[0] = bf16_lo(q.x);
    x[1] = bf16_hi(q.x);
    x[2] = bf16_lo(q.y);
    x[3] = bf16_hi(q.y);
  } else if constexpr (CNT == 2) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf16_lo(q);
    x[1] = bf16_hi(q);
  } else {
    x[0] = ld1(p);
  }
}

// sum over the 8 lanes that differ in the low three bits
__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  x += __shfl_xor_sync(kFull, x, 4);
  return x;
}

// tensor-core tasks of the intra-chunk matrix at a padded chunk of lp:
// for each key sub-chunk of 8 but the last, its later rows by 16
__host__ __device__ constexpr int off_tasks(int lp) {
  int n = 0;
  for (int j = 0; j + 1 < lp / 8; ++j) n += (lp - 8 * (j + 1) + 15) / 16;
  return n;
}

// one warp per 16 value columns (n 8: one warp, half its rows idle)
__host__ __device__ constexpr int warps_for(int n) {
  return n >= 16 ? n / 16 : 1;
}

// One block per (batch, head) row.
template <typename T, int N, int LP>
__global__ void __launch_bounds__(32 * warps_for(N), N == 64 ? 4 : 1)
    wkv6_tc_kernel(Wkv6Args a) {
  constexpr int W = warps_for(N);
  constexpr int kThreads = 32 * W;
  constexpr int ET = N / 8;            // 8-channel tiles
  constexpr int EC = N / 8;            // channels per lane, diagonal blocks
  constexpr int RP = N * (int)sizeof(T) / 16;   // 16-byte pieces of a row
  constexpr int WP = N / 4;
  constexpr bool kExactV = sizeof(T) == 2;      // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];

  constexpr int lp = LP, npt = LP / 8;
  constexpr int G = N / 4 / W;         // channel groups of 4 per warp
  const int L = a.chunk;
  const Layout lay = make_layout(lp, N, (int)sizeof(T));
  unsigned char* rs = smem + lay.r;
  unsigned char* ks = smem + lay.k;
  unsigned char* ws = smem + lay.w;
  unsigned char* vs = smem + lay.v;
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* Rt = reinterpret_cast<float*>(smem + lay.rt);
  float* Kt = reinterpret_cast<float*>(smem + lay.kt);
  float* A = reinterpret_cast<float*>(smem + lay.a);
  float* dec = reinterpret_cast<float*>(smem + lay.dec);
  float* us = reinterpret_cast<float*>(smem + lay.u);
  auto rrow = [&](int i) {
    return reinterpret_cast<const T*>(rs + (size_t)i * lay.rs);
  };
  auto krow = [&](int i) {
    return reinterpret_cast<const T*>(ks + (size_t)i * lay.rs);
  };
  auto wrow = [&](int i) {
    return reinterpret_cast<const float*>(ws + (size_t)i * lay.ws);
  };
  auto vrow = [&](int i) {
    return reinterpret_cast<const T*>(vs + (size_t)i * lay.vs);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row = blockIdx.x;                   // b * heads + h
  const int h = row % a.heads;
  const int b = row / a.heads;
  const size_t pos_stride = (size_t)a.heads * N;
  const size_t base = ((size_t)b * a.t * a.heads + h) * N;
  const bool async_copy = a.async_copy != 0;
  const char* rg = static_cast<const char*>(a.r);
  const char* kg = static_cast<const char*>(a.k);
  const char* vg = static_cast<const char*>(a.v);
  const char* wg = reinterpret_cast<const char*>(a.w);

  for (int i = tid; i < N; i += kThreads) {
    C[i] = 0.f;
    us[i] = a.u[h * N + i];
  }

  // The intra-chunk tasks, with sub-chunks of 8: for each key sub-chunk
  // J, the rows after it, 16 at a time, on the tensor cores; then each
  // diagonal 8 x 8 block.  The two kinds cost about the same, so the
  // warps take them in turn (a loop over all tasks with constant bounds:
  // one starting at the warp's index spilled at the 128-register cap).
  constexpr int n_off = off_tasks(LP);
  constexpr int n_tasks = n_off + LP / 8;

  // a chunk's rows of one array, `pieces` 16-byte pieces a row; rows past
  // the chunk or past t zero-filled; one array a loop, so a warp's copies
  // go to one array
  auto stage = [&](unsigned char* dst, int stride, const char* src,
                   int elem, int pieces, int c) {
    const int t0 = c * L;
    const int valid = min(L, a.t - t0);
    for (int i = tid; i < lp * pieces; i += kThreads) {
      const int p = i / pieces, piece = i - p * pieces;
      const bool ok = p < valid;
      const size_t off = base + (size_t)(t0 + (ok ? p : 0)) * pos_stride;
      copy16(dst + (size_t)p * stride + piece * 16,
             src + off * elem + piece * 16, ok, async_copy);
    }
  };
  auto stage_rkw = [&](int c) {
    stage(rs, lay.rs, rg, (int)sizeof(T), RP, c);
    stage(ks, lay.rs, kg, (int)sizeof(T), RP, c);
    stage(ws, lay.ws, wg, (int)sizeof(float), WP, c);
  };
  auto stage_v = [&](int c) { stage(vs, lay.vs, vg, (int)sizeof(T), RP, c); };

  // S^T rows m0 + g (+8), channels 8 et + 2 t4 (+1): the accumulators
  float sacc[ET][4];
#pragma unroll
  for (int et = 0; et < ET; ++et)
#pragma unroll
    for (int i = 0; i < 4; ++i) sacc[et][i] = 0.f;
  const int m0 = warp * 16;

  const int n_chunks = (a.t + L - 1) / L;
  if (n_chunks > 0) {
    stage_rkw(0);
    stage_v(0);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int valid = min(L, a.t - t0);
    cp_async_wait_all();
    __syncthreads();   // chunk c's r, k, w in place; chunk c-1 all done
    if (c > 0) stage_v(c);
    cp_async_commit();

    // 1. cumulative log2 decay, r 2^{C[i]}, k 2^{C[L] - C[i+1]}, decay;
    // a warp's G channel groups side by side, positions 8 m + pl: each
    // row of 8 scanned by shuffles, the rows' totals added after
    {
      const int pl = lane & 7, ec = lane >> 3;
      float xr[G][npt], carry[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int e = (warp + gi * W) * 4 + ec;
#pragma unroll
        for (int m = 0; m < npt; ++m) {
          const int p = m * 8 + pl;
          float* wp = reinterpret_cast<float*>(ws + (size_t)p * lay.ws) + e;
          const float wf = fmaxf(*wp, kWFloor);
          *wp = wf;   // the diagonal blocks' running products take it so
          xr[gi][m] = p < valid ? log2f(wf) : 0.f;
        }
      }
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int m = 0; m < npt; ++m) {
            const float y = __shfl_up_sync(kFull, xr[gi][m], d, 8);
            if (pl >= d) xr[gi][m] += y;
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int e = (warp + gi * W) * 4 + ec;
        float run = 0.f;
#pragma unroll
        for (int m = 0; m < npt; ++m) {
          const float tot = __shfl_sync(kFull, xr[gi][m], 7, 8);
          C[(m * 8 + pl + 1) * lay.cs + e] = run + xr[gi][m];
          run += tot;
        }
        carry[gi] = run;
      }
      __syncwarp();
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int e = (warp + gi * W) * 4 + ec;
        if (pl == 0) dec[e] = ex2(carry[gi]);
        float rv[npt], kv[npt], c0[npt], c1[npt];
#pragma unroll
        for (int m = 0; m < npt; ++m) {
          const int p = m * 8 + pl;
          rv[m] = ld1(rrow(p) + e);
          kv[m] = ld1(krow(p) + e);
          c0[m] = C[p * lay.cs + e];
          c1[m] = C[(p + 1) * lay.cs + e];
        }
#pragma unroll
        for (int m = 0; m < npt; ++m) {
          const int p = m * 8 + pl;
          Rt[p * lay.ts + e] = rv[m] * ex2(c0[m]);
          Kt[p * lay.ts + e] = kv[m] * ex2(fminf(carry[gi] - c1[m], 0.f));
        }
      }
      for (int i = tid; i < lp * lay.as; i += kThreads) A[i] = 0.f;
    }
    __syncthreads();

    // 2. the intra-chunk matrix A (lower triangle with the diagonal)
    for (int task = 0; task < n_tasks; ++task) {
      if (task % W != warp) continue;
      if (task < n_off) {
        // key sub-chunk J (columns 8 J .. 8 J + 7), rows 8 (J + 1) + 16 mt
        // .. + 15 (those below lp), on the tensor cores
        int J = 0, mt = task;
        while (mt >= (lp - 8 * (J + 1) + 15) / 16) {
          mt -= (lp - 8 * (J + 1) + 15) / 16;
          ++J;
        }
        const int cj = 8 * J + 8;
        const int i0 = 8 * (J + 1) + 16 * mt + g, i1 = i0 + 8, j = 8 * J + g;
        const bool ok1 = i1 < lp;
        float acc[4] = {};
#pragma unroll
        for (int ks_ = 0; ks_ < ET; ++ks_) {
          const int e0 = ks_ * 8 + t4, e1 = e0 + 4;
          const float c0 = C[cj * lay.cs + e0], c1 = C[cj * lay.cs + e1];
          float av[4];
          av[0] = ld1(rrow(i0) + e0) *
                  ex2(fminf(C[i0 * lay.cs + e0] - c0, 0.f));
          av[2] = ld1(rrow(i0) + e1) *
                  ex2(fminf(C[i0 * lay.cs + e1] - c1, 0.f));
          av[1] = ok1 ? ld1(rrow(i1) + e0) *
                            ex2(fminf(C[i1 * lay.cs + e0] - c0, 0.f))
                      : 0.f;
          av[3] = ok1 ? ld1(rrow(i1) + e1) *
                            ex2(fminf(C[i1 * lay.cs + e1] - c1, 0.f))
                      : 0.f;
          const float b0 = ld1(krow(j) + e0) *
                           ex2(fminf(c0 - C[(j + 1) * lay.cs + e0], 0.f));
          const float b1 = ld1(krow(j) + e1) *
                           ex2(fminf(c1 - C[(j + 1) * lay.cs + e1], 0.f));
          uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
          for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
          split(b0, bh0, bl0);
          split(b1, bh1, bl1);
          mma3(acc, ah, al, bh0, bh1, bl0, bl1);
        }
        float* lo = A + i0 * lay.as + 8 * J + 2 * t4;
        lo[0] = acc[0];
        lo[1] = acc[1];
        if (ok1) {
          lo[8 * lay.as] = acc[2];
          lo[8 * lay.as + 1] = acc[3];
        }
      } else {
        // diagonal 8 x 8 block I by running products: lanes own the row
        // pair (3 - p, 4 + p) and EC channels; 7 steps on every lane
        const int I = task - n_off;
        const int p = lane >> 3, q = lane & 7;
        const int ra = 3 - p, rb = 4 + p;
        const int P0 = 8 * I;
        const int e0 = q * EC;
        float xb[EC], xa[EC], uu[EC], kk[EC];
        ld_vec<EC>(rrow(P0 + rb) + e0, xb);
        ld_vec<EC>(rrow(P0 + ra) + e0, xa);
        ld_vec<EC>(us + e0, uu);
        float sb = 0.f, sa = 0.f;
        ld_vec<EC>(krow(P0 + rb) + e0, kk);
#pragma unroll
        for (int i = 0; i < EC; ++i) sb += xb[i] * uu[i] * kk[i];
        ld_vec<EC>(krow(P0 + ra) + e0, kk);
#pragma unroll
        for (int i = 0; i < EC; ++i) sa += xa[i] * uu[i] * kk[i];
        sb = sum8(sb);
        sa = sum8(sa);
        if (q == 0) {
          A[(P0 + rb) * lay.as + P0 + rb] = sb;
          A[(P0 + ra) * lay.as + P0 + ra] = sa;
        }
        // row rb for j = rb - 1 .. 0, then row ra for j = ra - 1 .. 0;
        // x = r_i prod_{j<l<i} w_l
#pragma unroll
        for (int s = 0; s < 7; ++s) {
          const bool on_b = s < 4 + p;
          const int i = on_b ? rb : ra;
          const int j = on_b ? 3 + p - s : 6 - s;
          const bool to_a = s == 4 + p;
#pragma unroll
          for (int c2 = 0; c2 < EC; ++c2) xb[c2] = to_a ? xa[c2] : xb[c2];
          ld_vec<EC>(krow(P0 + j) + e0, kk);
          float part[2] = {0.f, 0.f};
#pragma unroll
          for (int c2 = 0; c2 < EC; ++c2) part[c2 & 1] += xb[c2] * kk[c2];
          const float sum = sum8(part[0] + part[1]);
          if (q == 0) A[(P0 + i) * lay.as + P0 + j] = sum;
          float ww[EC];
          ld_vec<EC>(wrow(P0 + j) + e0, ww);   // floored in step 1
#pragma unroll
          for (int c2 = 0; c2 < EC; ++c2) xb[c2] *= ww[c2];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // A, Rt, Kt, dec and chunk c's v in place
    if (c + 1 < n_chunks) stage_rkw(c + 1);
    cp_async_commit();

    // 3. per warp: O^T = S^T R~^T + V^T A^T, then S^T = S^T diag(dec) +
    // V^T K~, for value columns m0 .. m0 + 15
    {
      float oacc[npt][4];
#pragma unroll
      for (int pt = 0; pt < npt; ++pt)
#pragma unroll
        for (int i = 0; i < 4; ++i) oacc[pt][i] = 0.f;
      // carry: k-step over channels 8 et + (0, 2, 4, 6, 1, 3, 5, 7); the
      // three passes issued tile by tile, so consecutive mma are
      // independent
#pragma unroll
      for (int et = 0; et < ET; ++et) {
        uint32_t ah[4], al[4];
        split(sacc[et][0], ah[0], al[0]);
        split(sacc[et][2], ah[1], al[1]);
        split(sacc[et][1], ah[2], al[2]);
        split(sacc[et][3], ah[3], al[3]);
        uint32_t bh[npt][2], bl[npt][2];
#pragma unroll
        for (int pt = 0; pt < npt; ++pt) {
          const float2 bb = *reinterpret_cast<const float2*>(
              Rt + (8 * pt + g) * lay.ts + 8 * et + 2 * t4);
          split(bb.x, bh[pt][0], bl[pt][0]);
          split(bb.y, bh[pt][1], bl[pt][1]);
        }
#pragma unroll
        for (int pt = 0; pt < npt; ++pt)
          mma(oacc[pt], al, bh[pt][0], bh[pt][1]);
#pragma unroll
        for (int pt = 0; pt < npt; ++pt)
          mma(oacc[pt], ah, bl[pt][0], bl[pt][1]);
#pragma unroll
        for (int pt = 0; pt < npt; ++pt)
          mma(oacc[pt], ah, bh[pt][0], bh[pt][1]);
      }
#pragma unroll
      for (int et = 0; et < ET; ++et) {
        const float d0 = dec[8 * et + 2 * t4], d1 = dec[8 * et + 2 * t4 + 1];
        sacc[et][0] *= d0;
        sacc[et][2] *= d0;
        sacc[et][1] *= d1;
        sacc[et][3] *= d1;
      }
      // intra and state, one 8-position k-step s0 .. s0 + 7 at a time
#pragma unroll
      for (int st = 0; st < npt; ++st) {
        const int s0 = 8 * st + t4;
        const bool hi_ok = N >= 16 || m0 + g + 8 < N;
        float vf[4];
        vf[0] = ld1(vrow(s0) + m0 + g);
        vf[1] = hi_ok ? ld1(vrow(s0) + m0 + g + 8) : 0.f;
        vf[2] = ld1(vrow(s0 + 4) + m0 + g);
        vf[3] = hi_ok ? ld1(vrow(s0 + 4) + m0 + g + 8) : 0.f;
        uint32_t vh[4], vl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kExactV) {
            vh[i] = __float_as_uint(vf[i]);
          } else {
            split(vf[i], vh[i], vl[i]);
          }
        }
        // intra: positions 8 pt .. 8 pt + 7 take keys up to them
#pragma unroll
        for (int pt = st; pt < npt; ++pt) {
          const float* ar = A + (8 * pt + g) * lay.as + 8 * st + t4;
          uint32_t bh0, bl0, bh1, bl1;
          split(ar[0], bh0, bl0);
          split(ar[4], bh1, bl1);
          if constexpr (kExactV) {
            mma(oacc[pt], vh, bl0, bl1);
            mma(oacc[pt], vh, bh0, bh1);
          } else {
            mma3(oacc[pt], vh, vl, bh0, bh1, bl0, bl1);
          }
        }
        // state: S^T += V^T K~
#pragma unroll
        for (int et = 0; et < ET; ++et) {
          const float* kr = Kt + s0 * lay.ts + 8 * et + g;
          uint32_t bh0, bl0, bh1, bl1;
          split(kr[0], bh0, bl0);
          split(kr[4 * lay.ts], bh1, bl1);
          if constexpr (kExactV) {
            mma(sacc[et], vh, bl0, bl1);
            mma(sacc[et], vh, bh0, bh1);
          } else {
            mma3(sacc[et], vh, vl, bh0, bh1, bl0, bl1);
          }
        }
      }
      // outputs: O^T rows m0 + g (+8), positions 8 pt + 2 t4 (+1)
      float* og = a.out + base + (size_t)t0 * pos_stride + m0 + g;
#pragma unroll
      for (int pt = 0; pt < npt; ++pt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pi = 8 * pt + 2 * t4 + (i & 1);
          const int mi = (i >> 1) * 8;
          if (pi < valid && (N >= 16 || m0 + g + mi < N))
            og[(size_t)pi * pos_stride + mi] = oacc[pt][i];
        }
      }
    }
  }

  // the final state: S[e][m] = S^T[m][e]
  float* st = a.state + (size_t)row * N * N + m0 + g;
#pragma unroll
  for (int et = 0; et < ET; ++et) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * et + 2 * t4 + (i & 1);
      const int mi = (i >> 1) * 8;
      if (N >= 16 || m0 + g + mi < N) st[(size_t)e * N + mi] = sacc[et][i];
    }
  }
}

template <typename T, int N, int LP>
cudaError_t launch(const Wkv6Args& a, cudaStream_t stream) {
  const size_t smem = make_layout(LP, N, (int)sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_tc_kernel<T, N, LP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wkv6_tc_kernel<T, N, LP>
      <<<a.batch * a.heads, 32 * warps_for(N), smem, stream>>>(a);
  return cudaGetLastError();
}

// the chunk padded to 16, 32 or 64 positions
template <typename T, int N>
cudaError_t launch_lp(const Wkv6Args& a, cudaStream_t stream) {
  if (a.chunk <= 16) return launch<T, N, 16>(a, stream);
  if (a.chunk <= 32) return launch<T, N, 32>(a, stream);
  return launch<T, N, 64>(a, stream);
}

template <typename T>
cudaError_t dispatch(int n, const Wkv6Args& a, cudaStream_t stream) {
  switch (n) {
    case 8: return launch_lp<T, 8>(a, stream);
    case 16: return launch_lp<T, 16>(a, stream);
    case 32: return launch_lp<T, 32>(a, stream);
    case 64: return launch_lp<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launch the WKV scan on `stream`; returns the launch's cudaError_t (0 on
// success).  dtype: 0 float, 1 bfloat16 (r, k, v); head_dim in {8, 16,
// 32, 64}; 1 <= chunk <= 64.
extern "C" int wkv6_chunked_fwd(int dtype, const void* r, const void* k,
                                const void* v, const float* w,
                                const float* u, float* out, float* state,
                                int batch, int t, int heads, int head_dim,
                                int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || batch < 0 || t < 0 || heads < 0)
    return (int)cudaErrorInvalidValue;
  const int async_copy = aligned16(r) && aligned16(k) && aligned16(v) &&
                         aligned16(w);
  const Wkv6Args a{r, k, v, w, u, out, state, batch, t, heads, chunk,
                   async_copy};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(head_dim, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(head_dim, a, s);
  return (int)cudaErrorInvalidValue;
}
