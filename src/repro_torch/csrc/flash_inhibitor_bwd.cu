// The flash inhibitor's backward for Hopper (sm_90a): dq, dk and dv of the
// inhibitor attention (paper eq. 5-7) whose forward is flash_prefill.cu's
// register-tiled kernel, over contiguous (batch, n, heads, head_dim)
// operands.
//
// It replaces no TPU kernel: the JAX package's training op recomputes
// through the reference's analytic VJP (src/repro/kernels/ops.py, _fi_bwd),
// which the port ran eagerly in float32 cubes of 128-key chunks
// (core/inhibitor.py::_inhibitor_core_bwd).  That VJP stays as this
// kernel's plain version.
//
// Layouts (row-major, contiguous):
//   q, g, dq  (batch, n_q, heads, head_dim)      T
//   k, v, dk, dv (batch, n_k, kv_heads, head_dim)  T
// T is float or __nv_bfloat16; all sums are float32.  Query i sits at
// position q_off + i of the keys' sequence, and every key is valid (the
// training entries, a `model` rank's query rows under sequence
// parallelism included).
//
// What it computes: the analytic VJP of core/inhibitor.py, per query head,
// query i and key j, with gamma the score scale and alpha the shift,
//   raw_ij = sum_d |q_id - k_jd| / gamma,  Z_ij = relu(raw_ij - alpha)
//            (raw_ij when alpha = 0), +inf where (i, j) is masked
//   ind_ijk = 1[|v_jk| > Z_ij] signed,  1[v_jk > Z_ij] unsigned
//   g^_ik = g_ik / max(count_i, 1) when normalizing, else g_ik
//   dv_jk = sum_i g^_ik ind_ijk
//   t_ij = -(sum_k g^_ik sigma_jk ind_ijk) 1[raw_ij > alpha] / gamma,
//          sigma = v > 0 ? 1 : -1 signed, 1 unsigned
//   dq_id = sum_j t_ij sign(q_id - k_jd),  dk_jd = sum_i t_ij sign(k_jd -
//           q_id),  with sign(0) = 0 (in bf16 q and k often tie)
// and dk, dv summed over the group's query heads.  Masks come from the
// closed-form key range of each query (causal, window, q_off), as in the
// forward; no mask is built.  The gate 1[raw > alpha] is Z > 0, since Z =
// relu(raw - alpha) and x - y > 0 exactly when x > y.  raw is rounded
// before the shift is taken, as the reference rounds it.  A masked pair's Z
// = +inf fails every indicator, so its t is 0 and it adds an exact 0 to
// every sum.
//
// Bound on this card.  Like the forward, only adds, compares and min / max
// (one instruction per lane and cycle: 132 SMs x 128 lanes x 1.98 GHz =
// 33.5e12 a second); nothing is a product the tensor cores could take.
// Per (query head, attended key, d) the least is 9: 2 for the score (t = q
// - k, s += |t|), 3 for the dv indicator and the per-pair sum (a compare,
// a predicated add into dv, a predicated fma into the pair's sum), 4 for
// sign(q - k) into dq and dk (two compares, two predicated adds of +-t
// into each, shared by dq and dk when both sit in one thread).  Two
// passes that recompute the score and the pair's sum each (below) need
// 2 + 3 + 4 (pass A) + 2 + 2 + 4 (pass B) = 17.  At the training shape
// (b 8, n 1024 causal, 9 / 3 heads, d 64: 2.42e9 elements) the bound of
// 9 is 0.65 ms, the two passes' 17 1.23 ms; the operands are 38 MB (11 us
// at 3.35 TB/s): bound by operations.
//
// Design.
//   1. Two passes, no atomics, so two calls give the same bits.  Pass A
//      (flash_inhibitor_bwd_dkdv_kernel) takes one block per (row, kv
//      head, tile of 64 keys) and walks the group's query heads in order,
//      each over the 64-query tiles that attend its keys (their first and
//      last in closed form); it holds dk and dv in registers and writes
//      them once.  Pass B (flash_inhibitor_bwd_dq_kernel) takes one block
//      per (row, query head, tile of 64 queries), heaviest causal tile
//      first, walks its key tiles as the forward does, and writes dq once.
//      One template serves both: the block's own tile is "fixed" (K and V
//      in pass A, Q and g in pass B, staged once as float32), the other
//      "streamed" (Q and g, or K and V, tile by tile).
//   2. Per streamed tile, phase 1 computes the 64 x 64 pairs on a register
//      micro-tile of 4 fixed x 4 streamed rows a thread (the streamed rows
//      s + 16 n, so a quarter warp reads 8 distinct rows): the score, Z and
//      the mask, then the pair's sum over d (a compare and a predicated
//      fma an element), then t; Z (pass A) and t go to shared memory.
//   3. Phase 2 gives each thread head_dim / 16 fixed rows x 4 columns, its
//      fixed values and its sums in registers, and walks the tile's
//      streamed rows: +-t into dq or dk (two compares, two predicated
//      adds), and in pass A g^ into dv where |v| > Z (a compare, a
//      predicated add).  Streamed rows that attend none of the block's
//      rows are not visited.
//   4. Streamed tiles are double-buffered in shared memory by cp.async, 16
//      bytes a thread, kept in the operand type (rows padded by 16 bytes)
//      and converted at the load; rows past n_q or n_k enter as zeros and
//      add exact zeros.  Where two stages do not fit (float32 at head_dim
//      128 in pass A) one stage is staged and waited for each tile.
//   5. Masks only on a tile that some pair of it does not attend; on the
//      others no predicate is evaluated.
// Pass A's blocks carry uneven work under a causal mask (the first key
// tile is attended by every query); they launch first-tile first, so the
// heaviest start earliest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of a fixed or streamed tile
constexpr int kMF = 4;                  // phase 1 micro-tile: fixed rows
constexpr int kMS = 4;                  // ... x streamed rows
constexpr int kPStride = kTile + 4;     // floats per row of Z and t
constexpr size_t kMaxSmem = 227 * 1024;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  int batch;
  int n_q;
  int n_k;
  int heads;
  int kv_heads;
  float inv_scale;   // 1 / gamma
  float shift;
  int normalize;
  int causal;
  int window;        // < 0: no sliding window
  int q_off;
};

// Query i's attended keys [lo, hi): the mask predicate in closed form (a
// window implies causality).  Queries past n_q get an empty range.
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange key_range(const BwdArgs& a, int qi) {
  KeyRange kr{0, 0};
  if (qi >= a.n_q) return kr;
  const int pos = a.q_off + qi;
  kr.hi = a.n_k;
  if (a.causal || a.window >= 0) kr.hi = min(kr.hi, pos + 1);
  if (a.window >= 0) kr.lo = max(0, pos - a.window + 1);
  return kr;
}

// 1 / max(count_i, 1) when normalizing, else 1
__device__ __forceinline__ float inv_count(const BwdArgs& a, int qi) {
  if (!a.normalize) return 1.0f;
  const KeyRange r = key_range(a, qi);
  return 1.0f / fmaxf((float)(r.hi - r.lo), 1.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the
// destination is zero-filled (source size 0)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 consecutive elements (8 or 16 bytes, shared or global) as float32
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

// 4 float32 values to 4 consecutive elements of global memory
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// R consecutive floats of shared memory (R = 1, 2, 4 or 8)
template <int R>
__device__ __forceinline__ void ld_row(const float* p, float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int m = 0; m < R; m += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + m);
      x[m] = u.x;
      x[m + 1] = u.y;
      x[m + 2] = u.z;
      x[m + 3] = u.w;
    }
  } else if constexpr (R == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x;
    x[1] = u.y;
  } else {
    x[0] = p[0];
  }
}

// Shared memory of one block, in bytes:
//   fixed A, B float [64][D + 4] | streamed A, B T [stages][64][D + E]
//   | t float [64][68] | (pass A) Z float [64][68] | (pass A) 1/count [64]
// E = 16 / sizeof(T).  The Z and t tiles are indexed [streamed][fixed].
template <typename T, int D, bool KEYS_FIXED>
struct BwdSmem {
  static constexpr int kE = 16 / (int)sizeof(T);
  static constexpr int kFStride = D + 4;        // floats
  static constexpr int kSStride = D + kE;       // T
  static constexpr size_t kFixed = sizeof(float) * kTile * kFStride;
  static constexpr size_t kStream = sizeof(T) * kTile * kSStride;
  static constexpr size_t kPair = sizeof(float) * kTile * kPStride;
  static constexpr size_t kBase = 2 * kFixed + (KEYS_FIXED ? 2 : 1) * kPair +
                                  (KEYS_FIXED ? sizeof(float) * kTile : 0);
  static constexpr int kStages = kBase + 4 * kStream <= kMaxSmem ? 2 : 1;
  static constexpr size_t kBytes = kBase + 2 * kStages * kStream;
};

// One block of either pass.  KEYS_FIXED: pass A (fixed = 64 keys of one kv
// head; streamed = 64-query tiles of its group's heads; out dk, dv).  Else
// pass B (fixed = 64 queries of one head; streamed = 64-key tiles of its
// kv head; out dq).
template <typename T, int D, bool SIGNED, bool KEYS_FIXED>
__device__ __forceinline__ void bwd_block(const BwdArgs& a) {
  using S = BwdSmem<T, D, KEYS_FIXED>;
  constexpr int kE = S::kE;
  constexpr int kChunks = D / kE;             // 16-byte chunks per row
  constexpr int kCols = D / 4;                // phase 2: column groups
  constexpr int kR = kTile * kCols / kThreads;   // ... fixed rows a thread
  static_assert(kR >= 1 && kTile * kCols == kR * kThreads, "phase 2 tile");
  static_assert(kTile == 16 * kMS && kTile * kTile == kThreads * kMF * kMS,
                "phase 1 micro-tile");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* fa = reinterpret_cast<float*>(bwd_smem);
  float* fb = fa + kTile * S::kFStride;
  T* sa = reinterpret_cast<T*>(bwd_smem + 2 * S::kFixed);
  T* sb = sa + (size_t)S::kStages * kTile * S::kSStride;
  float* ts = reinterpret_cast<float*>(bwd_smem + 2 * S::kFixed +
                                       2 * S::kStages * S::kStream);
  float* zs = ts + kTile * kPStride;          // pass A only
  float* ic = zs + kTile * kPStride;          // pass A only

  const int tid = threadIdx.x;
  const int group = a.heads / a.kv_heads;
  const int fheads = KEYS_FIXED ? a.kv_heads : a.heads;
  const int row = blockIdx.x / fheads;
  const int fhead = blockIdx.x - row * fheads;
  const int f0 = KEYS_FIXED ? blockIdx.y * kTile
                            : (gridDim.y - 1 - blockIdx.y) * kTile;
  const int n_f = KEYS_FIXED ? a.n_k : a.n_q;   // rows of the fixed side
  const int n_s = KEYS_FIXED ? a.n_q : a.n_k;   // ... of the streamed side
  const T* ga = static_cast<const T*>(KEYS_FIXED ? a.k : a.q);
  const T* gb = static_cast<const T*>(KEYS_FIXED ? a.v : a.g);
  const T* gsa = static_cast<const T*>(KEYS_FIXED ? a.q : a.k);
  const T* gsb = static_cast<const T*>(KEYS_FIXED ? a.g : a.v);
  // element offset of a fixed row, and of a streamed row of head sh (pass
  // A: a query head of the group; pass B: the kv head)
  auto fixed_at = [&](int r) -> size_t {
    return (((size_t)row * n_f + r) * fheads + fhead) * D;
  };
  auto stream_at = [&](int r, int sh) -> size_t {
    return (((size_t)row * n_s + r) *
                 (KEYS_FIXED ? a.heads : a.kv_heads) + sh) * D;
  };

  // the streamed tiles: pass A the query tiles attending keys [f0, k1) of
  // each query head of the group, in order; pass B the key tiles of its
  // queries' union [first.lo, last.hi)
  int s_first, s_end, n_st;   // streamed rows [s_first, s_end), its tiles
  KeyRange first{0, 0}, last{0, 0};
  if constexpr (KEYS_FIXED) {
    const int k1 = min(f0 + kTile, a.n_k);
    s_first = 0;
    s_end = a.n_q;
    if (a.causal || a.window >= 0) s_first = max(0, f0 - a.q_off);
    if (a.window >= 0) {   // lo_i < k1: q_off + i - window + 1 < k1
      const long long end = (long long)k1 + a.window - 1 - a.q_off;
      s_end = end < 0 ? 0 : (end < a.n_q ? (int)end : a.n_q);
    }
  } else {
    first = key_range(a, f0);
    last = key_range(a, min(a.n_q, f0 + kTile) - 1);
    s_first = first.lo;
    s_end = last.hi;
  }
  const int t_first = s_first / kTile;
  n_st = s_end > s_first ? (s_end - 1) / kTile - t_first + 1 : 0;
  const int n_iter = KEYS_FIXED ? group * n_st : n_st;
  auto tile_of = [&](int it, int& s0, int& sh) {
    const int gi = KEYS_FIXED ? it / n_st : 0;
    s0 = (t_first + it - gi * n_st) * kTile;
    sh = KEYS_FIXED ? fhead * group + gi : fhead / group;
  };
  auto stage = [&](int buf, int it) {
    int s0, sh;
    tile_of(it, s0, sh);
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const bool ok = s0 + r < n_s;
      const size_t src = ok ? stream_at(s0 + r, sh) + ch * kE : 0;
      const int dst = (buf * kTile + r) * S::kSStride + ch * kE;
      cp_async_16(smem_addr(sa + dst), gsa + src, ok);
      cp_async_16(smem_addr(sb + dst), gsb + src, ok);
    }
  };
  if (S::kStages == 2 && n_iter > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  // the fixed tile as float32, once; rows past n_f are zeros
  for (int i = tid; i < kTile * kCols; i += kThreads) {
    const int r = i / kCols, c4 = i - r * kCols;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (f0 + r < n_f) {
      ld4(ga + fixed_at(f0 + r) + c4 * 4, x);
      ld4(gb + fixed_at(f0 + r) + c4 * 4, y);
    }
    *reinterpret_cast<float4*>(fa + r * S::kFStride + c4 * 4) =
        make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(fb + r * S::kFStride + c4 * 4) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
  __syncthreads();

  // phase 2 ownership: fixed rows p_r * kR + m, columns p_c * 4 + e; the
  // fixed values (k or q; pass A also |v| or v) and the sums in registers
  const int p_r = tid / kCols, p_c = tid - (tid / kCols) * kCols;
  float xa[kR][4], xb[kR][4], acc[kR][4], accb[kR][4];
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    ld4(fa + (p_r * kR + m) * S::kFStride + p_c * 4, xa[m]);
    ld4(fb + (p_r * kR + m) * S::kFStride + p_c * 4, xb[m]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (SIGNED) xb[m][e] = fabsf(xb[m][e]);
      acc[m][e] = 0.0f;
      accb[m][e] = 0.0f;
    }
  }
  // phase 1 ownership: fixed rows q_f * kMF + m, streamed rows q_s + 16 n
  const int q_f = tid >> 4, q_s = tid & 15;
  float icf[kMF];   // pass B: 1 / count of the thread's fixed queries
#pragma unroll
  for (int m = 0; m < kMF; ++m) icf[m] = inv_count(a, f0 + q_f * kMF + m);
  const float neg_inv = -a.inv_scale;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = S::kStages == 2 ? (it & 1) : 0;
    if constexpr (S::kStages == 1) {
      __syncthreads();   // every thread is done with the previous tile
      stage(0, it);
      cp_async_commit();
    }
    cp_async_wait_all();   // tile it has landed; visible after:
    __syncthreads();       // every thread is also done with tile it - 1
    if (S::kStages == 2 && it + 1 < n_iter) {
      stage((it + 1) & 1, it + 1);
      cp_async_commit();
    }
    int s0, sh;
    tile_of(it, s0, sh);
    const T* at = sa + (size_t)buf * kTile * S::kSStride;
    const T* bt = sb + (size_t)buf * kTile * S::kSStride;
    // every pair attended: the tile's first query attends past its last
    // key and its last query from its first key (lo, hi rise with i)
    const int qa = KEYS_FIXED ? s0 : f0;
    const int qb = min(a.n_q, qa + kTile) - 1;
    const int kk0 = KEYS_FIXED ? f0 : s0;
    const bool interior = kk0 + kTile <= a.n_k &&
                          kk0 >= key_range(a, qb).lo &&
                          kk0 + kTile <= key_range(a, qa).hi;

    // 1. Z for 4 x 4 pairs: sum_d |fixed - streamed| / gamma, shifted
    float z[kMF][kMS];
#pragma unroll
    for (int m = 0; m < kMF; ++m)
#pragma unroll
      for (int n = 0; n < kMS; ++n) z[m][n] = 0.0f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float sv[kMS][4];
#pragma unroll
      for (int n = 0; n < kMS; ++n)
        ld4(at + (q_s + 16 * n) * S::kSStride + d0, sv[n]);
#pragma unroll
      for (int m = 0; m < kMF; ++m) {
        const float4 fv = *reinterpret_cast<const float4*>(
            fa + (q_f * kMF + m) * S::kFStride + d0);
#pragma unroll
        for (int n = 0; n < kMS; ++n) {
          z[m][n] += fabsf(fv.x - sv[n][0]);
          z[m][n] += fabsf(fv.y - sv[n][1]);
          z[m][n] += fabsf(fv.z - sv[n][2]);
          z[m][n] += fabsf(fv.w - sv[n][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMF; ++m)
#pragma unroll
      for (int n = 0; n < kMS; ++n) {
        // the product rounded on its own, as the reference rounds raw
        // before the shift (an fma would move Z across an indicator's tie)
        float zz = __fmul_rn(z[m][n], a.inv_scale);
        if (a.shift != 0.0f) zz = fmaxf(zz - a.shift, 0.0f);
        if (!interior) {
          const int fr = f0 + q_f * kMF + m, sr = s0 + q_s + 16 * n;
          const int qi = KEYS_FIXED ? sr : fr, kj = KEYS_FIXED ? fr : sr;
          const KeyRange r = key_range(a, qi);
          if (kj < r.lo || kj >= r.hi) zz = INFINITY;
        }
        z[m][n] = zz;
      }
    // 2. the pair's sum over d of sigma g [|v| > Z]: a compare and a
    //    predicated fma an element (v fixed in pass A, streamed in B)
    float s[kMF][kMS];
#pragma unroll
    for (int m = 0; m < kMF; ++m)
#pragma unroll
      for (int n = 0; n < kMS; ++n) s[m][n] = 0.0f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float sv[kMS][4];
#pragma unroll
      for (int n = 0; n < kMS; ++n)
        ld4(bt + (q_s + 16 * n) * S::kSStride + d0, sv[n]);
      float sg[kMS][4];   // pass B: sigma of the streamed v, then |v|
      if constexpr (!KEYS_FIXED) {
#pragma unroll
        for (int n = 0; n < kMS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sg[n][e] = SIGNED ? copysignf(1.0f, sv[n][e]) : 1.0f;
            if (SIGNED) sv[n][e] = fabsf(sv[n][e]);
          }
      }
#pragma unroll
      for (int m = 0; m < kMF; ++m) {
        float fv[4];
        ld4(fb + (q_f * kMF + m) * S::kFStride + d0, fv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (KEYS_FIXED) {   // v fixed, g streamed
            const float av = SIGNED ? fabsf(fv[e]) : fv[e];
            const float sgn = SIGNED ? copysignf(1.0f, fv[e]) : 1.0f;
#pragma unroll
            for (int n = 0; n < kMS; ++n)
              if (av > z[m][n]) s[m][n] = fmaf(sgn, sv[n][e], s[m][n]);
          } else {                      // g fixed, v streamed
#pragma unroll
            for (int n = 0; n < kMS; ++n)
              if (sv[n][e] > z[m][n])
                s[m][n] = fmaf(sg[n][e], fv[e], s[m][n]);
          }
        }
      }
    }
    // t = -s / count 1[raw > alpha] / gamma, to shared memory with Z
#pragma unroll
    for (int n = 0; n < kMS; ++n) {
      const int sr = s0 + q_s + 16 * n;
      const float ics = KEYS_FIXED ? inv_count(a, sr) : 1.0f;
      float t[kMF];
#pragma unroll
      for (int m = 0; m < kMF; ++m) {
        t[m] = s[m][n] * neg_inv * (KEYS_FIXED ? ics : icf[m]);
        if (a.shift != 0.0f && !(z[m][n] > 0.0f)) t[m] = 0.0f;
      }
      const int at_ = (q_s + 16 * n) * kPStride + q_f * kMF;
      *reinterpret_cast<float4*>(ts + at_) =
          make_float4(t[0], t[1], t[2], t[3]);
      if constexpr (KEYS_FIXED) {
        *reinterpret_cast<float4*>(zs + at_) =
            make_float4(z[0][n], z[1][n], z[2][n], z[3][n]);
        if (q_f == 0) ic[q_s + 16 * n] = ics;
      }
    }
    __syncthreads();

    // 3. phase 2 over the streamed rows that attend the fixed tile:
    //    +-t into dq or dk, and (pass A) g / count into dv where |v| > Z
    const int j_lo = max(0, s_first - s0);
    const int j_hi = min(min(kTile, n_s - s0), s_end - s0);
#pragma unroll 2
    for (int j = j_lo; j < j_hi; ++j) {
      float tj[kR], y[4];
      ld_row<kR>(ts + j * kPStride + p_r * kR, tj);
      ld4(at + j * S::kSStride + p_c * 4, y);
#pragma unroll
      for (int m = 0; m < kR; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (xa[m][e] > y[e]) acc[m][e] += tj[m];
          if (xa[m][e] < y[e]) acc[m][e] -= tj[m];
        }
      if constexpr (KEYS_FIXED) {
        float zj[kR], w[4];
        ld_row<kR>(zs + j * kPStride + p_r * kR, zj);
        ld4(bt + j * S::kSStride + p_c * 4, w);
        const float icj = ic[j];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] *= icj;
#pragma unroll
        for (int m = 0; m < kR; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (xb[m][e] > zj[m]) accb[m][e] += w[e];
      }
    }
  }

  T* oa = static_cast<T*>(KEYS_FIXED ? a.dk : a.dq);
  T* ob = static_cast<T*>(a.dv);
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    const int fr = f0 + p_r * kR + m;
    if (fr >= n_f) continue;
    st4(oa + fixed_at(fr) + p_c * 4, acc[m]);
    if constexpr (KEYS_FIXED) st4(ob + fixed_at(fr) + p_c * 4, accb[m]);
  }
}

template <typename T, int D, bool SIGNED>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_inhibitor_bwd_dkdv_kernel(BwdArgs a) {
  bwd_block<T, D, SIGNED, true>(a);
}

template <typename T, int D, bool SIGNED>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_inhibitor_bwd_dq_kernel(BwdArgs a) {
  bwd_block<T, D, SIGNED, false>(a);
}

// one pass: pass A's grid (row x kv head, key tile), pass B's (row x query
// head, query tile)
template <typename T, int D, bool SIGNED, bool KEYS_FIXED>
cudaError_t launch_pass(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<T, D, KEYS_FIXED>::kBytes;
  static_assert(smem <= kMaxSmem, "shared memory");
  void (*kern)(BwdArgs) = KEYS_FIXED
                              ? flash_inhibitor_bwd_dkdv_kernel<T, D, SIGNED>
                              : flash_inhibitor_bwd_dq_kernel<T, D, SIGNED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n = KEYS_FIXED ? a.n_k : a.n_q;
  const dim3 grid(a.batch * (KEYS_FIXED ? a.kv_heads : a.heads),
                  (n + kTile - 1) / kTile);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(bool is_signed, const BwdArgs& a, cudaStream_t stream) {
  cudaError_t e = is_signed ? launch_pass<T, D, true, true>(a, stream)
                            : launch_pass<T, D, false, true>(a, stream);
  if (e != cudaSuccess) return e;
  return is_signed ? launch_pass<T, D, true, false>(a, stream)
                   : launch_pass<T, D, false, false>(a, stream);
}

template <typename T>
cudaError_t dispatch(int head_dim, bool is_signed, const BwdArgs& a,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(is_signed, a, stream);
    case 32: return launch<T, 32>(is_signed, a, stream);
    case 64: return launch<T, 64>(is_signed, a, stream);
    case 128: return launch<T, 128>(is_signed, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; head_dim 16, 32, 64 or 128; heads a
// multiple of kv_heads; q / k / v / g / dq / dk / dv 16-byte aligned and
// every dimension > 0.  Launches pass A (dk, dv) and then pass B (dq) on
// `stream`, asynchronously; returns a cudaError_t code (0 = launched).
extern "C" int flash_inhibitor_backward(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    void* dq, void* dk, void* dv, int batch, int n_q, int n_k, int heads,
    int kv_heads, int head_dim, float inv_scale, float shift, int is_signed,
    int normalize, int causal, int window, int q_off, void* stream) {
  if (batch <= 0 || n_q <= 0 || n_k <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,     k,       v,        g,         dq,    dk,
                  dv,    batch,   n_q,      n_k,       heads, kv_heads,
                  inv_scale, shift, normalize, causal, window, q_off};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(head_dim, is_signed, a, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(head_dim, is_signed, a, s);
  return (int)cudaErrorInvalidValue;
}
