// Blockwise prefill / training forward kernels for Hopper (sm_90a): the
// inhibitor (paper eq. 5-7) and the Softmax dot-product baseline, over
// contiguous (batch, n, heads, head_dim) operands.
//
// Replaces the TPU kernels
//   flash_inhibitor_kernel    <- _flash_inhibitor_kernel
//                                (src/repro/kernels/inhibitor.py:99)
//   flash_attention_tc_kernel <- _flash_attention_kernel
//   (bf16; float32: flash_attention_kernel) (src/repro/kernels/flash.py:35)
//
// Layouts (row-major, contiguous):
//   q, out  (batch, n_q, heads, head_dim)      T
//   k, v    (batch, n_k, kv_heads, head_dim)   T
//   cursors (2, batch) int32 or null: row 0 query offsets, row 1 KV valid
//           lengths (the decode-cache form; null = offset 0, all n_k keys)
// T is float or __nv_bfloat16; all sums are float32.
//
// Masking.  Query i of row r sits at position q_off[r] + i.  Key j is
// attended iff j < min(kv_valid[r], n_k), and, when causal (a window
// implies causality), j <= pos, and, with a window, j > pos - window.
// Keys past the last key any query of the block attends are never read.
// The key count of each query is the closed form of the same predicate.
// A row with no attended key writes 0 (flash.py:92-95); a Softmax row
// writes acc / max(l, 1e-20).
//
// The inhibitor (flash_inhibitor_kernel<T, D, SIGNED>), register-tiled on
// the CUDA cores.  It computes, per query, Z_j = relu(sum_d |q - k_j| /
// gamma - alpha) and out = sum_j relu(v_j - Z_j) (eq. 9, unsigned) or
// sum_j relu(v+ - Z) + min(v- + Z, 0) (eq. 10, signed), / max(count, 1)
// when normalizing.  No tensor core computes a sum of absolute
// differences, and only the normalisation is a product.
//
// Bound on this card.  Its inner-loop instructions are adds, min / max and
// one fma whose product is by +-1, each one instruction per lane and
// cycle: 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 a second, half the 67
// TFLOP/s quoted for FMAs (which count an fma as two operations).  The least work per (query head,
// attended key, d) is 4 instructions: t = q - k and s += |t| for the score
// (the absolute value is a free operand modifier of the add), and m =
// min(|v|, z), acc = fma(-sgn v, m, acc) for the inhibition, because for
// z >= 0 each term v > 0 ? relu(v - z) : min(v + z, 0) equals
// v - sgn(v) min(|v|, z) (v > 0: v - z or 0; v < 0: v + z or 0; v = 0: 0)
// and relu(v - z) equals v - min(v, z); the sum of v over the attended
// keys is one prefix sum shared by all queries.  At the training shape
// (b 8, n 1024 causal, 9 / 3 heads, d 64, bf16: 2.42e9 such elements)
// that is 0.289 ms, against 25 MB of operands (7.5 us at 3.35 TB/s): bound
// by operations.  What the design does about that bound, step by step:
//   1. Register-tiled scores.  One block of 4 warps per (row, query head,
//      tile of 64 queries), looping over 64-key tiles.  Each thread owns a
//      micro-tile of 8 queries x 4 keys (keys kg + 16 n, so the 8 threads
//      of a quarter warp read 8 distinct K rows) and reads Q (float32,
//      staged once per block) and K 16 bytes at a time: per 4 d, 8 Q loads
//      and, per 8 d, 4 K loads and 32 conversions serve 256 instructions of
//      sums, about 2.2 instructions per (pair, d).  Z goes to shared memory
//      once per pair, key-major.
//   2. Register-tiled inhibition, branch-free.  A thread owns head_dim / 8
//      queries x 4 dims; per key it loads its 4 values of V (|v| is an
//      operand modifier, sgn v one logic instruction) and its queries' z.
//      On a tile every query wholly attends it adds -sgn(v) min(|v|, z)
//      (unsigned: -min(v, z)), one min and one fma per element, and the
//      tile's sum of v once per output at the tile's end (4 adds per key
//      and thread).  On a tile with masked pairs it adds sgn(v) relu(|v| -
//      z) (unsigned: relu(v - z)), one add, one max and one fma: for z >=
//      0, v > 0 ? relu(v - z) : min(v + z, 0) equals sgn(v) relu(|v| - z)
//      bit for bit (for v < 0, -(v + z) and |v| - z are the same float),
//      and a masked pair (z = +inf) adds an exact 0, where the min form
//      would cancel its v against the tile's sum only up to rounding.  At
//      d 64: 64 or 96 such instructions per key against 2 Z loads, 1 V
//      load and 8 conversions.
//   3. Masks only where a tile needs them.  A tile that every query of the
//      block wholly attends runs without predicates; on one that crosses
//      the causal diagonal, the window edge or a cursor, a masked pair gets
//      z = +inf, and relu(|v| - inf) adds an exact 0.  Keys at or past
//      min(kv_valid, n_k) enter shared memory as zeros (cp.async's source
//      size 0), so nan or inf past a cursor never meets an operation, and
//      poisoned and clean inputs give identical bits.  Queries past n_q are
//      zeros and are never written.  Counts are the closed form.
//   4. Asynchronous staging.  K and V tiles are double-buffered in shared
//      memory by cp.async, 16 bytes a thread, kept in the operand type
//      (rows padded by 16 bytes) and converted at the fragment load: the
//      copy of tile t + 1 runs under the sums of tile t.
//   5. One query head per block, K and V of the group read through L2
//      (each kv head's tiles by its 3 query heads' blocks, 160 MB of L2
//      traffic at the training shape, tens of microseconds beside the sums)
//      rather than the group's 3 heads sharing a tile: rows stay a power of
//      two for the micro-tiles and a block stays at 4 warps and 72 KB of
//      shared memory (bf16, d 64), three blocks to an SM.  The heaviest
//      causal tiles launch first.
// Per interior 64 x 64 tile at d 64 a thread issues about 9.7k
// instructions (counted from this source) against the 8.2k of the bound;
// the diagonal tiles take the 3-instruction inhibition and their masked
// half adds 6%.
//
// The float32 Softmax (flash_attention_kernel) on the CUDA cores.  One
// block per (row, kv head, tile of block_q queries) loops over 32-key
// tiles, from the tile holding the first key any query of the block
// attends to the last.  All `group = heads / kv_heads` query heads of the
// kv head share each staged K/V tile.  Shared memory holds Q (group *
// block_q rows), the K and V tile (rows padded to head_dim + 1 floats, so
// the 32 lanes reading 32 keys hit 32 banks) and the tile's scores.  Per
// tile: stage K, V as float; scores, one warp per query row, one lane per
// key, with the row's running max (from -1e30), running sum and rescale
// done by shuffles; then each thread owns one head_dim column e and up to
// 16 query rows, its rescaled outputs in float32 registers.  Masked pairs
// are left out by predicate.  It stays on the CUDA cores because TF32
// products (10-bit mantissas) would not meet the float32 tolerance; the
// training path never launches it (it computes in bf16), the float32
// parity cases do.
//
// The bf16 Softmax on the tensor cores (flash_attention_tc_kernel), in
// the shape of FlashAttention-2.  One block per (row, query head, tile of
// block_q = 64 or 128 queries): 4 or 8 warps, each owning 16 query rows.
// A launch per query head rather than per kv head: the block is then 4
// warps whatever the group, the registers of a warp hold only its own
// rows, and the group's 3 blocks read the same K/V tiles from the 50 MB L2
// (at the training shape all K and V is 6.3 MB); sharing a tile across the
// group would take 12-warp blocks and a third as many of them.  Query
// tiles run heaviest first (the last causal tile is launched first).
// Per 64-key tile, double-buffered in shared memory by cp.async (16 B a
// thread; rows padded by 16 B so the 8 rows of each ldmatrix hit 8
// distinct bank groups):
//   1. S = Q K^T by mma.sync.m16n8k16 (bf16 in, float32 accumulate), Q
//      fragments held in registers from the first tile, K fragments by
//      ldmatrix; a bf16 x bf16 product is exact in float32, as the
//      reference's float32 einsum of bf16 values is;
//   2. masks from indices, only on tiles that cross the diagonal, the
//      window edge, the cursor or n_k for some row of the warp; interior
//      tiles run unmasked, and a tile no row of the warp attends is
//      skipped by that warp;
//   3. online softmax in registers: the running max (from -1e30), the
//      running sum and the rescale of O per row, with shuffles across the
//      4 lanes that share a row of the m16n8 fragment; p = 2^(s c - m c),
//      c = log2(e) / scale, by ex2.approx (a masked score, -inf, gives 0);
//   4. O += P V by mma.sync, V fragments by ldmatrix.trans.  The reference
//      multiplies P in float32 (flash.py:97); P rounded to bf16 alone errs
//      by up to 2^-9 of each term, beyond the bf16 tolerance on outputs
//      near 0.  So P = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p -
//      p_hi), and both are multiplied by V: the error falls to about
//      2^-17 of sum p |v| / l, inside the float32 term of the tolerance,
//      for one more product per tile (1.5x the tensor work).
// Keys at or past min(kv_valid, n_k) enter shared memory as zeros by
// cp.async's zero-fill (source size 0): they are never loaded, so nan
// past a cursor cannot meet a product (a masked score does not stop
// 0 x nan = nan in P V).  Queries past n_q are zero-filled the same way
// and never written.
//
// The Softmax's bound: 9.7 GFLOP at the training shape take 10 us on the
// bf16 tensor cores (989 TFLOP/s), bound by operations.  Between the
// tensor-core kernel and that bound stand mma.sync itself (the
// synchronous warp-level product, slower than the asynchronous warpgroup
// wgmma), the hi/lo split's third product, the exponentials on the CUDA
// cores (one per attended pair), and the diagonal tiles' masked half;
// wgmma on TMA-staged tiles with mbarriers, warp specialisation (a
// producer warp and consumer warpgroups) and a persistent causal schedule
// are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// Block-level state of the float32 Softmax kernel: where the block's queries and
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

// ---------------------------------------------------------------------------
// bf16 Softmax on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBlockK = 64;   // keys per staged tile
constexpr int kTcPad = 8;       // bf16 of padding per shared-memory row

// bytes of shared memory: Q (block_q rows) and two stages of K and V
__host__ __device__ inline size_t tc_smem_bytes(int block_q, int d) {
  return sizeof(__nv_bfloat16) * (size_t)(d + kTcPad) *
         ((size_t)block_q + 4 * kTcBlockK);
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

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 float32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (relative error about 2^-22; results below 2^-126 flush
// to 0, against a running sum l >= 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) -> bf16 pair, x0 in the low half; and the pair of remainders
// x - bf16(x), rounded to bf16
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_attention_tc_kernel(PrefillArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int kStride = D + kTcPad;   // bf16 per shared-memory row
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  constexpr int kKSteps = D / 16;       // mma K steps over head_dim
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row = blockIdx.x / a.heads;
  const int head = blockIdx.x - row * a.heads;
  const int kvh = head / (a.heads / a.kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * a.block_q;  // heaviest first
  const int q_off = a.cursors ? a.cursors[row] : 0;
  const int kv_lim = a.cursors ? min(a.n_k, a.cursors[a.batch + row]) : a.n_k;

  // the block's key tiles: the first query's lo to the last one's hi
  const int q_last = min(a.n_q, q0 + a.block_q) - 1;
  const int k_first =
      (key_range(a, q_off, kv_lim, q0).lo / kTcBlockK) * kTcBlockK;
  const int k_end = key_range(a, q_off, kv_lim, q_last).hi;
  const int n_tiles =
      k_end > k_first ? (k_end - k_first + kTcBlockK - 1) / kTcBlockK : 0;

  // this warp's 16 rows: wf, wl are the key ranges of its first and last
  // valid row; both ends rise with the query, so the rows' union is
  // [wf.lo, wl.hi) and their intersection [wl.lo, wf.hi)
  const int wq0 = q0 + warp * 16;
  const bool warp_live = wq0 < a.n_q;
  const KeyRange wf = key_range(a, q_off, kv_lim, wq0);
  const KeyRange wl =
      key_range(a, q_off, kv_lim, min(a.n_q - 1, wq0 + 15));
  // the two rows of this thread: g8 and g8 + 8
  const KeyRange rr0 = key_range(a, q_off, kv_lim, wq0 + g8);
  const KeyRange rr1 = key_range(a, q_off, kv_lim, wq0 + g8 + 8);

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* ks = qs + (size_t)a.block_q * kStride;   // [2][64][kStride]
  __nv_bfloat16* vs = ks + 2 * kTcBlockK * kStride;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v);

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < a.block_q * kChunks; i += blockDim.x) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const bool ok = q0 + r < a.n_q;
      const size_t src =
          (((size_t)row * a.n_q + q0 + r) * a.heads + head) * D + ch * 8;
      cp_async_16(smem_addr(qs + r * kStride + ch * 8), ok ? qg + src : qg,
                  ok);
    }
  }
  auto stage_kv = [&](int stage, int k0) {
    for (int i = threadIdx.x; i < kTcBlockK * kChunks; i += blockDim.x) {
      const int j = i / kChunks, ch = i - j * kChunks;
      const bool ok = k0 + j < kv_lim;
      const size_t src =
          (((size_t)row * a.n_k + k0 + j) * a.kv_heads + kvh) * D + ch * 8;
      const int dst = (stage * kTcBlockK + j) * kStride + ch * 8;
      cp_async_16(smem_addr(ks + dst), ok ? kg + src : kg, ok);
      cp_async_16(smem_addr(vs + dst), ok ? vg + src : vg, ok);
    }
  };
  if (n_tiles > 0) stage_kv(0, k_first);
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  const float c = 1.4426950408889634f / a.scale;   // log2(e) / scale
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * kTcBlockK;
    if (t + 1 < n_tiles) stage_kv((t + 1) & 1, k0 + kTcBlockK);
    cp_async_commit();
    cp_async_wait_1();   // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * kStride +
                                      kk * 16 + (lane >> 4) * 8));
    }
    const bool skip = !warp_live || k0 >= wl.hi || k0 + kTcBlockK <= wf.lo;
    if (!skip) {
      const __nv_bfloat16* kt = ks + (size_t)(t & 1) * kTcBlockK * kStride;
      const __nv_bfloat16* vt = vs + (size_t)(t & 1) * kTcBlockK * kStride;
      // 1. S = Q K^T: 8 blocks of 8 keys
      float s[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int nb2 = 0; nb2 < 4; ++nb2) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(kt +
                                   (nb2 * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       kStride +
                                   kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * nb2], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * nb2 + 1], qf[kk], b[2], b[3]);
        }
      }
      // 2. masks, only where some row of the warp needs one
      const bool interior = k0 >= wl.lo && k0 + kTcBlockK <= wf.hi;
      if (!interior) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + nb * 8 + 2 * t4 + (e & 1);
            const KeyRange& r = e < 2 ? rr0 : rr1;
            if (kj < r.lo || kj >= r.hi) s[nb][e] = -INFINITY;
          }
      }
      // 3. online softmax; rows g8 (e < 2) and g8 + 8 (e >= 2)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
      }
      float alpha[2], mc[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);   // finite: >= -1e30
        alpha[i] = exp2_approx((m_run[i] - m_new) * c);
        m_run[i] = m_new;
        mc[i] = m_new * c;
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[nb][e], c, -mc[e >> 1]));
          s[nb][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }
      // 4. O += (P_hi + P_lo) V, 16 keys per K step
#pragma unroll
      for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        // all of the K step's V fragments first, then the hi products,
        // then the lo ones: D / 8 independent products stand between two
        // into the same accumulator
        uint32_t b[D / 16][4];
#pragma unroll
        for (int nd2 = 0; nd2 < D / 16; ++nd2)
          ldmatrix_x4_trans(
              b[nd2], smem_addr(vt +
                                (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * kStride +
                                nd2 * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int nd2 = 0; nd2 < D / 16; ++nd2) {
          mma_bf16(o[2 * nd2], ph, b[nd2][0], b[nd2][1]);
          mma_bf16(o[2 * nd2 + 1], ph, b[nd2][2], b[nd2][3]);
        }
#pragma unroll
        for (int nd2 = 0; nd2 < D / 16; ++nd2) {
          mma_bf16(o[2 * nd2], pl, b[nd2][0], b[nd2][1]);
          mma_bf16(o[2 * nd2 + 1], pl, b[nd2][2], b[nd2][3]);
        }
      }
    }
    __syncthreads();   // the next stage_kv overwrites this tile's buffer
  }

  // the row sums over the quad, then out = acc / max(l, 1e-20)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] = fmaxf(l_run[i], 1e-20f);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = wq0 + g8 + 8 * i;
    if (qi >= a.n_q) continue;
    __nv_bfloat16* dst =
        out + (((size_t)row * a.n_q + qi) * a.heads + head) * D + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
          __floats2bfloat162_rn(o[nd][2 * i] / l_run[i],
                                o[nd][2 * i + 1] / l_run[i]);
  }
}

// ---------------------------------------------------------------------------
// The inhibitor, register-tiled on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kIhThreads = 128;
constexpr int kIhBQ = 64;   // queries per block, all of one query head
constexpr int kIhBK = 64;   // keys per staged tile
constexpr int kIhTM = 8;    // score micro-tile: 8 queries ...
constexpr int kIhTN = 4;    // ... x 4 keys per thread

// Shared memory of one block, in bytes (T the operand type):
//   Q float [kIhBQ][D + 4] | K T [2][kIhBK][D + E] | V T [2][kIhBK][D + E]
//   | Z float [kIhBK][kIhBQ + 4]
// E = 16 / sizeof(T): K and V rows are padded by 16 bytes, so the 8 rows
// that a quarter warp reads 16 bytes each of lie in 8 distinct bank groups.
template <typename T, int D>
struct IhSmem {
  static constexpr int kE = 16 / (int)sizeof(T);
  static constexpr int kQStride = D + 4;          // floats
  static constexpr int kKVStride = D + kE;        // T
  static constexpr int kZStride = kIhBQ + 4;      // floats
  static constexpr size_t kQBytes = sizeof(float) * kIhBQ * kQStride;
  static constexpr size_t kTileBytes = sizeof(T) * kIhBK * kKVStride;
  static constexpr size_t kBytes = kQBytes + 4 * kTileBytes +
                                   sizeof(float) * kIhBK * kZStride;
};

// 16 bytes (shared or global memory) as float32: 8 bf16 or 4 float
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void ld16(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

// 4 consecutive elements (8 or 16 bytes) as float32
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

template <typename T, int D, bool SIGNED>
__global__ void __launch_bounds__(kIhThreads, D <= 64 ? 3 : 1)
    flash_inhibitor_kernel(PrefillArgs a) {
  using S = IhSmem<T, D>;
  constexpr int kE = S::kE;
  constexpr int kChunks = D / kE;              // 16-byte chunks per row
  constexpr int kCols = D / 4;                 // value phase: column groups
  constexpr int kTMV = kIhBQ * kCols / kIhThreads;   // ... rows per thread
  static_assert(kTMV >= 2 && kTMV % 2 == 0, "value micro-tile rows");
  extern __shared__ __align__(16) unsigned char ih_smem[];
  float* qs = reinterpret_cast<float*>(ih_smem);
  T* ks = reinterpret_cast<T*>(ih_smem + S::kQBytes);
  T* vs = reinterpret_cast<T*>(ih_smem + S::kQBytes + 2 * S::kTileBytes);
  float* zs =
      reinterpret_cast<float*>(ih_smem + S::kQBytes + 4 * S::kTileBytes);

  const int tid = threadIdx.x;
  const int row = blockIdx.x / a.heads;
  const int head = blockIdx.x - row * a.heads;
  const int kvh = head / (a.heads / a.kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kIhBQ;   // heaviest first
  const int q_off = a.cursors ? a.cursors[row] : 0;
  const int kv_lim = a.cursors ? min(a.n_k, a.cursors[a.batch + row]) : a.n_k;
  const int q_last = min(a.n_q, q0 + kIhBQ) - 1;
  // every query of the block attends [lo_last, hi_first); their union is
  // [first.lo, last.hi)
  const KeyRange first = key_range(a, q_off, kv_lim, q0);
  const KeyRange last = key_range(a, q_off, kv_lim, q_last);
  const int k_first = (first.lo / kIhBK) * kIhBK;
  const int n_tiles = last.hi > k_first
                          ? (last.hi - k_first + kIhBK - 1) / kIhBK : 0;

  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  auto stage_kv = [&](int stage, int k0) {
    for (int i = tid; i < kIhBK * kChunks; i += kIhThreads) {
      const int j = i / kChunks, ch = i - j * kChunks;
      const bool ok = k0 + j < kv_lim;   // else zero-filled, never read
      const size_t src =
          (((size_t)row * a.n_k + k0 + j) * a.kv_heads + kvh) * D + ch * kE;
      const int dst = (stage * kIhBK + j) * S::kKVStride + ch * kE;
      cp_async_16(smem_addr(ks + dst), ok ? kg + src : kg, ok);
      cp_async_16(smem_addr(vs + dst), ok ? vg + src : vg, ok);
    }
  };
  if (n_tiles > 0) {
    stage_kv(0, k_first);
    cp_async_commit();
    // Q as float32, once per block; queries past n_q are zeros
    for (int i = tid; i < kIhBQ * kChunks; i += kIhThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      float x[kE];
      if (q0 + r < a.n_q) {
        const T* src =
            qg + (((size_t)row * a.n_q + q0 + r) * a.heads + head) * D +
            ch * kE;
        ld16(src, x);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) x[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kE; e += 4)
        *reinterpret_cast<float4*>(qs + r * S::kQStride + ch * kE + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }

  // score phase: thread (rg, kg) owns queries rg*8 + m and keys kg + 16n
  const int s_rg = tid >> 4, s_kg = tid & 15;
  // value phase: thread (vr, vc) owns queries vr*kTMV + m, dims vc*4 + e
  const int v_r = tid / kCols, v_c = tid - (tid / kCols) * kCols;
  float o[kTMV][4];
#pragma unroll
  for (int m = 0; m < kTMV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[m][e] = 0.0f;
  const float inv_scale = 1.0f / a.scale;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * kIhBK;
    cp_async_wait_all();   // tile t (and Q's plain stores) visible after:
    __syncthreads();       // every thread is also done with tile t - 1
    if (t + 1 < n_tiles) {
      stage_kv((t + 1) & 1, k0 + kIhBK);
      cp_async_commit();
    }
    const T* kt = ks + (size_t)(t & 1) * kIhBK * S::kKVStride;
    const T* vt = vs + (size_t)(t & 1) * kIhBK * S::kKVStride;

    // 1. Z = relu(sum_d |q - k| / gamma - alpha) for 8 x 4 pairs
    float sc[kIhTM][kIhTN];
#pragma unroll
    for (int m = 0; m < kIhTM; ++m)
#pragma unroll
      for (int n = 0; n < kIhTN; ++n) sc[m][n] = 0.0f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += kE) {
      float kf[kIhTN][kE];
#pragma unroll
      for (int n = 0; n < kIhTN; ++n)
        ld16(kt + (s_kg + 16 * n) * S::kKVStride + d0, kf[n]);
#pragma unroll
      for (int dd = 0; dd < kE; dd += 4) {
#pragma unroll
        for (int m = 0; m < kIhTM; ++m) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + (s_rg * kIhTM + m) * S::kQStride + d0 + dd);
#pragma unroll
          for (int n = 0; n < kIhTN; ++n) {
            sc[m][n] += fabsf(qv.x - kf[n][dd]);
            sc[m][n] += fabsf(qv.y - kf[n][dd + 1]);
            sc[m][n] += fabsf(qv.z - kf[n][dd + 2]);
            sc[m][n] += fabsf(qv.w - kf[n][dd + 3]);
          }
        }
      }
    }
    // masks only on a tile that some query of the block does not wholly
    // attend: a masked pair gets z = +inf, so relu(|v| - z) adds exactly 0
    const bool interior = k0 >= last.lo && k0 + kIhBK <= first.hi;
#pragma unroll
    for (int n = 0; n < kIhTN; ++n) {
      const int j = s_kg + 16 * n;
      float z[kIhTM];
#pragma unroll
      for (int m = 0; m < kIhTM; ++m) {
        z[m] = sc[m][n] * inv_scale;
        if (a.shift != 0.0f) z[m] = fmaxf(z[m] - a.shift, 0.0f);
        if (!interior) {
          const KeyRange r =
              key_range(a, q_off, kv_lim, q0 + s_rg * kIhTM + m);
          if (k0 + j < r.lo || k0 + j >= r.hi) z[m] = INFINITY;
        }
      }
      float* dst = zs + j * S::kZStride + s_rg * kIhTM;
      *reinterpret_cast<float4*>(dst) = make_float4(z[0], z[1], z[2], z[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(z[4], z[5], z[6], z[7]);
    }
    __syncthreads();

    // 2. the inhibition, for head_dim / 8 queries x 4 dims
    auto load_vz = [&](int j, float (&vv)[4], float (&z)[kTMV]) {
      ld4(vt + j * S::kKVStride + v_c * 4, vv);
      const float* zr = zs + j * S::kZStride + v_r * kTMV;
      if constexpr (kTMV % 4 == 0) {
#pragma unroll
        for (int m = 0; m < kTMV; m += 4) {
          const float4 zz = *reinterpret_cast<const float4*>(zr + m);
          z[m] = zz.x;
          z[m + 1] = zz.y;
          z[m + 2] = zz.z;
          z[m + 3] = zz.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < kTMV; m += 2) {
          const float2 zz = *reinterpret_cast<const float2*>(zr + m);
          z[m] = zz.x;
          z[m + 1] = zz.y;
        }
      }
    };
    if (interior) {
      // every pair attended: out += v - sgn(v) min(|v|, z) (unsigned:
      // v - min(v, z)), one min and one fma per element; the tile's sum
      // of v is added once per output
      float vsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int j = 0; j < kIhBK; ++j) {
        float vv[4], z[kTMV];
        load_vz(j, vv, z);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          vsum[e] += vv[e];
          const float ns = SIGNED ? -copysignf(1.0f, vv[e]) : -1.0f;
          const float av = SIGNED ? fabsf(vv[e]) : vv[e];
#pragma unroll
          for (int m = 0; m < kTMV; ++m)
            o[m][e] = fmaf(ns, fminf(av, z[m]), o[m][e]);
        }
      }
#pragma unroll
      for (int m = 0; m < kTMV; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[m][e] += vsum[e];
    } else {
      // out += sgn(v) relu(|v| - z) (unsigned: relu(v - z)): one add, one
      // max and one fma per element; a masked pair (z = +inf) adds 0
#pragma unroll 4
      for (int j = 0; j < kIhBK; ++j) {
        float vv[4], z[kTMV];
        load_vz(j, vv, z);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sg = SIGNED ? copysignf(1.0f, vv[e]) : 1.0f;
          const float av = SIGNED ? fabsf(vv[e]) : vv[e];
#pragma unroll
          for (int m = 0; m < kTMV; ++m)
            o[m][e] = fmaf(sg, fmaxf(av - z[m], 0.0f), o[m][e]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int m = 0; m < kTMV; ++m) {
    const int qi = q0 + v_r * kTMV + m;
    if (qi >= a.n_q) continue;
    if (a.normalize) {
      const KeyRange r = key_range(a, q_off, kv_lim, qi);
      const float c = fmaxf((float)max(0, r.hi - r.lo), 1.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][e] = o[m][e] / c;
    }
    st4(out + (((size_t)row * a.n_q + qi) * a.heads + head) * D + v_c * 4,
        o[m]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the float32 Softmax on the CUDA cores: grid (row x kv head, query tile)
template <int D>
cudaError_t launch_cuda_core(void (*kern)(PrefillArgs), const PrefillArgs& a,
                             cudaStream_t stream) {
  const int group = a.heads / a.kv_heads;
  const size_t smem = sizeof(float) * smem_floats(group, a.block_q, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.batch * a.kv_heads, (a.n_q + a.block_q - 1) / a.block_q);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the tensor-core kernel: grid (row x query head, query tile), 16 query
// rows per warp
template <int D>
cudaError_t launch_tc(const PrefillArgs& a, cudaStream_t stream) {
  if (a.block_q != 64 && a.block_q != 128) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(a.block_q, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.batch * a.heads, (a.n_q + a.block_q - 1) / a.block_q);
  flash_attention_tc_kernel<D><<<grid, a.block_q * 2, smem, stream>>>(a);
  return cudaGetLastError();
}

// the inhibitor: grid (row x query head, query tile of kIhBQ)
template <typename T, int D, bool SIGNED>
cudaError_t launch_inhibitor_as(const PrefillArgs& a, cudaStream_t stream) {
  constexpr size_t smem = IhSmem<T, D>::kBytes;
  void (*kern)(PrefillArgs) = flash_inhibitor_kernel<T, D, SIGNED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.batch * a.heads, (a.n_q + kIhBQ - 1) / kIhBQ);
  kern<<<grid, kIhThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_inhibitor(const PrefillArgs& a, cudaStream_t stream) {
  if (a.block_q != kIhBQ) return cudaErrorInvalidValue;
  return a.is_signed ? launch_inhibitor_as<T, D, true>(a, stream)
                     : launch_inhibitor_as<T, D, false>(a, stream);
}

template <int D>
cudaError_t launch(bool inhibitor, int dtype, const PrefillArgs& a,
                   cudaStream_t stream) {
  if (inhibitor)
    return dtype == 0 ? launch_inhibitor<float, D>(a, stream)
                      : launch_inhibitor<__nv_bfloat16, D>(a, stream);
  return dtype == 0 ? launch_cuda_core<D>(flash_attention_kernel<float, D>, a,
                                          stream)
                    : launch_tc<D>(a, stream);
}

cudaError_t dispatch(bool inhibitor, int dtype, int head_dim,
                     const PrefillArgs& a, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return launch<16>(inhibitor, dtype, a, stream);
    case 32: return launch<32>(inhibitor, dtype, a, stream);
    case 64: return launch<64>(inhibitor, dtype, a, stream);
    case 128: return launch<128>(inhibitor, dtype, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; head_dim 16, 32, 64 or 128; the
// inhibitor takes block_q 64, the bf16 Softmax (tensor cores) 64 or 128,
// both with q / k / v 16-byte aligned.  Returns a cudaError_t code (0 = launched); the launch is
// asynchronous on `stream`.
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

// Shared-memory bytes one launch of the float32 Softmax needs (the wrapper
// checks the limit).
extern "C" long long flash_prefill_smem_bytes(int group, int block_q,
                                              int head_dim) {
  return (long long)(sizeof(float) * smem_floats(group, block_q, head_dim));
}

// Most output elements (group * block_q * head_dim) one block of the
// float32 Softmax can hold.
extern "C" int flash_prefill_max_outputs() { return kMaxAcc * kThreads; }
