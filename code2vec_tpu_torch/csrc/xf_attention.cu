// Fused multi-head self-attention of the transformer path-encoder, forward
// and backward, for Hopper.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (launched from
// `_mha_fwd_pallas`, ops/xf_attention.py:120 of the JAX package) and
// `_bwd_kernel` (`_mha_bwd_pallas`, :138). For each (b, h), with q, k, v and
// do [C, hd] widened to float32, s = 1 / sqrt(hd) rounded to float32 and the
// additive key mask log_mask[b] [C] (log(1e-30) ~ -69.08 on a masked key, not
// -inf):
//
//   forward (kernel 2):   L = q k^T * s + log_mask,  A = softmax(L) by row,
//                         o = A v
//   backward (kernel 3):  dV = A^T do,  dA = do v^T,
//                         dL = A * (dA - rowsum(dA * A)),
//                         dq = dL k * s,  dk = dL^T q * s
//
// with the Pallas kernels' float32 semantics (their products take float32
// operands and accumulate in float32), outputs in q's dtype, and no [C, C]
// tensor ever reaches device memory. Every query row is computed, padded ones
// too: their outputs flow on through the layer as in the JAX package.
//
// Kernel 2 on bf16 inputs (the only dtype of the main paths):
// `mha_fwd_tc_kernel`, on the tensor cores (warp-level mma.sync m16n8k16,
// bf16 operands, float32 accumulators). One block per (b, h), one warp per
// 16 query rows (13 warps at C = 200: 208 row slots, 96 % live). Q, K and V
// are staged once in shared memory with 16-byte cp.async copies (V in a
// second group that lands while the first pass runs) at a row stride of
// hd + 8 elements: 16-byte aligned rows for ldmatrix, and the 8 rows of one
// ldmatrix phase on distinct banks. Rows past C are zero-filled and their
// keys get the mask -inf, so their weights are exactly 0 (0 x garbage could
// be NaN). The arithmetic:
//   - q k^T: bf16 x bf16 products are exact in float32, so the mma gives the
//     Pallas logits up to the order of the sum. Each logit is scaled and
//     masked with a separate multiply and add (__fmul_rn, __fadd_rn), as the
//     Pallas kernel rounds them.
//   - two passes over the keys, 16 at a time: the first takes the exact row
//     maximum m, the second recomputes the same logits (the same mma
//     sequence, the same bits), e = exp(L - m) and the row sum l. Nothing is
//     rescaled: m is the Pallas kernel's m.
//   - A v with float32 weights: the tensor cores take bf16, so each e is
//     split into three bf16 terms, e = e_hi + e_mid + e_lo (each the bf16 of
//     what the terms before it left; three hold all 24 bits of e), and o
//     takes the three products e_t v. Two terms (a 2^-16 residual) were
//     within XF_TOL but not enough end to end (PERF.md). The weights go
//     from the logits' accumulator fragments to the A-operand fragments in
//     registers (the layouts agree), V through ldmatrix.trans.
//   - the tensor cores' float32 sum truncates: an accumulator carried
//     through many mma drifts toward zero by about an ulp of itself at each.
//     So each mma step gets a fresh accumulator, added to the running
//     float32 sum with one IEEE add: q k^T per 16 columns of hd, A v per 16
//     keys (its three terms smallest first).
//   - normalised once per row at the end (FlashAttention-2 style):
//     o = (sum_j e_j v_j) / l, where the Pallas kernel divides each weight by
//     l before the product; the two differ by a float32 rounding.
//   - no atomics and a fixed order of every sum: the same inputs give the
//     same bits on every launch.
// float32 inputs keep `mha_fwd_kernel` (float32 FMA on the CUDA cores,
// below).
//
// Bound of kernel 2 on bf16 on an H100 SXM at the training shape (B = 1024,
// H = 3, C = 200, hd = 128): 629 MB moved, 0.188 ms at 3.35 TB/s; four bf16
// products of 2 C^2 hd per (b, h) (q k^T and the three e_t v; 126 GFLOP) at
// the 989 TFLOP/s tensor-core peak, 0.127 ms. So bytes bound it. The design
// reads each input once and writes o once; what it adds is the second q k^T
// (a fifth product: 0.159 ms at the peak), the float32 adds of the fresh
// accumulators, and one block per SM (170 KB of shared memory), with V's
// copy overlapping the first pass.
//
// Kernel 3 on bf16: two launches on the tensor cores, with kernel 2's
// staging, stride, fragments and arithmetic (bf16 x bf16 products exact in
// a fresh float32 accumulator per 16-column k-step; each product with a
// float32 operand as three bf16 terms of it, smallest first, into a fresh
// accumulator per 16-row chunk, then one IEEE add):
//   - `mha_bwd_dq_tc_kernel` (3a): one block per (b, h) and tile of query
//     rows, one warp per 16 of them, K and V staged whole. Three passes
//     over the keys, 16 at a time, each recomputing the logits: the exact
//     row max m; l = sum_j e_j with e = exp(L - m), and delta, the Pallas
//     row sum of dA * A from the float32 weights (not do . o, which was
//     rounded to the input dtype), as (sum_j e_j dA_j) / l with dA = do v^T;
//     then A = e r with r the rounded reciprocal of l, dL = A (dA - delta)
//     and dq += dL k in terms, k through ldmatrix.trans. Writes dq * s and
//     the row statistics (m, l, delta) to a [B, H, C, 3] float32 scratch.
//     A = e r is within an ulp of the Pallas e / l: an IEEE division an
//     element took a third of the kernel's time, and a third pass for
//     delta another tenth (PERF.md).
//   - `mha_bwd_dkv_tc_kernel` (3b): one block per (b, h) and tile of key
//     rows, one warp per 16 keys, Q and dO staged whole with the
//     statistics. It computes S^T = K Q^T, so that A^T and dL^T land in
//     accumulator fragments that are already A-operand fragments for A^T dO
//     and dL^T Q, and recomputes A from the statistics with 3a's
//     operations in 3a's order (K Q^T gives q k^T's bits on the card). Two
//     passes over the queries: dV = A^T dO; then dA^T = V dO^T, dL^T and
//     dK = dL^T Q * s (a pass each keeps one [16, hd] float32 accumulator a
//     warp in registers, not two).
//   Neither uses atomics: the same inputs give the same bits every launch.
//   A tile is all Cp rows (C rounded up to 16): one block per (b, h), 13
//   warps at C = 200, where the four staged blocks take 221 KB at
//   hd = 128. Past 13 warps (C > 208), or past the shared memory, the rows
//   split into even tiles.
//
// Bound of kernel 3 at the training shape, the Pallas kernel's work: five
// products of 2 C^2 hd per (b, h), 31.5 GFLOP each. On bf16 the tensor
// cores take q k^T and do v^T (two bf16 inputs) and A^T do, dL k, dL^T q
// as three bf16 terms each: 11 products at 989 TFLOP/s, 0.35 ms, against
// 1.10 GB at 3.35 TB/s, 0.33 ms: bound by operations. The split recomputes:
// 3a takes q k^T three times and do v^T twice, 3b K Q^T twice and V dO^T
// once, so 8 bf16 products and 9 term products in all (0.54 ms at the
// peak). With the float32 weights at the 67 TFLOP/s float32 peak, as the
// CUDA-core design was priced: 1.47 ms.
//
// Float32 inputs run on the CUDA cores (float32 FMA): `mha_fwd_kernel` and
// kernel 3's `mha_bwd_dq_kernel` (3a) and `mha_bwd_dkv_kernel` (3b). The
// Pallas kernels keep a whole (b, h) block, q, k, v, o and the float32
// [C, C] logits, in ~16 MB of VMEM. A Hopper block has 227 KB of shared
// memory and the [200, 200] float32 logits alone take 160 KB, so these
// kernels tile over rows and keep each row's logits in registers:
//
//   - `mha_fwd_kernel` and 3a run one block per (b, h, tile of 64 query
//     rows), the tiles of one (b, h) next to each other in the grid so that
//     they find its K and V in L2. K and V are staged in shared memory
//     (2 x 104 KB at C = 200, hd = 128). A warp carries 4 query rows at
//     once; a lane owns the keys j = lane + 32 t, so a row's logits, max,
//     exp and sum live in registers and warp shuffles. A row's q (and do)
//     comes from device memory, one broadcast load per pair of columns. For
//     the A v product the roles turn: a lane owns pairs of output columns
//     and the row's weights are broadcast by shuffle, key by key.
//   - 3a recomputes the logits and the softmax as kernel 2 does, then
//     dA_ij = do_i . v_j, delta_i = sum_j A_ij dA_ij and dq, and writes the
//     row statistics to the scratch.
//   - 3b runs one block per (b, h, tile of 64 key rows) with Q and dO
//     staged, recomputes A_ij = exp(L_ij - m_i) / l_i from the statistics
//     with the same operations in the same order as 3a (so the same bits),
//     and sums dV_j and dK_j over the queries, without atomics.
//   - staged rows are padded by two elements: a row stride of hd + 2 elements
//     puts the 32 lanes' reads of 32 rows at one column on distinct banks
//     (2 or 18 mod 32 words for 8-byte reads). At a 256-byte stride each
//     such read is a 32-way bank conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;             // rows a warp carries at once
constexpr int kTile = 64;            // rows of a block: queries (2, 3a), keys (3b)
constexpr int kMaxC = 256;
constexpr int kKT = kMaxC / 32;      // keys (or queries) a lane owns
constexpr int kMaxHd = 128;
constexpr int kPairs = kMaxHd / 64;  // output column pairs a lane owns
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 widen2(float2 v) { return v; }
__device__ __forceinline__ float2 widen2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// the two elements at p (an even column), widened to float32
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return widen2(*reinterpret_cast<const typename Pair<T>::type*>(p));
}
template <typename T>
__device__ __forceinline__ float2 ldg2(const T* p) {
  return widen2(__ldg(reinterpret_cast<const typename Pair<T>::type*>(p)));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// rows [0, C) of a [C, hd] block into shared memory at a stride of hd + 2
template <typename T>
__device__ void stage(T* dst, const T* __restrict__ src, int C, int hd) {
  using P = typename Pair<T>::type;
  const int pairs = hd >> 1;
  for (int idx = threadIdx.x; idx < C * pairs; idx += blockDim.x) {
    const int row = idx / pairs;
    const int pr = idx - row * pairs;
    *reinterpret_cast<P*>(dst + row * (hd + 2) + 2 * pr) =
        __ldg(reinterpret_cast<const P*>(src + row * hd + 2 * pr));
  }
}

// acc[r][t] = rows[r] . staged[lane + 32 t] over the hd columns, summed in
// column order; rows live in device memory (one broadcast load per pair),
// `staged` in shared memory. Lanes past C read row C - 1 (not used).
template <typename T, int R>
__device__ __forceinline__ void row_dots(float (&acc)[R][kKT], const T* const (&rows)[R],
                                         const T* staged, int hd, int C, int nt, int lane) {
  const int P = hd + 2;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < kKT; ++t) acc[r][t] = 0.f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 2) {
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = ldg2(rows[r] + d);
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
      if (t < nt) {
        const int j = min(lane + 32 * t, C - 1);
        const float2 b = load2(staged + j * P + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][t] = fmaf(a[r].x, b.x, acc[r][t]);
          acc[r][t] = fmaf(a[r].y, b.y, acc[r][t]);
        }
      }
    }
  }
}

// the logit of dot product x: x * s + mask, rounded twice as the Pallas
// kernel's separate multiply and add (no contraction into an FMA)
__device__ __forceinline__ float logit(float x, float scale, float mask) {
  return __fadd_rn(__fmul_rn(x, scale), mask);
}

// dot products -> softmax weights by row, in place; m and l get each row's
// max logit and sum of exp. Keys past C get weight 0.
template <int R>
__device__ __forceinline__ void softmax_rows(float (&acc)[R][kKT], const float (&mask)[kKT],
                                             float scale, int C, int nt, int lane,
                                             float (&m)[R], float (&l)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
      if (t < nt) {
        const float x = lane + 32 * t < C ? logit(acc[r][t], scale, mask[t]) : -INFINITY;
        acc[r][t] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
      if (t < nt) {
        const float e = expf(acc[r][t] - mx);  // 0 past C
        acc[r][t] = e;
        sum += e;
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kKT; ++t)
      if (t < nt) acc[r][t] = __fdiv_rn(acc[r][t], sum);
    m[r] = mx;
    l[r] = sum;
  }
}

// out[r][s] = sum_j w[r][j] * staged[j][this lane's column pair s], where
// w[r][j] sits in lane j % 32 as w[r][j / 32]; the weights are broadcast by
// shuffle, one row j at a time
template <typename T, int R>
__device__ __forceinline__ void weighted_rows(float2 (&out)[R][kPairs], const float (&w)[R][kKT],
                                              const T* staged, int hd, int C, int nt,
                                              int lane) {
  const int P = hd + 2;
  const int npairs = hd >> 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < kPairs; ++s) out[r][s] = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < kKT; ++t) {
    if (t < nt) {
      const int jn = min(32, C - 32 * t);
#pragma unroll 2
      for (int jj = 0; jj < jn; ++jj) {
        const int j = 32 * t + jj;
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) p[r] = __shfl_sync(kFull, w[r][t], jj);
#pragma unroll
        for (int s = 0; s < kPairs; ++s) {
          const int pi = lane + 32 * s;
          if (pi < npairs) {
            const float2 b = load2(staged + j * P + 2 * pi);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              out[r][s].x = fmaf(p[r], b.x, out[r][s].x);
              out[r][s].y = fmaf(p[r], b.y, out[r][s].y);
            }
          }
        }
      }
    }
  }
}

// row i's output pairs, times `scale`, in T (rows past C are not stored)
template <typename T, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float2 (&out)[R][kPairs],
                                           int i0, int C, int hd, int lane, float scale) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i >= C) continue;
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      const int pi = lane + 32 * s;
      if (pi < (hd >> 1))
        store2(dst + static_cast<long long>(i) * hd + 2 * pi,
               make_float2(out[r][s].x * scale, out[r][s].y * scale));
    }
  }
}

template <typename T, int R>
__device__ __forceinline__ void row_pointers(const T* (&rows)[R], const T* base, int i0, int C,
                                             int hd) {
#pragma unroll
  for (int r = 0; r < R; ++r) rows[r] = base + static_cast<long long>(min(i0 + r, C - 1)) * hd;
}

// kernel 2: o for one (b, h) and one tile of query rows
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ log_mask, T* __restrict__ o, int H, int C, int hd,
               float scale, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + C * (hd + 2);
  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const long long base = static_cast<long long>(bh) * C * hd;
  stage(k_s, k + base, C, hd);
  stage(v_s, v + base, C, hd);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (C + 31) >> 5;
  float mask[kKT];
#pragma unroll
  for (int t = 0; t < kKT; ++t)
    mask[t] = __ldg(log_mask + static_cast<long long>(b) * C + min(lane + 32 * t, C - 1));
  __syncthreads();

  const int rows = min(kTile, C - row0);
  for (int g = warp * R; g < rows; g += kWarps * R) {
    const int i0 = row0 + g;
    const T* qr[R];
    row_pointers<T, R>(qr, q + base, i0, C, hd);
    float a[R][kKT], m[R], l[R];
    row_dots<T, R>(a, qr, k_s, hd, C, nt, lane);
    softmax_rows<R>(a, mask, scale, C, nt, lane, m, l);
    float2 out[R][kPairs];
    weighted_rows<T, R>(out, a, v_s, hd, C, nt, lane);
    store_rows<T, R>(o + base, out, i0, C, hd, lane, 1.f);
  }
}

// ---- bf16 on the tensor cores: kernel 2 (mha_fwd_tc_kernel) and kernel 3
// (mha_bwd_dq_tc_kernel, mha_bwd_dkv_tc_kernel) ----

constexpr int kTcPad = 8;  // staged row stride hd + 8 elements
constexpr int kTcThreads = 32 * (kMaxC / 16);  // one warp per 16 rows of C <= 256
constexpr int kTerms = 3;  // bf16 terms of each float32 softmax weight (and dL)
constexpr int kBwdTcRows = 208;  // own rows of a kernel-3 block: at most 13 warps
constexpr int kBwdTcThreads = 2 * kBwdTcRows;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + n) of a [C, HD] bf16 block into shared memory at a row
// stride of HD + 8 elements, in 16-byte cp.async copies (not committed);
// rows past C are zeros
template <int HD>
__device__ __forceinline__ void tc_stage(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                         int row0, int n, int C) {
  constexpr int P = HD + kTcPad;
  constexpr int PIECES = HD / 8;  // 16-byte pieces of a row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < n * PIECES; idx += blockDim.x) {
    const int row = idx / PIECES;
    const int col = (idx - row * PIECES) * 8;
    __nv_bfloat16* d = dst + row * P + col;
    if (row0 + row < C)
      cp_async16(d, src + static_cast<long long>(row0 + row) * HD + col);
    else
      *reinterpret_cast<uint4*>(d) = zero;
  }
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and gets, of each matrix, row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 (transposed: rows and columns swap)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The ldmatrix addresses of a staged block `s` (row stride P), by lane:
// rows r0 .. r0 + 15 as the A operand (rows r0 + lane % 16, columns
// 8 (lane / 16)); rows as the B operand of a product with the rows' dot
// products (16 rows, lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2));
// rows as the B operand of a product over the rows, transposed (rows
// lane % 16, columns 8 (lane / 16)). Offset by j0 * P for rows j0 ...
__device__ __forceinline__ const __nv_bfloat16* a_rows(const __nv_bfloat16* s, int P, int r0,
                                                      int lane) {
  return s + (r0 + (lane & 15)) * P + (lane >> 4) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* b_dots(const __nv_bfloat16* s, int P, int lane) {
  return s + ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* b_sum(const __nv_bfloat16* s, int P, int lane) {
  return s + (lane & 15) * P + (lane >> 4) * 8;
}

// d += a b: a 16 x 16 bf16 (row-major fragments), b 16 x 8 bf16 (column-
// major), d 16 x 8 float32. Lane l holds d's rows l / 4 (d[0], d[1]) and
// l / 4 + 8 (d[2], d[3]) at columns 2 (l % 4) and 2 (l % 4) + 1. The
// tensor cores' float32 sum is not an IEEE one: measured against float32,
// an accumulator carried through many mma loses about an ulp of itself
// toward zero at each (PERF.md).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the float32 values (x, y) of two neighbouring columns as kTerms bf16
// pairs into register `slot` of each term's A fragment: term t is bf16 of
// what the terms before it left (each remainder is exact in float32; three
// terms hold all 24 bits of a float32 value)
__device__ __forceinline__ void split_terms(float x, float y, unsigned (&w)[kTerms][4],
                                            int slot) {
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
    w[t][slot] = pack_bf16(hx, hy);
    x = __fsub_rn(x, __bfloat162float(hx));
    y = __fsub_rn(y, __bfloat162float(hy));
  }
}

// a float32 16 x 16 tile held as the accumulator fragments of its two
// 8-column halves (x[0], x[1]) -> the A fragments of its kTerms bf16 terms
// (the accumulator and A layouts agree: rows g / g + 8, columns 2 (lane % 4)
// (+ 8))
__device__ __forceinline__ void split_tile(const float (&x)[2][4], unsigned (&w)[kTerms][4]) {
  split_terms(x[0][0], x[0][1], w, 0);
  split_terms(x[0][2], x[0][3], w, 1);
  split_terms(x[1][0], x[1][1], w, 2);
  split_terms(x[1][2], x[1][3], w, 3);
}

// d += the products in `part`, a fresh accumulator: each of its values is
// added to d with one IEEE float32 add
__device__ __forceinline__ void add_part(float (&d)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], part[e]);
}

// the dot products of this warp's 16 rows (A-operand address `ra`) with
// rows j0 .. j0 + 15 of a staged block (B-operand address `rb`, b_dots):
// x[n][0..1] row g, x[n][2..3] row g + 8, columns j0 + 8 n + 2 (lane % 4)
// + {0, 1}; the 16 columns of each k-step go to a fresh accumulator
template <int HD>
__device__ __forceinline__ void tc_dots(float (&x)[2][4], const __nv_bfloat16* ra,
                                        const __nv_bfloat16* rb, int j0) {
  constexpr int P = HD + kTcPad;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    unsigned a[4], b[4];
    ldmatrix_x4(a, ra + ks * 16);
    ldmatrix_x4(b, rb + j0 * P + ks * 16);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(t0, a, b[0], b[1]);
    mma_bf16(t1, a, b[2], b[3]);
    add_part(x[0], t0);
    add_part(x[1], t1);
  }
}

// the logits of this warp's 16 query rows against keys j0 .. j0 + 15
// (layout as tc_dots), each key's mask from mask_s
template <int HD>
__device__ __forceinline__ void tc_logits(float (&x)[2][4], const __nv_bfloat16* qa,
                                          const __nv_bfloat16* kb, const float* mask_s,
                                          int j0, int t4, float scale) {
  tc_dots<HD>(x, qa, kb, j0);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float2 mk = *reinterpret_cast<const float2*>(mask_s + j0 + 8 * n + 2 * t4);
    x[n][0] = logit(x[n][0], scale, mk.x);
    x[n][1] = logit(x[n][1], scale, mk.y);
    x[n][2] = logit(x[n][2], scale, mk.x);
    x[n][3] = logit(x[n][3], scale, mk.y);
  }
}

// acc (HD / 8 tiles of 8 columns) += the 16 x 16 tile w (kTerms A
// fragments) times 16 staged rows (B-operand address `bt` of the first,
// b_sum): each 8-column tile takes the terms smallest first in a fresh
// accumulator, then one IEEE add, so a chunk's sum is truncated at most at
// the size of the chunk's own contribution
template <int HD>
__device__ __forceinline__ void tc_accumulate(float (&acc)[HD / 8][4],
                                              const unsigned (&w)[kTerms][4],
                                              const __nv_bfloat16* bt) {
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    unsigned bv[4];
    ldmatrix_x4_trans(bv, bt + np * 16);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = kTerms - 1; t >= 0; --t) {
      mma_bf16(t0, w[t], bv[0], bv[1]);
      mma_bf16(t1, w[t], bv[2], bv[3]);
    }
    add_part(acc[2 * np], t0);
    add_part(acc[2 * np + 1], t1);
  }
}

// the max / sum over the four lanes of a quad (one row's columns)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// the exact maxima of the logits of this warp's rows g (m0) and g + 8 (m1)
// over the Cp keys
template <int HD>
__device__ __forceinline__ void tc_row_max(float& m0, float& m1, const __nv_bfloat16* qa,
                                           const __nv_bfloat16* kb, const float* mask_s,
                                           int Cp, int t4, float scale) {
  m0 = -INFINITY;
  m1 = -INFINITY;
#pragma unroll 2
  for (int j0 = 0; j0 < Cp; j0 += 16) {
    float x[2][4];
    tc_logits<HD>(x, qa, kb, mask_s, j0, t4, scale);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      m0 = fmaxf(m0, fmaxf(x[n][0], x[n][1]));
      m1 = fmaxf(m1, fmaxf(x[n][2], x[n][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// rows r0 (acc[n][0..1]) and r1 (acc[n][2..3]) of a [C, HD] output, each
// value times `scale` (one IEEE multiply; none at 1), in bf16; rows past C
// are not stored
template <int HD>
__device__ __forceinline__ void tc_store(__nv_bfloat16* __restrict__ dst,
                                         const float (&acc)[HD / 8][4], int r0, int r1, int C,
                                         int t4, float scale) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r0 < C)
      store2(dst + static_cast<long long>(r0) * HD + col,
             make_float2(__fmul_rn(acc[n][0], scale), __fmul_rn(acc[n][1], scale)));
    if (r1 < C)
      store2(dst + static_cast<long long>(r1) * HD + col,
             make_float2(__fmul_rn(acc[n][2], scale), __fmul_rn(acc[n][3], scale)));
  }
}

// kernel 2 on bf16: o for one (b, h); blockDim.x = 32 * ceil(C / 16)
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
mha_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ log_mask,
                  __nv_bfloat16* __restrict__ o, int H, int C, float scale) {
  constexpr int P = HD + kTcPad;
  constexpr int NT = HD / 8;  // 8-column tiles of o
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + Cp * P;
  __nv_bfloat16* v_s = k_s + Cp * P;
  float* mask_s = reinterpret_cast<float*>(v_s + Cp * P);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const long long base = static_cast<long long>(bh) * C * HD;

  // stage Q and K (group 0), then V (group 1); rows past C are zeros
  tc_stage<HD>(q_s, q + base, 0, Cp, C);
  tc_stage<HD>(k_s, k + base, 0, Cp, C);
  cp_async_commit();
  tc_stage<HD>(v_s, v + base, 0, Cp, C);
  cp_async_commit();
  for (int j = threadIdx.x; j < Cp; j += blockDim.x)
    mask_s[j] = j < C ? __ldg(log_mask + static_cast<long long>(b) * C + j) : -INFINITY;
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* qa = a_rows(q_s, P, row0, lane);
  const __nv_bfloat16* kb = b_dots(k_s, P, lane);
  const __nv_bfloat16* vb = b_sum(v_s, P, lane);

  // pass 1: the exact row maxima (rows g and g + 8 of the warp's tile)
  float m0, m1;
  tc_row_max<HD>(m0, m1, qa, kb, mask_s, Cp, t4, scale);

  cp_async_wait<0>();
  __syncthreads();

  // pass 2: e = exp(L - m), the row sums, o += e v term by term
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j0 = 0; j0 < Cp; j0 += 16) {
    float x[2][4];
    tc_logits<HD>(x, qa, kb, mask_s, j0, t4, scale);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      x[n][0] = expf(x[n][0] - m0);  // 0 past C
      x[n][1] = expf(x[n][1] - m0);
      x[n][2] = expf(x[n][2] - m1);
      x[n][3] = expf(x[n][3] - m1);
      l0 += x[n][0];
      l0 += x[n][1];
      l1 += x[n][2];
      l1 += x[n][3];
    }
    unsigned w[kTerms][4];
    split_tile(x, w);
    tc_accumulate<HD>(acc, w, vb + j0 * P);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // o = acc / l in bf16; rows past C are not stored
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r0 < C)
      store2(o + base + static_cast<long long>(r0) * HD + col,
             make_float2(__fdiv_rn(acc[n][0], l0), __fdiv_rn(acc[n][1], l0)));
    if (r1 < C)
      store2(o + base + static_cast<long long>(r1) * HD + col,
             make_float2(__fdiv_rn(acc[n][2], l1), __fdiv_rn(acc[n][3], l1)));
  }
}

// kernel 3a: dq and the row statistics for one (b, h) and one tile of query
// rows
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ log_mask, const T* __restrict__ dout,
                  T* __restrict__ dq, float* __restrict__ stats, int H, int C, int hd,
                  float scale, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + C * (hd + 2);
  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const long long base = static_cast<long long>(bh) * C * hd;
  stage(k_s, k + base, C, hd);
  stage(v_s, v + base, C, hd);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (C + 31) >> 5;
  float mask[kKT];
#pragma unroll
  for (int t = 0; t < kKT; ++t)
    mask[t] = __ldg(log_mask + static_cast<long long>(b) * C + min(lane + 32 * t, C - 1));
  __syncthreads();

  const int rows = min(kTile, C - row0);
  for (int g = warp * R; g < rows; g += kWarps * R) {
    const int i0 = row0 + g;
    const T* qr[R];
    const T* dr[R];
    row_pointers<T, R>(qr, q + base, i0, C, hd);
    row_pointers<T, R>(dr, dout + base, i0, C, hd);
    float a[R][kKT], da[R][kKT], m[R], l[R], delta[R];
    row_dots<T, R>(a, qr, k_s, hd, C, nt, lane);
    softmax_rows<R>(a, mask, scale, C, nt, lane, m, l);
    row_dots<T, R>(da, dr, v_s, hd, C, nt, lane);  // dA_ij = do_i . v_j
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kKT; ++t)
        if (t < nt) part += da[r][t] * a[r][t];
      delta[r] = warp_sum(part);
#pragma unroll
      for (int t = 0; t < kKT; ++t)
        if (t < nt) da[r][t] = a[r][t] * (da[r][t] - delta[r]);  // dL_ij
    }
    float2 out[R][kPairs];
    weighted_rows<T, R>(out, da, k_s, hd, C, nt, lane);
    store_rows<T, R>(dq + base, out, i0, C, hd, lane, scale);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < C) {
          float* st = stats + (static_cast<long long>(bh) * C + i0 + r) * 3;
          st[0] = m[r];
          st[1] = l[r];
          st[2] = delta[r];
        }
      }
    }
  }
}

// kernel 3b: dk and dv for one (b, h) and one tile of key rows
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ log_mask, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                   int H, int C, int hd, float scale, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + C * (hd + 2);
  // the queries' statistics (in shared memory: in registers they spill)
  float* m_s = reinterpret_cast<float*>(do_s + C * (hd + 2));
  float* l_s = m_s + C;
  float* d_s = l_s + C;
  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const long long base = static_cast<long long>(bh) * C * hd;
  stage(q_s, q + base, C, hd);
  stage(do_s, dout + base, C, hd);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float* st = stats + (static_cast<long long>(bh) * C + i) * 3;
    m_s[i] = __ldg(st);
    l_s[i] = __ldg(st + 1);
    d_s[i] = __ldg(st + 2);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (C + 31) >> 5;
  __syncthreads();

  const int rows = min(kTile, C - row0);
  for (int g = warp * R; g < rows; g += kWarps * R) {
    const int j0 = row0 + g;
    const T* kr[R];
    const T* vr[R];
    row_pointers<T, R>(kr, k + base, j0, C, hd);
    row_pointers<T, R>(vr, v + base, j0, C, hd);
    float mask_j[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      mask_j[r] = __ldg(log_mask + static_cast<long long>(b) * C + min(j0 + r, C - 1));
    float a[R][kKT], ds[R][kKT];
    row_dots<T, R>(a, kr, q_s, hd, C, nt, lane);   // k_j . q_i
    row_dots<T, R>(ds, vr, do_s, hd, C, nt, lane); // v_j . do_i = dA_ij
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int t = 0; t < kKT; ++t) {
        if (t < nt) {
          const int i = min(lane + 32 * t, C - 1);
          const float x = logit(a[r][t], scale, mask_j[r]);
          const float p = lane + 32 * t < C ? __fdiv_rn(expf(x - m_s[i]), l_s[i]) : 0.f;
          a[r][t] = p;
          ds[r][t] = p * (ds[r][t] - d_s[i]);  // dL_ij
        }
      }
    }
    float2 out[R][kPairs];
    weighted_rows<T, R>(out, a, do_s, hd, C, nt, lane);  // dV_j = sum_i A_ij do_i
    store_rows<T, R>(dv + base, out, j0, C, hd, lane, 1.f);
    weighted_rows<T, R>(out, ds, q_s, hd, C, nt, lane);  // sum_i dL_ij q_i
    store_rows<T, R>(dk + base, out, j0, C, hd, lane, scale);
  }
}


// softmax weights of this warp's rows g (m0, r0 = 1 / l0) and g + 8 (m1,
// r1) from their logits, in place: exp(L - m) times the rounded reciprocal
// of l (an IEEE division an element took a third of the kernel's time)
__device__ __forceinline__ void tc_weights(float (&x)[2][4], float m0, float m1, float r0,
                                           float r1) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    x[n][0] = __fmul_rn(expf(x[n][0] - m0), r0);
    x[n][1] = __fmul_rn(expf(x[n][1] - m0), r0);
    x[n][2] = __fmul_rn(expf(x[n][2] - m1), r1);
    x[n][3] = __fmul_rn(expf(x[n][3] - m1), r1);
  }
}

// kernel 3a on bf16: dq and the row statistics for one (b, h) and one tile
// of T query rows; blockDim.x = 32 * T / 16
template <int HD>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
mha_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ log_mask,
                     const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                     float* __restrict__ stats, int H, int C, float scale, int T, int tiles) {
  constexpr int P = HD + kTcPad;
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + Cp * P;
  __nv_bfloat16* q_s = v_s + Cp * P;  // the tile's query rows
  __nv_bfloat16* do_s = q_s + T * P;
  float* mask_s = reinterpret_cast<float*>(do_s + T * P);
  const int bh = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x - bh * tiles) * T;
  const int b = bh / H;
  const long long base = static_cast<long long>(bh) * C * HD;

  // Q's tile and K (group 0: pass 1), dO's tile and V (group 1)
  tc_stage<HD>(q_s, q + base, tile0, T, C);
  tc_stage<HD>(k_s, k + base, 0, Cp, C);
  cp_async_commit();
  tc_stage<HD>(do_s, dout + base, tile0, T, C);
  tc_stage<HD>(v_s, v + base, 0, Cp, C);
  cp_async_commit();
  for (int j = threadIdx.x; j < Cp; j += blockDim.x)
    mask_s[j] = j < C ? __ldg(log_mask + static_cast<long long>(b) * C + j) : -INFINITY;
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* qa = a_rows(q_s, P, row0, lane);
  const __nv_bfloat16* doa = a_rows(do_s, P, row0, lane);
  const __nv_bfloat16* kb = b_dots(k_s, P, lane);
  const __nv_bfloat16* vb = b_dots(v_s, P, lane);
  const __nv_bfloat16* kt = b_sum(k_s, P, lane);

  // pass 1: the exact row maxima
  float m0, m1;
  tc_row_max<HD>(m0, m1, qa, kb, mask_s, Cp, t4, scale);

  cp_async_wait<0>();
  __syncthreads();

  // pass 2: l = sum_j e_j with e = exp(L - m), and delta = rowsum(dA * A)
  // from the float32 weights, as (sum_j e_j dA_j) / l, dA = dO V^T
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  for (int j0 = 0; j0 < Cp; j0 += 16) {
    float x[2][4], da[2][4];
    tc_logits<HD>(x, qa, kb, mask_s, j0, t4, scale);
    tc_dots<HD>(da, doa, vb, j0);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float e0 = expf(x[n][0] - m0), e1 = expf(x[n][1] - m0);  // 0 past C
      const float e2 = expf(x[n][2] - m1), e3 = expf(x[n][3] - m1);
      l0 += e0;
      l0 += e1;
      l1 += e2;
      l1 += e3;
      d0 = __fadd_rn(d0, __fmul_rn(da[n][0], e0));
      d0 = __fadd_rn(d0, __fmul_rn(da[n][1], e1));
      d1 = __fadd_rn(d1, __fmul_rn(da[n][2], e2));
      d1 = __fadd_rn(d1, __fmul_rn(da[n][3], e3));
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  d0 = __fdiv_rn(quad_sum(d0), l0);
  d1 = __fdiv_rn(quad_sum(d1), l1);
  const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);

  // pass 3: dL = A (dA - delta), dq += dL K term by term
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j0 = 0; j0 < Cp; j0 += 16) {
    float x[2][4], da[2][4];
    tc_logits<HD>(x, qa, kb, mask_s, j0, t4, scale);
    tc_dots<HD>(da, doa, vb, j0);
    tc_weights(x, m0, m1, rl0, rl1);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      x[n][0] = __fmul_rn(x[n][0], __fsub_rn(da[n][0], d0));
      x[n][1] = __fmul_rn(x[n][1], __fsub_rn(da[n][1], d0));
      x[n][2] = __fmul_rn(x[n][2], __fsub_rn(da[n][2], d1));
      x[n][3] = __fmul_rn(x[n][3], __fsub_rn(da[n][3], d1));
    }
    unsigned w[kTerms][4];
    split_tile(x, w);
    tc_accumulate<HD>(acc, w, kt + j0 * P);
  }

  const int r0 = tile0 + row0 + g, r1 = r0 + 8;
  tc_store<HD>(dq + base, acc, r0, r1, C, t4, scale);
  if (t4 == 0) {
    const float row_stats[2][3] = {{m0, l0, d0}, {m1, l1, d1}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h ? r1 : r0;
      if (i < C) {
        float* st = stats + (static_cast<long long>(bh) * C + i) * 3;
        st[0] = row_stats[h][0];
        st[1] = row_stats[h][1];
        st[2] = row_stats[h][2];
      }
    }
  }
}

// the transposed softmax weights of this warp's keys (rows g: mask mk0;
// g + 8: mk1) against queries i0 + 8 n + 2 (lane % 4) + {0, 1}, from their
// dot products, in place, with 3a's operations in 3a's order: the logit,
// exp(L - m_i), times r_i = 1 / l_i
__device__ __forceinline__ void tc_weights_t(float (&x)[2][4], const float* m_s,
                                             const float* r_s, int i0, int t4, float mk0,
                                             float mk1, float scale) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int i = i0 + 8 * n + 2 * t4;
    const float2 m = *reinterpret_cast<const float2*>(m_s + i);
    const float2 r = *reinterpret_cast<const float2*>(r_s + i);
    x[n][0] = __fmul_rn(expf(logit(x[n][0], scale, mk0) - m.x), r.x);
    x[n][1] = __fmul_rn(expf(logit(x[n][1], scale, mk0) - m.y), r.y);
    x[n][2] = __fmul_rn(expf(logit(x[n][2], scale, mk1) - m.x), r.x);
    x[n][3] = __fmul_rn(expf(logit(x[n][3], scale, mk1) - m.y), r.y);
  }
}

// kernel 3b on bf16: dk and dv for one (b, h) and one tile of T key rows;
// blockDim.x = 32 * T / 16
template <int HD>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
mha_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ log_mask,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                      int C, float scale, int T, int tiles) {
  constexpr int P = HD + kTcPad;
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + Cp * P;
  __nv_bfloat16* k_s = do_s + Cp * P;  // the tile's key rows
  __nv_bfloat16* v_s = k_s + T * P;
  // the queries' statistics (m, 1 / l as 3a rounds it, delta); past C:
  // m = +inf, 1 / l = 1, delta = 0, so a padded query row's weights and dL
  // are exactly 0
  float* m_s = reinterpret_cast<float*>(v_s + T * P);
  float* r_s = m_s + Cp;
  float* d_s = r_s + Cp;
  const int bh = blockIdx.x / tiles;
  const int tile0 = (blockIdx.x - bh * tiles) * T;
  const int b = bh / H;
  const long long base = static_cast<long long>(bh) * C * HD;

  // K's tile, Q and dO (group 0: dV), V's tile (group 1: dK)
  tc_stage<HD>(k_s, k + base, tile0, T, C);
  tc_stage<HD>(q_s, q + base, 0, Cp, C);
  tc_stage<HD>(do_s, dout + base, 0, Cp, C);
  cp_async_commit();
  tc_stage<HD>(v_s, v + base, tile0, T, C);
  cp_async_commit();
  for (int i = threadIdx.x; i < Cp; i += blockDim.x) {
    float m = INFINITY, r = 1.f, d = 0.f;
    if (i < C) {
      const float* st = stats + (static_cast<long long>(bh) * C + i) * 3;
      m = __ldg(st);
      r = __frcp_rn(__ldg(st + 1));
      d = __ldg(st + 2);
    }
    m_s[i] = m;
    r_s[i] = r;
    d_s[i] = d;
  }
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = tile0 + row0 + g, r1 = r0 + 8;  // this lane's key rows
  const float mk0 = r0 < C ? __ldg(log_mask + static_cast<long long>(b) * C + r0) : -INFINITY;
  const float mk1 = r1 < C ? __ldg(log_mask + static_cast<long long>(b) * C + r1) : -INFINITY;
  const __nv_bfloat16* ka = a_rows(k_s, P, row0, lane);
  const __nv_bfloat16* va = a_rows(v_s, P, row0, lane);
  const __nv_bfloat16* qb = b_dots(q_s, P, lane);
  const __nv_bfloat16* dob = b_dots(do_s, P, lane);
  const __nv_bfloat16* qt = b_sum(q_s, P, lane);
  const __nv_bfloat16* dot = b_sum(do_s, P, lane);

  float acc[NT][4];
  // pass 1: dV = A^T dO term by term, with S^T = K Q^T
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int i0 = 0; i0 < Cp; i0 += 16) {
    float x[2][4];
    tc_dots<HD>(x, ka, qb, i0);
    tc_weights_t(x, m_s, r_s, i0, t4, mk0, mk1, scale);
    unsigned w[kTerms][4];
    split_tile(x, w);
    tc_accumulate<HD>(acc, w, dot + i0 * P);
  }
  tc_store<HD>(dv + base, acc, r0, r1, C, t4, 1.f);

  cp_async_wait<0>();
  __syncthreads();

  // pass 2: dL^T = A^T (dA^T - delta), dA^T = V dO^T; dK = dL^T Q term by
  // term
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int i0 = 0; i0 < Cp; i0 += 16) {
    float x[2][4], da[2][4];
    tc_dots<HD>(x, ka, qb, i0);
    tc_dots<HD>(da, va, dob, i0);
    tc_weights_t(x, m_s, r_s, i0, t4, mk0, mk1, scale);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(d_s + i0 + 8 * n + 2 * t4);
      x[n][0] = __fmul_rn(x[n][0], __fsub_rn(da[n][0], d.x));
      x[n][1] = __fmul_rn(x[n][1], __fsub_rn(da[n][1], d.y));
      x[n][2] = __fmul_rn(x[n][2], __fsub_rn(da[n][2], d.x));
      x[n][3] = __fmul_rn(x[n][3], __fsub_rn(da[n][3], d.y));
    }
    unsigned w[kTerms][4];
    split_tile(x, w);
    tc_accumulate<HD>(acc, w, qt + i0 * P);
  }
  tc_store<HD>(dk + base, acc, r0, r1, C, t4, scale);
}

// The dynamic shared-memory limit is a per-device attribute of each kernel
// instance. It is raised once per (instance, device) to the most any shape
// takes (above the 48 KB default), so a launch pays no attribute call.
template <typename F>
cudaError_t ensure_smem_limit(F* kernel, std::atomic<bool>* done, int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

// the CUDA-core kernels (float32): two staged [C, hd] blocks, and the three
// per-query statistics of 3b
int smem_bytes(int C, int hd, int elem) { return 2 * C * (hd + 2) * elem + 3 * C * 4; }

// kernel 2 on bf16: staged Q, K and V at C rounded up to 16 rows, and the
// mask
int tc_smem_bytes(int C, int hd) {
  const int cp = (C + 15) & ~15;
  return 3 * cp * (hd + kTcPad) * 2 + cp * 4;
}

// kernel 3 on bf16, a block of T own rows: the other side's two blocks at
// Cp rows, the own side's two at T rows, and 3b's three statistics per
// query (3a's mask takes less)
int bwd_tc_smem_bytes(int cp, int T, int hd) {
  return (2 * cp + 2 * T) * (hd + kTcPad) * 2 + 3 * cp * 4;
}

// the own rows T of a kernel-3 block on bf16: at most kBwdTcRows, within
// the shared memory, the tiles of one (b, h) as even as 16-row steps allow
int bwd_tc_rows(int C, int hd) {
  const int cp = (C + 15) & ~15;
  int t = cp < kBwdTcRows ? cp : kBwdTcRows;
  while (t > 16 && bwd_tc_smem_bytes(cp, t, hd) > kMaxSmem) t -= 16;
  const int tiles = (cp + t - 1) / t;
  return 16 * ((cp / 16 + tiles - 1) / tiles);
}

struct Shape {
  int B, H, C, hd;
  int tiles() const { return (C + kTile - 1) / kTile; }
  int blocks() const { return B * H * tiles(); }
};

// the operands of one launch (dq is o's slot in the backward)
struct Args {
  const void *q, *k, *v, *mask, *dout;
  void *o, *dk, *dv, *stats;
  Shape sh;
  float scale;
  int device;
  cudaStream_t s;
};

template <typename T>
cudaError_t launch_forward(const Args& a) {
  static std::atomic<bool> done[kMaxDevices];
  auto* kernel = mha_fwd_kernel<T, kRows>;
  cudaError_t err = ensure_smem_limit(kernel, done, a.device);
  if (err != cudaSuccess) return err;
  kernel<<<a.sh.blocks(), kThreads, smem_bytes(a.sh.C, a.sh.hd, sizeof(T)), a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.mask), static_cast<T*>(a.o), a.sh.H, a.sh.C, a.sh.hd,
      a.scale, a.sh.tiles());
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const Args& a) {
  static std::atomic<bool> done_dq[kMaxDevices];
  static std::atomic<bool> done_dkv[kMaxDevices];
  auto* dq_kernel = mha_bwd_dq_kernel<T, kRows>;
  auto* dkv_kernel = mha_bwd_dkv_kernel<T, kRows>;
  cudaError_t err = ensure_smem_limit(dq_kernel, done_dq, a.device);
  if (err == cudaSuccess) err = ensure_smem_limit(dkv_kernel, done_dkv, a.device);
  if (err != cudaSuccess) return err;
  const Shape sh = a.sh;
  const int smem = smem_bytes(sh.C, sh.hd, sizeof(T));
  dq_kernel<<<sh.blocks(), kThreads, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.mask), static_cast<const T*>(a.dout), static_cast<T*>(a.o),
      static_cast<float*>(a.stats), sh.H, sh.C, sh.hd, a.scale, sh.tiles());
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<sh.blocks(), kThreads, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.stats), static_cast<T*>(a.dk), static_cast<T*>(a.dv), sh.H,
      sh.C, sh.hd, a.scale, sh.tiles());
  return cudaGetLastError();
}

using bf16_t = __nv_bfloat16;

template <int HD>
cudaError_t launch_forward_tc(const Args& a) {
  static std::atomic<bool> done[kMaxDevices];
  auto* kernel = mha_fwd_tc_kernel<HD>;
  cudaError_t err = ensure_smem_limit(kernel, done, a.device);
  if (err != cudaSuccess) return err;
  const Shape sh = a.sh;
  kernel<<<sh.B * sh.H, 32 * ((sh.C + 15) / 16), tc_smem_bytes(sh.C, HD), a.s>>>(
      static_cast<const bf16_t*>(a.q), static_cast<const bf16_t*>(a.k),
      static_cast<const bf16_t*>(a.v), static_cast<const float*>(a.mask),
      static_cast<bf16_t*>(a.o), sh.H, sh.C, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_backward_tc(const Args& a) {
  static std::atomic<bool> done_dq[kMaxDevices];
  static std::atomic<bool> done_dkv[kMaxDevices];
  auto* dq_kernel = mha_bwd_dq_tc_kernel<HD>;
  auto* dkv_kernel = mha_bwd_dkv_tc_kernel<HD>;
  cudaError_t err = ensure_smem_limit(dq_kernel, done_dq, a.device);
  if (err == cudaSuccess) err = ensure_smem_limit(dkv_kernel, done_dkv, a.device);
  if (err != cudaSuccess) return err;
  const Shape sh = a.sh;
  const int cp = (sh.C + 15) & ~15;
  const int rows = bwd_tc_rows(sh.C, HD);
  const int tiles = (cp + rows - 1) / rows;
  const int smem = bwd_tc_smem_bytes(cp, rows, HD);
  const int blocks = sh.B * sh.H * tiles;
  const int threads = 32 * (rows / 16);
  dq_kernel<<<blocks, threads, smem, a.s>>>(
      static_cast<const bf16_t*>(a.q), static_cast<const bf16_t*>(a.k),
      static_cast<const bf16_t*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const bf16_t*>(a.dout), static_cast<bf16_t*>(a.o),
      static_cast<float*>(a.stats), sh.H, sh.C, a.scale, rows, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<blocks, threads, smem, a.s>>>(
      static_cast<const bf16_t*>(a.q), static_cast<const bf16_t*>(a.k),
      static_cast<const bf16_t*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const bf16_t*>(a.dout), static_cast<const float*>(a.stats),
      static_cast<bf16_t*>(a.dk), static_cast<bf16_t*>(a.dv), sh.H, sh.C, a.scale, rows,
      tiles);
  return cudaGetLastError();
}

// bf16: kernel 2 or 3 on the tensor cores, instantiated for each hd
template <int HD>
cudaError_t launch_tc_hd(const Args& a, bool backward) {
  return backward ? launch_backward_tc<HD>(a) : launch_forward_tc<HD>(a);
}

cudaError_t launch_tc(const Args& a, bool backward) {
  switch (a.sh.hd) {
    case 16: return launch_tc_hd<16>(a, backward);
    case 32: return launch_tc_hd<32>(a, backward);
    case 48: return launch_tc_hd<48>(a, backward);
    case 64: return launch_tc_hd<64>(a, backward);
    case 80: return launch_tc_hd<80>(a, backward);
    case 96: return launch_tc_hd<96>(a, backward);
    case 112: return launch_tc_hd<112>(a, backward);
    case 128: return launch_tc_hd<128>(a, backward);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 runs the tensor-core kernels, which take every C <= 256 and hd <= 128
// (kernel 3 tiles its own rows to fit); float32 the CUDA-core kernels,
// within the shared memory
cudaError_t check_shape(Shape sh, int elem) {
  if (sh.B <= 0 || sh.H <= 0 || sh.C <= 0 || sh.C > kMaxC || sh.hd < 16 ||
      sh.hd > kMaxHd || sh.hd % 16 != 0 ||
      static_cast<long long>(sh.B) * sh.H * sh.tiles() > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (elem == 4) return smem_bytes(sh.C, sh.hd, elem) > kMaxSmem ? cudaErrorInvalidValue
                                                                 : cudaSuccess;
  const int cp = (sh.C + 15) & ~15;
  return tc_smem_bytes(sh.C, sh.hd) > kMaxSmem ||
                 bwd_tc_smem_bytes(cp, bwd_tc_rows(sh.C, sh.hd), sh.hd) > kMaxSmem
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

// Runs `fn` with `device` current, and leaves the calling thread's current
// device as it was.
template <typename Fn>
int on_device(int device, Fn fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  err = fn();
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, o: [B, H, C, hd] float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// log_mask: [B, C] float32; scale: 1 / sqrt(hd) in float32. All contiguous,
// 16-byte aligned, on `device`; C <= 256, hd a multiple of 16 up to 128.
// Launches kernel 2 on `stream` without synchronising (bf16:
// mha_fwd_tc_kernel on the tensor cores; float32: mha_fwd_kernel); returns
// the CUDA error code of the launch (0 on success).
extern "C" int xf_attention_forward(const void* q, const void* k, const void* v,
                                    const void* log_mask, void* o, int bf16, int B, int H,
                                    int C, int hd, float scale, int device, void* stream) {
  const Args a{q, k, v, log_mask, nullptr, o, nullptr, nullptr, nullptr,
               Shape{B, H, C, hd}, scale, device, static_cast<cudaStream_t>(stream)};
  if (check_shape(a.sh, bf16 ? 2 : 4) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] { return bf16 ? launch_tc(a, false) : launch_forward<float>(a); });
}

// As the forward, with dout, dq, dk, dv like q and `stats` a [B, H, C, 3]
// float32 scratch: launches kernel 3a (dq and the statistics), then kernel
// 3b (dk and dv), on `stream` (bf16: mha_bwd_dq_tc_kernel and
// mha_bwd_dkv_tc_kernel on the tensor cores; float32: mha_bwd_dq_kernel and
// mha_bwd_dkv_kernel).
extern "C" int xf_attention_backward(const void* q, const void* k, const void* v,
                                     const void* log_mask, const void* dout, void* dq,
                                     void* dk, void* dv, void* stats, int bf16, int B, int H,
                                     int C, int hd, float scale, int device, void* stream) {
  const Args a{q, k, v, log_mask, dout, dq, dk, dv, stats,
               Shape{B, H, C, hd}, scale, device, static_cast<cudaStream_t>(stream)};
  if (check_shape(a.sh, bf16 ? 2 : 4) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] { return bf16 ? launch_tc(a, true) : launch_backward<float>(a); });
}

// The bf16 terms each float32 operand of a tensor-core product is split
// into: the softmax weights of mha_fwd_tc_kernel's A v, the weights and dL
// of the bf16 kernel 3's A^T dO, dL K and dL^T Q (one product per term).
extern "C" int xf_attention_tc_terms() { return kTerms; }

extern "C" const char* xf_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
