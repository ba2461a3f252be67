// Fused masked attention pool of the code2vec bag encoder, for Hopper.
//
// Replaces the Pallas TPU kernel `_attention_kernel`, launched from
// `attention_pool_pallas` in ops/pallas_attention.py of the JAX package.
// For each method b it computes
//
//     transformed[c, :] = tanh(ctx[b, c, :] @ T)            c < C
//     score[c]          = transformed[c, :] . a, or -1e9 where mask[b, c] == 0
//     attn[b, :]        = softmax(score) over C, all zero when no c is valid
//     code[b, :]        = sum_c attn[b, c] * transformed[c, :]
//
// with the Pallas kernel's float32 semantics (bf16 contexts are exact in
// float32, T and a are float32), and never writes the [C, D] `transformed`
// intermediate to device memory: that is the TPU kernel's point, and it is
// kept here. A method with no valid context comes out as attn = 0 and
// code = 0, as in the reference (a softmax over all -1e9 scores would
// otherwise give a uniform average).
//
// bf16 contexts (every launch of the main paths) run on the tensor cores,
// float32 contexts on the CUDA cores; the wrapper picks by dtype.
//
// ---- bf16: `attention_pool_tc_kernel` (warp-level mma.sync m16n8k16) ----
//
// Bound on an H100 SXM at the training shape (B = 1024, C = 200,
// D = 384): the product is 2 B C D^2 = 60.4 GFLOP, against 157 MB of bf16
// contexts (0.047 ms at 3.35 TB/s). The tensor cores take bf16 operands, so
// the float32 T is split into kTerms = 3 bf16 terms, T = T_hi + T_mid + T_lo,
// each the bf16 of what the terms before it left (three hold all 24 bits),
// and each term is one product: 3 x 60.4 GFLOP at 989 TFLOP/s is 0.183 ms.
// The contexts are exact in bf16, so each bf16 x bf16 product is exact in
// float32. The tensor cores' float32 sum truncates (an accumulator carried
// through many mma drifts toward zero by about an ulp of itself at each), so
// every 16-wide k-step takes its terms, smallest first, into a fresh
// accumulator that is added to the running float32 sum with one IEEE add.
//
// Three launches, counted as one call of kernel 1:
//   1. `pool_split_kernel`: T [D, D] float32 -> kTerms bf16 terms in a
//      scratch buffer, laid out as the D / 16 slices of 16 rows that the
//      tiles stage ([D / 16, kTerms, 16, D + 8]; a few microseconds).
//   2. `attention_pool_tc_kernel`: one block per (method, tile of 16 MT
//      contexts): MT = 7 (112 contexts, two tiles a method at C = 200) for
//      D <= 384, MT = 4 above. D / 32 warps; every warp owns all the tile's
//      rows (MT m16 tiles) and 32 output columns (four n8 tiles), 16 MT
//      float32 accumulators a lane. The tile's contexts are staged once in
//      shared memory with 16-byte cp.async copies (m16 tiles past C are
//      neither loaded nor computed; rows of a live one past C are zeros).
//      T's slices stream through a ring of up to kMaxStages slots, each
//      filled by one bulk copy (cp.async.bulk, the TMA engine without a
//      tensor map) that thread 0 starts as soon as every warp is done with
//      the slot, and whose completion an mbarrier reports: no thread spends
//      instructions on the copies. Staged rows have a stride of D + 8
//      elements: 16-byte aligned for ldmatrix, and the 8 rows of one
//      ldmatrix phase on distinct banks. Per k-step a warp reads its MT A
//      fragments (ldmatrix) and its 4 x kTerms B fragments (ldmatrix.trans,
//      shared by the MT m16 tiles) and issues 4 MT kTerms mma, the four n8
//      tiles of one m16 tile interleaved. The epilogue stays on chip: tanh in
//      registers, the row's dot with a summed in the quad and then across
//      the D / 32 warps in a fixed order, the tile's max, exps and sum by
//      warp 0, and the tile's code column, sum_c e_c tanh(..), reduced over
//      the 8 row groups of the warp by shuffles. The tile writes its (max
//      m_t, sum l_t, valid count), its unnormalised code [D] and its rows'
//      raw scores (into attn). B = 1 spreads over two SMs, B = 64 over 128.
//   3. `pool_combine_kernel`, one block per method: M = max_t m_t,
//      L = sum_t l_t exp(m_t - M), code = sum_t code_t exp(m_t - M) / L and
//      attn = exp(score - M) / L, the tiles in order.
// Nothing uses atomics and every sum has a fixed order, so the same inputs
// give the same bits on every launch, whatever the batch size.
//
// What bounds it: the tensor cores' 0.18 ms is not reached. Each tile pays
// a prologue (its contexts from device memory, the ring's first slices), 24
// block barriers (one a k-step, before its slot is refilled) and an
// epilogue that no other tile overlaps (one block an SM: 206 KB of shared
// memory at D = 384), and streams all of T's terms from L2 (864 KB). So the
// taller the tile, the fewer of these a method pays: on an H100, 64-, 80-
// and 112-row tiles took about 0.83, 0.76 and 0.70 ms at B = 1024, and each
// bf16 term 0.1-0.15 ms of it (PERF.md). 112 rows x 384 columns of
// accumulators are 168 KB of the SM's 256 KB of registers: no taller tile
// fits.
//
// Shared memory: 16 MT (D + 8) x 2 bytes of contexts, up to four slices of
// kTerms x 16 x (D + 8) x 2 bytes of T (as many as fit in 226 KB), and the
// warps' score partials: 206 KB at D = 384 (three slices), 221 KB at D = 512
// (three).
//
// ---- float32: `attention_pool_kernel` (float32 FMA on the CUDA cores) ----
//
// The [C, D] x [D, D] product is 2*C*D^2 = 59 MFLOP per method at C = 200,
// D = 384, about 57 us at B = 64 at the 67 TFLOP/s float32 peak, which is
// the arithmetic this kernel does. The design:
//
//   - one block per method, one thread per output column d (blockDim = D);
//   - the contexts are walked in chunks of 32: a chunk is staged in shared
//     memory as float32, each thread computes its column of
//     tanh(chunk @ T) in 32 registers, streaming its column of T from L2;
//   - the chunk's scores are reduced across the block (warp shuffles, then
//     warp 0 over the per-warp partials), and folded into an online
//     softmax: a running max, a running denominator and a running code
//     column rescaled by exp(m_old - m_new);
//   - raw scores go to `attn` during the loop and are normalised in place
//     at the end with the final max and denominator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChunk = 32;         // contexts per chunk: one lane of warp 0 each
constexpr int kMaxThreads = 512;   // D <= 512 keeps acc[] in registers
constexpr float kMaskedScore = -1e9f;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
attention_pool_kernel(const T* __restrict__ ctx, const float* __restrict__ transform,
                      const float* __restrict__ attention,
                      const float* __restrict__ mask, float* __restrict__ code,
                      float* __restrict__ attn, int C, int D) {
  extern __shared__ __align__(16) float smem[];
  const int nwarps = D >> 5;
  float* ctx_s = smem;                      // [kChunk, D] float32 chunk
  float* red_s = ctx_s + kChunk * D;        // [nwarps, kChunk] score partials
  float* w_s = red_s + nwarps * kChunk;     // [kChunk] unnormalised weights
  float* state_s = w_s + kChunk;            // scale; final max, denom, valid

  const int b = blockIdx.x;
  const int d = threadIdx.x;
  const int warp = d >> 5;
  const int lane = d & 31;
  const T* ctx_b = ctx + static_cast<long long>(b) * C * D;
  const float* mask_b = mask + static_cast<long long>(b) * C;
  float* attn_b = attn + static_cast<long long>(b) * C;
  const float a_d = attention[d];

  // online-softmax state: every lane of warp 0 holds the same copy
  float m_run = -INFINITY;
  float denom = 0.f;
  int n_valid = 0;
  float code_acc = 0.f;  // this thread's column of the unnormalised code

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = min(kChunk, C - c0);
    for (int r = 0; r < kChunk; ++r)
      ctx_s[r * D + d] =
          r < n ? widen(ctx_b[static_cast<long long>(c0 + r) * D + d]) : 0.f;
    __syncthreads();

    float acc[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int k = 0; k < D; k += 4) {
      const float t0 = __ldg(transform + static_cast<long long>(k) * D + d);
      const float t1 = __ldg(transform + static_cast<long long>(k + 1) * D + d);
      const float t2 = __ldg(transform + static_cast<long long>(k + 2) * D + d);
      const float t3 = __ldg(transform + static_cast<long long>(k + 3) * D + d);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(ctx_s + r * D + k);
        acc[r] = fmaf(x.x, t0, acc[r]);
        acc[r] = fmaf(x.y, t1, acc[r]);
        acc[r] = fmaf(x.z, t2, acc[r]);
        acc[r] = fmaf(x.w, t3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      acc[r] = tanhf(acc[r]);
      const float p = warp_sum(acc[r] * a_d);
      if (lane == 0) red_s[warp * kChunk + r] = p;
    }
    __syncthreads();

    if (warp == 0) {
      const int r = lane;
      const bool live = r < n;
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red_s[w * kChunk + r];
      const bool valid = live && mask_b[c0 + r] > 0.f;
      if (!valid) s = kMaskedScore;
      if (live) attn_b[c0 + r] = s;  // raw score, normalised after the loop
      const float m_new = fmaxf(m_run, warp_max(live ? s : -INFINITY));
      const float e = live ? expf(s - m_new) : 0.f;
      const float scale = expf(m_run - m_new);  // 0 on the first chunk
      denom = denom * scale + warp_sum(e);
      m_run = m_new;
      n_valid += __popc(__ballot_sync(0xffffffffu, valid));
      w_s[r] = e;
      if (lane == 0) state_s[0] = scale;
    }
    __syncthreads();

    float upd = 0.f;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) upd = fmaf(w_s[r], acc[r], upd);
    code_acc = code_acc * state_s[0] + upd;
  }

  if (d == 0) {
    state_s[1] = m_run;
    state_s[2] = denom;
    state_s[3] = static_cast<float>(n_valid);
  }
  __syncthreads();
  const float m = state_s[1];
  const float den = state_s[2];
  const bool any_valid = state_s[3] > 0.f;
  code[static_cast<long long>(b) * D + d] = any_valid ? code_acc / den : 0.f;
  for (int c = d; c < C; c += D)
    attn_b[c] = any_valid ? expf(attn_b[c] - m) / den : 0.f;
}

constexpr int smem_bytes(int D) {
  return static_cast<int>(sizeof(float)) * (kChunk * D + (D / 32) * kChunk + kChunk + 4);
}

// ---- bf16 on the tensor cores ----

constexpr int kTerms = 3;       // bf16 terms of the float32 T
// m16 tiles (16 contexts each) of a tile: seven up to D = kNarrowMaxD, where
// a 384-thread launch bound leaves 168 registers a thread for the 112
// accumulators (ptxas spills about 100 bytes); four above, under the
// 512-thread bound's 128
constexpr int kNarrowMaxD = 384;
constexpr int kTallMT = 7;
constexpr int kWideMT = 4;
constexpr int kTcCols = 32;     // output columns of a warp: four n8 tiles
constexpr int kTcNTiles = kTcCols / 8;
constexpr int kMaxStages = 4;   // 16-row k-slices of T's terms in the ring
constexpr int kTcPad = 8;       // staged row stride D + 8 elements
// dynamic shared memory a tc block may take: the SM's 227 KB less room for
// the static mbarriers
constexpr int kTcSmemBudget = 227 * 1024 - 1024;
constexpr int kStats = 4;       // per tile: max, sum, valid count, unused
constexpr int kCombineThreads = 256;

// contexts of a tile at width D
constexpr int tc_rows(int D) { return 16 * (D <= kNarrowMaxD ? kTallMT : kWideMT); }

// one 16-row k-slice of T's kTerms terms, as staged: [kTerms, 16, D + 8]
constexpr int tc_slice_bytes(int D) { return 2 * kTerms * 16 * (D + kTcPad); }

// the contexts and the score partials of one tc block
constexpr int tc_fixed_bytes(int D) {
  return 2 * tc_rows(D) * (D + kTcPad) + 4 * ((D / 32) * tc_rows(D) + tc_rows(D));
}

// slices in the ring at width D: as many as fit, at most kMaxStages
constexpr int tc_stages(int D) {
  return (kTcSmemBudget - tc_fixed_bytes(D)) / tc_slice_bytes(D) < kMaxStages
             ? (kTcSmemBudget - tc_fixed_bytes(D)) / tc_slice_bytes(D)
             : kMaxStages;
}

constexpr int tc_smem_bytes(int D) { return tc_fixed_bytes(D) + tc_stages(D) * tc_slice_bytes(D); }

constexpr int tc_tiles(int C, int D) { return (C + tc_rows(D) - 1) / tc_rows(D); }

constexpr long long align256(long long n) { return (n + 255) & ~255LL; }

// the scratch of one tc call: T's terms as D / 16 staged slices, the
// tiles' stats, their codes
constexpr long long tc_terms_bytes(int D) {
  return align256(static_cast<long long>(D / 16) * tc_slice_bytes(D));
}
constexpr long long tc_stats_bytes(int B, int C, int D) {
  return align256(4LL * kStats * B * tc_tiles(C, D));
}
constexpr long long tc_scratch_bytes(int B, int C, int D) {
  return tc_terms_bytes(D) + tc_stats_bytes(B, C, D)
         + align256(4LL * B * tc_tiles(C, D) * D);
}

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

// mbarriers and the bulk-copy engine (TMA without a tensor map): one thread
// arms a barrier with the bytes it expects and starts a copy that completes
// them; every thread waits on the barrier's phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
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

// d = a b (mma_first) or d += a b (mma_acc): a 16 x 16 bf16 (row-major
// fragments), b 16 x 8 bf16 (column-major), d 16 x 8 float32. Lane l holds
// d's rows l / 4 (d[0], d[1]) and l / 4 + 8 (d[2], d[3]) at columns
// 2 (l % 4) and 2 (l % 4) + 1. Not volatile: a pure function of its
// registers, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_first(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ void mma_acc(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// the sum over the eight row groups of a warp (lanes of one l % 4)
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  return v + __shfl_xor_sync(kFull, v, 16);
}

// T [D, D] float32 -> its kTerms bf16 terms, term t the bf16 of what the
// terms before it left (each remainder is exact in float32), laid out as
// the D / 16 slices the tc kernel stages: [D / 16, kTerms, 16, D + 8]
// (the 8 pad columns are never read)
__global__ void pool_split_kernel(const float* __restrict__ transform,
                                  __nv_bfloat16* __restrict__ terms, int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * D) return;
  const int k = i / D, d = i - k * D;
  const int P = D + kTcPad;
  __nv_bfloat16* dst = terms + static_cast<long long>(k >> 4) * kTerms * 16 * P + (k & 15) * P + d;
  float x = transform[i];
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    dst[t * 16 * P] = h;
    x = __fsub_rn(x, __bfloat162float(h));
  }
}

// one k-step of the LIVE first m16 tiles of MT: acc[m][n] += the 16
// columns' products of rows 16 m .. of the staged contexts (A-operand
// address xa) with the warp's 32 columns of T's terms (B-operand address
// tb, ldmatrix.trans), the terms smallest first into a fresh accumulator,
// then one IEEE add
template <int MT, int LIVE>
__device__ __forceinline__ void tc_kstep(float (&acc)[MT][kTcNTiles][4],
                                         const __nv_bfloat16* xa, const __nv_bfloat16* tb,
                                         int P) {
  unsigned bf[kTerms][2][4];  // [term][16-column half][fragments of two n8 tiles]
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    ldmatrix_x4_trans(bf[t][0], tb + t * 16 * P);
    ldmatrix_x4_trans(bf[t][1], tb + t * 16 * P + 16);
  }
#pragma unroll
  for (int m = 0; m < LIVE; ++m) {
    unsigned a[4];
    ldmatrix_x4(a, xa + m * 16 * P);
    float part[kTcNTiles][4];
#pragma unroll
    for (int n = 0; n < kTcNTiles; ++n)
      mma_first(part[n], a, bf[kTerms - 1][n >> 1][2 * (n & 1)],
                bf[kTerms - 1][n >> 1][2 * (n & 1) + 1]);
#pragma unroll
    for (int t = kTerms - 2; t >= 0; --t)
#pragma unroll
      for (int n = 0; n < kTcNTiles; ++n)
        mma_acc(part[n], a, bf[t][n >> 1][2 * (n & 1)], bf[t][n >> 1][2 * (n & 1) + 1]);
#pragma unroll
    for (int n = 0; n < kTcNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = __fadd_rn(acc[m][n][e], part[n][e]);
  }
}

// the tile's product over all of D: T's 16-row slices through a ring of
// `stages` slots, each filled by one bulk copy that thread 0 starts once
// every warp is done with the slot; the first `stages` copies are started
// before the loop. One instance per count of live m16 tiles (mlive <= LIVE
// picks the instance), so that the k-loop has no branch.
template <int MT, int LIVE>
__device__ __forceinline__ void tc_product(int mlive, float (&acc)[MT][kTcNTiles][4],
                                           __nv_bfloat16* t_s, uint64_t* full,
                                           const __nv_bfloat16* __restrict__ terms,
                                           const __nv_bfloat16* xa, int tb_off, int D, int P,
                                           int stages) {
  if constexpr (LIVE > 1) {
    if (mlive < LIVE) {
      tc_product<MT, LIVE - 1>(mlive, acc, t_s, full, terms, xa, tb_off, D, P, stages);
      return;
    }
  }
  const int nk = D / 16;
  const int slice = kTerms * 16 * P;  // elements
  for (int ks = 0; ks < nk; ++ks) {
    const int slot = ks % stages;
    mbar_wait(&full[slot], (ks / stages) & 1);
    tc_kstep<MT, LIVE>(acc, xa + ks * 16, t_s + slot * slice + tb_off, P);
    __syncthreads();  // every warp is done with the slot
    if (threadIdx.x == 0 && ks + stages < nk)
      bulk_load(t_s + slot * slice, terms + static_cast<long long>(ks + stages) * slice,
                2u * slice, &full[slot]);
  }
}

// kernel 1 on bf16, launch 2: one tile of 16 MT contexts of one method;
// blockDim.x = D <= MAXT
template <int MT, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
attention_pool_tc_kernel(const __nv_bfloat16* __restrict__ ctx,
                         const __nv_bfloat16* __restrict__ terms,
                         const float* __restrict__ attention, const float* __restrict__ mask,
                         float* __restrict__ attn, float* __restrict__ part_stats,
                         float* __restrict__ part_code, int C, int D, int ntiles,
                         int stages) {
  constexpr int R = 16 * MT;         // contexts of a tile
  constexpr int RL = (R + 31) / 32;  // of them, a lane of warp 0 in the softmax
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];  // a slot's slice landed
  const int P = D + kTcPad;
  const int nwarps = D >> 5;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [R, P]
  __nv_bfloat16* t_s = x_s + R * P;                                 // [stages, kTerms, 16, P]
  float* red_s = reinterpret_cast<float*>(t_s + stages * kTerms * 16 * P);  // [nwarps, R]
  float* e_s = red_s + nwarps * R;                                  // [R]

  const int b = blockIdx.x / ntiles;
  const int tile = blockIdx.x - b * ntiles;
  const int row0 = tile * R;
  const int rows = min(R, C - row0);   // live contexts of the tile
  const int mlive = (rows + 15) >> 4;  // m16 tiles computed
  const __nv_bfloat16* ctx_t = ctx + (static_cast<long long>(b) * C + row0) * D;

  // T's first slices (bulk copies) and the tile's contexts (cp.async);
  // rows past C are zeros
  const int nk = D / 16;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int st = 0; st < stages && st < nk; ++st)
      bulk_load(t_s + st * kTerms * 16 * P, terms + static_cast<long long>(st) * kTerms * 16 * P,
                2u * kTerms * 16 * P, &full[st]);
  }
  {
    const int r0 = threadIdx.x / (D >> 3);
    const int c8 = (threadIdx.x - r0 * (D >> 3)) * 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int r = r0; r < mlive * 16; r += 8) {
      __nv_bfloat16* d = x_s + r * P + c8;
      if (r < rows)
        cp_async16(d, ctx_t + static_cast<long long>(r) * D + c8);
      else
        *reinterpret_cast<uint4*>(d) = zero;
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();  // the contexts landed, the barriers are initialised

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int col0 = warp * kTcCols;
  const __nv_bfloat16* xa = x_s + (lane & 15) * P + (lane >> 4) * 8;
  const int tb_off = (lane & 15) * P + (lane >> 4) * 8 + col0;

  float acc[MT][kTcNTiles][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < kTcNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  tc_product<MT, MT>(mlive, acc, t_s, full, terms, xa, tb_off, D, P, stages);

  // tanh, and each row's dot with a over the warp's 32 columns
  float av[kTcNTiles][2];
#pragma unroll
  for (int n = 0; n < kTcNTiles; ++n) {
    const float2 v = *reinterpret_cast<const float2*>(attention + col0 + 8 * n + 2 * t4);
    av[n][0] = v.x;
    av[n][1] = v.y;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < mlive) {
      float p0 = 0.f, p1 = 0.f;  // rows 16 m + g and 16 m + g + 8
#pragma unroll
      for (int n = 0; n < kTcNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = tanhf(acc[m][n][e]);
        p0 += acc[m][n][0] * av[n][0];
        p0 += acc[m][n][1] * av[n][1];
        p1 += acc[m][n][2] * av[n][0];
        p1 += acc[m][n][3] * av[n][1];
      }
      p0 = quad_sum(p0);
      p1 = quad_sum(p1);
      if (t4 == 0) {
        red_s[warp * R + 16 * m + g] = p0;
        red_s[warp * R + 16 * m + g + 8] = p1;
      }
    }
  }
  __syncthreads();

  // warp 0: the tile's scores (raw, into attn), max, exps and sum
  if (warp == 0) {
    const long long arow = static_cast<long long>(b) * C + row0;
    float s[RL];
    bool live[RL], valid[RL];
    float m_t = -INFINITY;
#pragma unroll
    for (int h = 0; h < RL; ++h) {
      const int r = lane + 32 * h;
      live[h] = r < rows;
      float v = 0.f;
      if (live[h])
        for (int w = 0; w < nwarps; ++w) v += red_s[w * R + r];
      valid[h] = live[h] && mask[arow + r] > 0.f;
      s[h] = valid[h] ? v : kMaskedScore;
      if (live[h]) {
        attn[arow + r] = s[h];
        m_t = fmaxf(m_t, s[h]);
      }
    }
    m_t = warp_max(m_t);
    float l_t = 0.f;
    int n_valid = 0;
#pragma unroll
    for (int h = 0; h < RL; ++h) {
      const int r = lane + 32 * h;
      const float e = live[h] ? expf(s[h] - m_t) : 0.f;
      if (r < R) e_s[r] = e;
      l_t += e;
      n_valid += __popc(__ballot_sync(kFull, valid[h]));
    }
    l_t = warp_sum(l_t);
    if (lane == 0) {
      float* st = part_stats + static_cast<long long>(blockIdx.x) * kStats;
      st[0] = m_t;
      st[1] = l_t;
      st[2] = static_cast<float>(n_valid);
      st[3] = 0.f;
    }
  }
  __syncthreads();

  // the tile's code columns: sum over its rows of e_r tanh(..)[r, col]
  float* code_t = part_code + static_cast<long long>(blockIdx.x) * D + col0;
#pragma unroll
  for (int n = 0; n < kTcNTiles; ++n) {
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mlive) {
        const float ea = e_s[16 * m + g], eb = e_s[16 * m + g + 8];
        c0 += ea * acc[m][n][0];
        c0 += eb * acc[m][n][2];
        c1 += ea * acc[m][n][1];
        c1 += eb * acc[m][n][3];
      }
    }
    c0 = group_sum(c0);
    c1 = group_sum(c1);
    if (g == 0) *reinterpret_cast<float2*>(code_t + 8 * n + 2 * t4) = make_float2(c0, c1);
  }
}

// kernel 1 on bf16, launch 3: the tiles of one method combined in order
__global__ void __launch_bounds__(kCombineThreads)
pool_combine_kernel(const float* __restrict__ part_stats, const float* __restrict__ part_code,
                    float* __restrict__ code, float* __restrict__ attn, int C, int D,
                    int ntiles) {
  const int b = blockIdx.x;
  const float* st = part_stats + static_cast<long long>(b) * ntiles * kStats;
  float m = -INFINITY, n_valid = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    m = fmaxf(m, st[t * kStats]);
    n_valid += st[t * kStats + 2];
  }
  float l = 0.f;
  for (int t = 0; t < ntiles; ++t) l += st[t * kStats + 1] * expf(st[t * kStats] - m);
  const bool any_valid = n_valid > 0.f;
  const float* pc = part_code + static_cast<long long>(b) * ntiles * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = 0.f;
    for (int t = 0; t < ntiles; ++t) v += pc[static_cast<long long>(t) * D + d] * expf(st[t * kStats] - m);
    code[static_cast<long long>(b) * D + d] = any_valid ? v / l : 0.f;
  }
  float* attn_b = attn + static_cast<long long>(b) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    attn_b[c] = any_valid ? expf(attn_b[c] - m) / l : 0.f;
}

// The dynamic shared-memory limit is a per-device attribute of each kernel.
// It is raised once per (kernel, device) to what the largest D needs (above
// the 48 KB default), so a launch pays no attribute call.
cudaError_t ensure_smem_limit(const void* kernel, int bytes, std::atomic<bool>* done,
                              int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

cudaError_t launch_f32(const void* ctx, const void* transform, const void* attention,
                       const void* mask, void* code, void* attn, int B, int C, int D,
                       int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err = ensure_smem_limit(reinterpret_cast<const void*>(attention_pool_kernel<float>),
                                      smem_bytes(kMaxThreads), done, device);
  if (err != cudaSuccess) return err;
  attention_pool_kernel<float><<<B, D, smem_bytes(D), stream>>>(
      static_cast<const float*>(ctx), static_cast<const float*>(transform),
      static_cast<const float*>(attention), static_cast<const float*>(mask),
      static_cast<float*>(code), static_cast<float*>(attn), C, D);
  return cudaGetLastError();
}

// launches 2 and 3 with tiles of 16 MT contexts, for D <= MAXT
template <int MT, int MAXT>
cudaError_t launch_tiles(const __nv_bfloat16* terms, float* stats, float* parts, const void* ctx,
                         const void* attention, const void* mask, void* code, void* attn, int B,
                         int C, int D, int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err = ensure_smem_limit(
      reinterpret_cast<const void*>(attention_pool_tc_kernel<MT, MAXT>), kTcSmemBudget, done,
      device);
  if (err != cudaSuccess) return err;
  const int ntiles = tc_tiles(C, D);
  attention_pool_tc_kernel<MT, MAXT><<<B * ntiles, D, tc_smem_bytes(D), stream>>>(
      static_cast<const __nv_bfloat16*>(ctx), terms, static_cast<const float*>(attention),
      static_cast<const float*>(mask), static_cast<float*>(attn), stats, parts, C, D, ntiles,
      tc_stages(D));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pool_combine_kernel<<<B, kCombineThreads, 0, stream>>>(
      stats, parts, static_cast<float*>(code), static_cast<float*>(attn), C, D, ntiles);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* ctx, const void* transform, const void* attention,
                      const void* mask, void* code, void* attn, void* scratch, int B, int C,
                      int D, int device, cudaStream_t stream) {
  auto* base = static_cast<unsigned char*>(scratch);
  auto* terms = reinterpret_cast<__nv_bfloat16*>(base);
  auto* stats = reinterpret_cast<float*>(base + tc_terms_bytes(D));
  auto* parts = reinterpret_cast<float*>(base + tc_terms_bytes(D) + tc_stats_bytes(B, C, D));
  pool_split_kernel<<<(D * D + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(transform), terms, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return D <= kNarrowMaxD
             ? launch_tiles<kTallMT, kNarrowMaxD>(terms, stats, parts, ctx, attention, mask,
                                                  code, attn, B, C, D, device, stream)
             : launch_tiles<kWideMT, kMaxThreads>(terms, stats, parts, ctx, attention, mask,
                                                  code, attn, B, C, D, device, stream);
}

bool shape_ok(int B, int C, int D) {
  return B > 0 && C > 0 && D > 0 && D % 32 == 0 && D <= kMaxThreads &&
         static_cast<long long>(B) * tc_tiles(C, D) <= 0x7fffffffLL;
}

}  // namespace

// Bytes of device scratch a bf16 call needs (T's terms, the tiles' stats and
// codes), or -1 for a shape the kernels do not take.
extern "C" long long attention_pool_tc_scratch_bytes(int B, int C, int D) {
  return shape_ok(B, C, D) ? tc_scratch_bytes(B, C, D) : -1;
}

// The bf16 terms the tensor-core kernel splits T into.
extern "C" int attention_pool_tc_terms() { return kTerms; }

// ctx: [B, C, D] float32 (ctx_bf16 = 0) or bfloat16 (ctx_bf16 = 1), 16-byte
// aligned; transform: [D, D] float32; attention: [D] float32; mask: [B, C]
// float32; code: [B, D] float32 out; attn: [B, C] float32 out; scratch:
// attention_pool_tc_scratch_bytes(B, C, D) bytes, 256-byte aligned, for bf16
// (unused for float32). All contiguous, on `device`. Launches on `stream`
// without synchronising; returns the CUDA error code of the launches (0 on
// success).
extern "C" int attention_pool_forward(const void* ctx, int ctx_bf16,
                                      const void* transform, const void* attention,
                                      const void* mask, void* code, void* attn, void* scratch,
                                      int B, int C, int D, int device, void* stream) {
  if (!shape_ok(B, C, D) || (ctx_bf16 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // launch on `device`, and leave the calling thread's current device as
  // it was
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = ctx_bf16 ? launch_tc(ctx, transform, attention, mask, code, attn, scratch, B, C, D,
                             device, s)
                 : launch_f32(ctx, transform, attention, mask, code, attn, B, C, D, device, s);
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

extern "C" const char* attention_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
