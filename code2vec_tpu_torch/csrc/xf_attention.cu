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
// in float32 FMA on the CUDA cores (the Pallas kernels' products take float32
// operands and accumulate in float32), outputs in q's dtype, and no [C, C]
// tensor ever reaches device memory. Every query row is computed, padded ones
// too: their outputs flow on through the layer as in the JAX package.
//
// The Pallas kernels keep a whole (b, h) block, q, k, v, o and the float32
// [C, C] logits, in ~16 MB of VMEM. A Hopper block has 227 KB of shared
// memory and the [200, 200] float32 logits alone take 160 KB, so these kernels
// tile over rows and keep each row's logits in registers:
//
//   - kernel 2 and kernel 3a run one block per (b, h, tile of 64 query rows),
//     the tiles of one (b, h) next to each other in the grid so that they
//     find its K and V in L2. K and V are staged in shared memory in the
//     input dtype (2 x 52 KB for bf16 at C = 200, hd = 128; 2 x 104 KB for
//     float32). A warp carries 4 query rows at once; a lane owns the keys
//     j = lane + 32 t, so a row's logits, max, exp and sum live in registers
//     and warp shuffles. A row's q (and do) comes from device memory, one
//     broadcast load per pair of columns. For the A v product the roles turn:
//     a lane owns pairs of output columns and the row's weights are
//     broadcast by shuffle, key by key.
//   - kernel 3a recomputes the logits and the softmax as kernel 2 does, then
//     dA_ij = do_i . v_j, delta_i = sum_j A_ij dA_ij (the Pallas kernel's row
//     sum; not do . o, which was rounded to the input dtype) and dq, and
//     writes the row statistics (max, sum of exp, delta) to a [B, H, C, 3]
//     float32 scratch.
//   - kernel 3b runs one block per (b, h, tile of 64 key rows) with Q and dO
//     staged, recomputes A_ij = exp(L_ij - m_i) / l_i from the statistics
//     with the same operations in the same order as 3a (so the same bits),
//     and sums dV_j and dK_j over the queries. Neither launch uses atomics:
//     the gradients are the same from run to run.
//   - staged rows are padded by two elements: a row stride of hd + 2 elements
//     puts the 32 lanes' reads of 32 rows at one column on distinct banks
//     (bf16: an odd number of 4-byte words; float32: 2 or 18 mod 32 words for
//     8-byte reads). At a 256-byte stride each such read is a 32-way bank
//     conflict.
//
// Bound on an H100 SXM at the training shape (B = 1024, H = 3, C = 200,
// hd = 128, bf16), counting the Pallas kernels' work with each product of
// 2 C^2 hd per (b, h) (31.5 GFLOP in all) at the peak of its operand types:
// a product of two bf16 inputs (q k^T, do v^T) is exact in a float32 sum and
// goes at the 989 TFLOP/s bf16 tensor-core peak, one with a float32 operand
// (the weights A, or dL) at the 67 TFLOP/s float32 peak. Kernel 2 (q k^T,
// A v): 0.50 ms, against 629 MB moved (0.19 ms at 3.35 TB/s). Kernel 3
// (q k^T, do v^T, A^T do, dL k, dL^T q): 1.47 ms, against 1.10 GB (0.33 ms).
// Both are bound by operations. The 3a / 3b split computes q k^T and do v^T
// twice: 7 products, 1.54 ms. With every product on the bf16 tensor cores
// (wgmma) the bounds would be 0.064 and 0.16 ms; that and TMA staging are
// later work.

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

// two staged [C, hd] blocks, and the three per-query statistics of 3b
int smem_bytes(int C, int hd, int elem) { return 2 * C * (hd + 2) * elem + 3 * C * 4; }

struct Shape {
  int B, H, C, hd;
  int tiles() const { return (C + kTile - 1) / kTile; }
  int blocks() const { return B * H * tiles(); }
};

template <typename T>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const void* mask,
                           void* o, Shape sh, float scale, int device, cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  auto* kernel = mha_fwd_kernel<T, kRows>;
  cudaError_t err = ensure_smem_limit(kernel, done, device);
  if (err != cudaSuccess) return err;
  kernel<<<sh.blocks(), kThreads, smem_bytes(sh.C, sh.hd, sizeof(T)), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(o), sh.H, sh.C, sh.hd, scale,
      sh.tiles());
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* mask,
                            const void* dout, void* dq, void* dk, void* dv, void* stats,
                            Shape sh, float scale, int device, cudaStream_t s) {
  static std::atomic<bool> done_dq[kMaxDevices];
  static std::atomic<bool> done_dkv[kMaxDevices];
  auto* dq_kernel = mha_bwd_dq_kernel<T, kRows>;
  auto* dkv_kernel = mha_bwd_dkv_kernel<T, kRows>;
  cudaError_t err = ensure_smem_limit(dq_kernel, done_dq, device);
  if (err == cudaSuccess) err = ensure_smem_limit(dkv_kernel, done_dkv, device);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes(sh.C, sh.hd, sizeof(T));
  dq_kernel<<<sh.blocks(), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(stats), sh.H, sh.C, sh.hd, scale, sh.tiles());
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<sh.blocks(), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<T*>(dk), static_cast<T*>(dv), sh.H, sh.C,
      sh.hd, scale, sh.tiles());
  return cudaGetLastError();
}

cudaError_t check_shape(Shape sh, int elem) {
  if (sh.B <= 0 || sh.H <= 0 || sh.C <= 0 || sh.C > kMaxC || sh.hd < 16 ||
      sh.hd > kMaxHd || sh.hd % 16 != 0 || smem_bytes(sh.C, sh.hd, elem) > kMaxSmem ||
      static_cast<long long>(sh.B) * sh.H * sh.tiles() > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
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
// Launches kernel 2 on `stream` without synchronising; returns the CUDA
// error code of the launch (0 on success).
extern "C" int xf_attention_forward(const void* q, const void* k, const void* v,
                                    const void* log_mask, void* o, int bf16, int B, int H,
                                    int C, int hd, float scale, int device, void* stream) {
  const Shape sh{B, H, C, hd};
  const int elem = bf16 ? 2 : 4;
  if (check_shape(sh, elem) != cudaSuccess) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return bf16 ? launch_forward<__nv_bfloat16>(q, k, v, log_mask, o, sh, scale, device, s)
                : launch_forward<float>(q, k, v, log_mask, o, sh, scale, device, s);
  });
}

// As the forward, with dout, dq, dk, dv like q and `stats` a [B, H, C, 3]
// float32 scratch: launches kernel 3a (dq and the statistics), then kernel
// 3b (dk and dv), on `stream`.
extern "C" int xf_attention_backward(const void* q, const void* k, const void* v,
                                     const void* log_mask, const void* dout, void* dq,
                                     void* dk, void* dv, void* stats, int bf16, int B, int H,
                                     int C, int hd, float scale, int device, void* stream) {
  const Shape sh{B, H, C, hd};
  const int elem = bf16 ? 2 : 4;
  if (check_shape(sh, elem) != cudaSuccess) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return bf16 ? launch_backward<__nv_bfloat16>(q, k, v, log_mask, dout, dq, dk, dv, stats,
                                                 sh, scale, device, s)
                : launch_backward<float>(q, k, v, log_mask, dout, dq, dk, dv, stats, sh,
                                         scale, device, s);
  });
}

extern "C" const char* xf_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
