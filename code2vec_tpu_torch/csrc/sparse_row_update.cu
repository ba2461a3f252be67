// Live-row Adam over the unique rows of a step, in place, for Hopper.
//
// Replaces the two Pallas TPU kernels of ops/pallas_sparse_update.py in
// the JAX package:
//
//   kernel 5  `_row_adam_kernel`      (launched from `_row_adam_impl`):
//             float32 / bfloat16 table [V, E] with float32 moments m, v;
//   kernel 6  `_requant_adam_kernel`  (launched from `_requant_adam_impl`):
//             int8 table {q [V, E], s [V, 1]} with float32 moments.
//
// Both take the step's deduplicated row ids `uids` [U] (unique, so no two
// warps touch one row and no atomics are needed) and the segment-summed
// float32 gradient `seg` [U, E], and update only those U rows. For row r
// and column c, with lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t) computed once
// per call by the caller (a float32 scalar on the device, read through a
// pointer, shared with the plain PyTorch version):
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p - (lr_t * m') / (sqrt(v') + eps)
//
// Kernel 6 first dequantizes p = q * s, then requantizes the row:
// s' = max(max_c |p'|, 1e-12) / 127, q' = clip(rint(p' / s' + d), -127,
// 127), with the counter-hash dither d of ops/quant.py::dither_from_index
// over the element index r * E + c (uint32, wrapping) and a per-call salt.
// rintf rounds half to even, as jnp.round and torch.round do.
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc would otherwise contract
// b1 * m + (1 - b1) * g into an FMA, and the plain version, which runs each
// operation as its own rounded step, would then disagree in the last bit.
//
// Bound on an H100: no arithmetic to speak of, so bytes. Per live row,
// kernel 5 reads p, m, v, g and the id and writes p, m, v:
// E * (2 * sizeof(p) + 20) + 4 bytes (an int32 id); kernel 6 reads q, s,
// m, v, g and writes q, s, m, v: 22 * E + 12 bytes. At 3.35 TB/s that is
// ~0.04 ms for 400,000 rows of E = 128 in bf16.
//
// Design: one warp per unique row, 8 rows per block of 256 threads. Lane l
// walks columns l, l + 32, ..., so each step of the warp reads 32
// neighbouring elements (128 bytes of float32): E = 128 is 4 steps, E = 384
// (the target table under sampled softmax) 12. Kernel 6 needs the row's
// absmax before it can round: pass 1 computes p' and reduces |p'| across
// the warp with __shfl_xor_sync; pass 2 recomputes p', m', v' from the
// same inputs (still in L1) and writes the row. Rows whose id lies outside
// [0, V) are dropped, as the JAX package's scatters drop its sentinel ids.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr long long kMaxRows = 0x7fffffffLL * kRowsPerBlock;  // grid.x limit

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct AdamHp {
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

struct AdamOut {
  float p, m, v;
};

__device__ __forceinline__ AdamOut adam(float p, float m, float v, float g,
                                        float lr_t, const AdamHp& hp) {
  AdamOut o;
  o.m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.one_minus_b1, g));
  o.v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(hp.one_minus_b2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(o.v), hp.eps);
  o.p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, o.m), denom));
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_adam_kernel(T* __restrict__ table, float* __restrict__ m, float* __restrict__ v,
                const int* __restrict__ uids, const float* __restrict__ seg,
                const float* __restrict__ lr_t_ptr, long long U, long long V, int E,
                AdamHp hp) {
  const long long u = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (u >= U) return;
  const long long row = uids[u];
  if (row < 0 || row >= V) return;
  const int lane = threadIdx.x & 31;
  const float lr_t = *lr_t_ptr;
  T* p_row = table + row * E;
  float* m_row = m + row * E;
  float* v_row = v + row * E;
  const float* g_row = seg + u * E;
  for (int c = lane; c < E; c += 32) {
    const AdamOut o = adam(load_f(p_row + c), m_row[c], v_row[c], g_row[c], lr_t, hp);
    store_f(p_row + c, o.p);
    m_row[c] = o.m;
    v_row[c] = o.v;
  }
}

__global__ void __launch_bounds__(kThreads)
requant_adam_kernel(int8_t* __restrict__ q, float* __restrict__ s, float* __restrict__ m,
                    float* __restrict__ v, const int* __restrict__ uids,
                    const float* __restrict__ seg, const float* __restrict__ lr_t_ptr,
                    uint32_t salt, long long U, long long V, int E, AdamHp hp) {
  const long long u = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (u >= U) return;  // whole warps leave together: u is uniform in a warp
  const long long row = uids[u];
  if (row < 0 || row >= V) return;
  const int lane = threadIdx.x & 31;
  const float lr_t = *lr_t_ptr;
  int8_t* q_row = q + row * E;
  float* m_row = m + row * E;
  float* v_row = v + row * E;
  const float* g_row = seg + u * E;
  const float scale = s[row];

  // pass 1: the updated row's absmax
  float amax = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float p = __fmul_rn(static_cast<float>(q_row[c]), scale);
    const AdamOut o = adam(p, m_row[c], v_row[c], g_row[c], lr_t, hp);
    amax = fmaxf(amax, fabsf(o.p));
  }
  const float s_new = c2v::row_scale(c2v::warp_max(amax));

  // pass 2: the same update again, requantized against s_new, and written
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(E);
  for (int c = lane; c < E; c += 32) {
    const float p = __fmul_rn(static_cast<float>(q_row[c]), scale);
    const AdamOut o = adam(p, m_row[c], v_row[c], g_row[c], lr_t, hp);
    q_row[c] = c2v::quantize(o.p, s_new, c2v::dither(base + static_cast<uint32_t>(c), salt));
    m_row[c] = o.m;
    v_row[c] = o.v;
  }
  if (lane == 0) s[row] = s_new;
}

unsigned grid_for(long long U) {
  return static_cast<unsigned>((U + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// Kernel 5. table: [V, E] float32 (table_bf16 = 0) or bfloat16 (1); m, v:
// [V, E] float32; uids: [U] int32, unique; seg: [U, E] float32; lr_t: one
// float32 on the device. All contiguous, on `device`. Updates the U rows in
// place on `stream` without synchronising; returns the CUDA error code of
// the launch (0 on success).
extern "C" int sparse_row_adam_launch(void* table, int table_bf16, void* m, void* v,
                                      const void* uids, const void* seg, const void* lr_t,
                                      long long U, long long V, int E, float b1,
                                      float one_minus_b1, float b2, float one_minus_b2,
                                      float eps, int device, void* stream) {
  if (U < 0 || U > kMaxRows || V <= 0 || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (U == 0) return 0;
  const AdamHp hp{b1, one_minus_b1, b2, one_minus_b2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ids = static_cast<const int*>(uids);
  const auto* g = static_cast<const float*>(seg);
  const auto* lr = static_cast<const float*>(lr_t);
  auto* mm = static_cast<float*>(m);
  auto* vv = static_cast<float*>(v);
  return static_cast<int>(c2v::on_device(device, [&] {
    if (table_bf16)
      row_adam_kernel<__nv_bfloat16><<<grid_for(U), kThreads, 0, s>>>(
          static_cast<__nv_bfloat16*>(table), mm, vv, ids, g, lr, U, V, E, hp);
    else
      row_adam_kernel<float><<<grid_for(U), kThreads, 0, s>>>(
          static_cast<float*>(table), mm, vv, ids, g, lr, U, V, E, hp);
  }));
}

// Kernel 6. q: [V, E] int8; s: [V, 1] float32; m, v: [V, E] float32; uids,
// seg, lr_t as for kernel 5; salt: the call's uint32 dither salt.
extern "C" int sparse_requant_adam_launch(void* q, void* s, void* m, void* v,
                                          const void* uids, const void* seg,
                                          const void* lr_t, unsigned int salt, long long U,
                                          long long V, int E, float b1, float one_minus_b1,
                                          float b2, float one_minus_b2, float eps,
                                          int device, void* stream) {
  if (U < 0 || U > kMaxRows || V <= 0 || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (U == 0) return 0;
  const AdamHp hp{b1, one_minus_b1, b2, one_minus_b2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(c2v::on_device(device, [&] {
    requant_adam_kernel<<<grid_for(U), kThreads, 0, st>>>(
        static_cast<int8_t*>(q), static_cast<float*>(s), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<const int*>(uids),
        static_cast<const float*>(seg), static_cast<const float*>(lr_t), salt, U, V, E,
        hp);
  }));
}

extern "C" const char* sparse_row_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
