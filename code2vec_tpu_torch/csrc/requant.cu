// Dense requantize of an int8 embedding table, in place, for Hopper.
//
// Replaces the Pallas TPU kernel of ops/pallas_requant.py in the JAX
// package (kernel 4: `_requant_kernel`, launched from
// `_requantize_fused_impl`). The dense training step with int8 token/path
// tables turns each table's dense [V, E] gradient into a dense update
// (Adafactor's output, bf16, or float32) and applies it here. For row r
// and column c of q [V, E] int8, s [V, 1] float32 and the update u:
//
//   f  = q * s + u
//   s' = max(max_c |f|, 1e-12) / 127
//   q' = clip(rint(f / s' + d), -127, 127)
//
// with the counter-hash dither d of ops/quant.py::dither_from_index over
// the element index r * E + c (uint32, wrapping) and the call's salt
// (quant_common.cuh, shared with kernel 6). rintf rounds half to even.
// Every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn), so nvcc cannot contract q * s + u into an FMA
// and the result is bit-identical to the plain PyTorch version
// (ops/quant.py::requantize_reference), which rounds each operation on
// its own.
//
// Bound on an H100: no arithmetic to speak of, so bytes. q read and
// written (2 bytes an element), s read and written (8 bytes a row), the
// update read once (2 or 4 bytes an element): at java-large, token_emb
// (1,301,138 x 128) and path_emb (911,419 x 128) with bf16 updates move
// ~1.15 GB, ~0.34 ms at 3.35 TB/s.
//
// Design: the sweep is dense, one warp per row over all V rows, 8 rows
// per block of 256 threads. Lane l walks columns l, l + 32, ..., so each
// step of the warp touches 32 neighbouring elements. The row's new scale
// needs its absmax before anything can be rounded: pass 1 computes f and
// reduces |f| across the warp with __shfl_xor_sync; pass 2 recomputes f
// from the same bytes (still in L1) and writes q', and lane 0 writes s'.
// Each row is read and written by its own warp only, so the update is
// safe in place: the Pallas kernel's separate output buffers are not
// needed.

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

template <typename U>
__global__ void __launch_bounds__(kThreads)
requant_kernel(int8_t* __restrict__ q, float* __restrict__ s, const U* __restrict__ upd,
               uint32_t salt, long long V, int E) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= V) return;  // whole warps leave together: row is uniform in a warp
  const int lane = threadIdx.x & 31;
  int8_t* q_row = q + row * E;
  const U* u_row = upd + row * E;
  const float scale = s[row];

  // pass 1: the updated row's absmax
  float amax = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float f = __fadd_rn(__fmul_rn(static_cast<float>(q_row[c]), scale), load_f(u_row + c));
    amax = fmaxf(amax, fabsf(f));
  }
  const float s_new = c2v::row_scale(c2v::warp_max(amax));

  // pass 2: the same values again, requantized against s_new, and written
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(E);
  for (int c = lane; c < E; c += 32) {
    const float f = __fadd_rn(__fmul_rn(static_cast<float>(q_row[c]), scale), load_f(u_row + c));
    q_row[c] = c2v::quantize(f, s_new, c2v::dither(base + static_cast<uint32_t>(c), salt));
  }
  if (lane == 0) s[row] = s_new;
}

}  // namespace

// q: [V, E] int8; s: [V, 1] float32; upd: [V, E] float32 (upd_bf16 = 0) or
// bfloat16 (1); salt: the call's uint32 dither salt. All contiguous, on
// `device`. Updates q and s in place on `stream` without synchronising;
// returns the CUDA error code of the launch (0 on success).
extern "C" int requant_launch(void* q, void* s, const void* upd, int upd_bf16,
                              unsigned int salt, long long V, int E, int device,
                              void* stream) {
  if (V < 0 || V > kMaxRows || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((V + kRowsPerBlock - 1) / kRowsPerBlock);
  auto* qq = static_cast<int8_t*>(q);
  auto* ss = static_cast<float*>(s);
  return static_cast<int>(c2v::on_device(device, [&] {
    if (upd_bf16)
      requant_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<const __nv_bfloat16*>(upd), salt, V, E);
    else
      requant_kernel<float><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<const float*>(upd), salt, V, E);
  }));
}

extern "C" const char* requant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
