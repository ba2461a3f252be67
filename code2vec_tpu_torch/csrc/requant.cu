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
// Bound on an H100: bytes. q read and written (2 bytes an element), s read
// and written (8 bytes a row), the update read once (2 or 4 bytes an
// element): at java-large, token_emb (1,301,138 x 128) with a bf16 update
// moves 677 MB, 0.202 ms at 3.35 TB/s. The ~21 float32 and integer
// operations an element (the dither's hash, the IEEE division) are not
// free beside that: on an H100 the scalar kernel's 1-byte accesses left it
// at 43 % of the byte bound, the vector kernel's 16-byte ones bring it to
// 83 % (PERF.md).
//
// Design: the sweep is dense over all V rows, and a row's new scale needs
// its absmax before anything can be rounded. Each row is read and written
// by the lanes of one warp only, so the update is safe in place: the Pallas
// kernel's separate output buffers are not needed.
//
//   - `requant_vec_kernel`, for E = 16 L with L a power of two up to 32
//     (java-large's E = 128: L = 8) and 16-byte aligned q and update: a lane
//     owns 16 neighbouring elements of a row, L lanes a row, so a warp holds
//     32 / L rows (4 at E = 128) in one 16-byte load of q and 32 (bf16) or
//     64 (float32) bytes of the update a lane. f is computed once and kept
//     in registers between the absmax (reduced over the row's L lanes with
//     width-L __shfl_xor_sync) and the requantize; q' goes back as one
//     16-byte store a lane. One row group a warp: at 40 registers, 64 warps
//     an SM keep enough loads in flight.
//   - `requant_kernel`, every other shape (E not of that form, such as
//     E = 100, or a pointer not 16-byte aligned): one warp per row, 8 rows
//     per block of 256 threads; lane l walks columns l, l + 32, ...; pass 1
//     computes f and reduces |f| across the warp, pass 2 recomputes f from
//     the same bytes (still in L1) and writes q'.
// Both use the same explicitly rounded operations in the same order, so
// they give the same bits.

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

constexpr int kPiece = 16;  // elements a lane owns (vector kernel)

// 16 update elements of a lane, widened to float32
__device__ __forceinline__ void load_piece(float (&u)[kPiece], const float* p) {
#pragma unroll
  for (int j = 0; j < kPiece; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    u[j] = v.x;
    u[j + 1] = v.y;
    u[j + 2] = v.z;
    u[j + 3] = v.w;
  }
}
__device__ __forceinline__ void load_piece(float (&u)[kPiece], const __nv_bfloat16* p) {
#pragma unroll
  for (int j = 0; j < kPiece; j += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + j);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[j + 2 * i] = __uint_as_float(w[i] << 16);         // low bf16: even column
      u[j + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// the vector kernel: `lanes` (L) lanes a row, 16 elements a lane, a group
// of 32 / L rows a warp
template <typename U>
__global__ void __launch_bounds__(kThreads)
requant_vec_kernel(int8_t* __restrict__ q, float* __restrict__ s, const U* __restrict__ upd,
                   uint32_t salt, long long V, int E, int lanes) {
  const int lane = threadIdx.x & 31;
  const int sub = lane / lanes;                   // row of the group
  const int col = (lane - sub * lanes) * kPiece;  // first column of this lane
  const long long warp = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const long long row = warp * (32 / lanes) + sub;
  const bool live = row < V;

  // f = q * s + u, kept in registers; its absmax over the row's lanes
  float f[kPiece];
  float amax = 0.f;
  if (live) {
    const uint4 qv = *reinterpret_cast<const uint4*>(q + row * E + col);
    load_piece(f, upd + row * E + col);
    const float scale = s[row];
    const unsigned w[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int j = 0; j < kPiece; ++j) {
      const float qf = static_cast<float>(static_cast<int8_t>(w[j >> 2] >> (8 * (j & 3))));
      f[j] = __fadd_rn(__fmul_rn(qf, scale), f[j]);
      amax = fmaxf(amax, fabsf(f[j]));
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!live) return;
  const float s_new = c2v::row_scale(amax);
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(E) +
                        static_cast<uint32_t>(col);
  unsigned out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kPiece; ++j) {
    const int8_t qn = c2v::quantize(f[j], s_new, c2v::dither(base + j, salt));
    out[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(qn)) << (8 * (j & 3));
  }
  *reinterpret_cast<uint4*>(q + row * E + col) = make_uint4(out[0], out[1], out[2], out[3]);
  if (col == 0) s[row] = s_new;
}

// the lanes a row of the vector kernel, or 0 where the scalar kernel takes
// the shape: E = 16 L with L a power of two up to 32, q and the update
// 16-byte aligned
int vec_lanes(const void* q, const void* upd, int E) {
  const int lanes = E / kPiece;
  if (E % kPiece != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0) return 0;
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(upd) % 16 != 0)
    return 0;
  return lanes;
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
  auto* qq = static_cast<int8_t*>(q);
  auto* ss = static_cast<float*>(s);
  const int lanes = vec_lanes(q, upd, E);
  if (lanes > 0) {
    const long long rows_per_block = (kThreads / 32) * (32 / lanes);
    const long long blocks = (V + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(blocks);
    return static_cast<int>(c2v::on_device(device, [&] {
      if (upd_bf16)
        requant_vec_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
            qq, ss, static_cast<const __nv_bfloat16*>(upd), salt, V, E, lanes);
      else
        requant_vec_kernel<float><<<grid, kThreads, 0, st>>>(
            qq, ss, static_cast<const float*>(upd), salt, V, E, lanes);
    }));
  }
  const unsigned grid = static_cast<unsigned>((V + kRowsPerBlock - 1) / kRowsPerBlock);
  return static_cast<int>(c2v::on_device(device, [&] {
    if (upd_bf16)
      requant_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<const __nv_bfloat16*>(upd), salt, V, E);
    else
      requant_kernel<float><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<const float*>(upd), salt, V, E);
  }));
}

// The lanes a row the vector kernel gives a table of width E at these
// pointers, or 0 where the scalar kernel takes it.
extern "C" int requant_vec_lanes(const void* q, const void* upd, int E) {
  return vec_lanes(q, upd, E);
}

extern "C" const char* requant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
