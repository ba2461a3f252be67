// Pieces shared by the int8 requantize kernels (requant.cu: kernel 4;
// sparse_row_update.cu: kernel 6) and the launch helper of every kernel
// source in this directory. ops/_build.py hashes this header into the
// library name of each source that includes it, so an edit here rebuilds
// both.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace c2v {

// all-zero rows quantize against this scale floor, not 1/0
constexpr float kScaleFloor = 1e-12f;

// ops/quant.py::dither_from_index in uint32 arithmetic: Uniform(-0.5, 0.5)
// from the element index and the call's salt. The top 24 bits of the hash
// are exact in a float's mantissa, so the result stays in [-0.5, 0.5).
__device__ __forceinline__ float dither(uint32_t idx, uint32_t salt) {
  uint32_t h = (idx ^ salt) * 2654435761u;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  return __fsub_rn(__fmul_rn(static_cast<float>(h >> 8), 1.0f / 16777216.0f), 0.5f);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// s' = max(absmax, 1e-12) / 127, a true (correctly rounded) division
__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, kScaleFloor), 127.0f);
}

// q' = clip(rint(x / s' + d), -127, 127); rintf rounds half to even, as
// torch.round and jnp.round do
__device__ __forceinline__ int8_t quantize(float x, float s_new, float d) {
  const float r = rintf(__fadd_rn(__fdiv_rn(x, s_new), d));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// Runs `launch` on `device` and leaves the calling thread's current device
// as it was; returns the launch's CUDA error.
template <typename F>
cudaError_t on_device(int device, F launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  launch();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return err;
}

}  // namespace c2v
