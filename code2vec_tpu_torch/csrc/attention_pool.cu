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
// in float32 (bf16 contexts are widened on load), and never writes the
// [C, D] `transformed` intermediate to device memory: that is the TPU
// kernel's point, and it is kept here.
//
// Bound on an H100: the [C, D] x [D, D] product is 2*C*D^2 = 59 MFLOP per
// method at C = 200, D = 384 (3.8 GFLOP at B = 64), against 9.8 MB of bf16
// contexts, so the work is bound by operations, not bytes: about 57 us at
// the 67 TFLOP/s float32 (non tensor core) peak of the SXM part, which is
// the arithmetic this kernel does. The design keeps the product in float32
// FMA for agreement with the float32 reference, and keeps everything else
// (tanh, scores, softmax, weighted sum) on chip:
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
//     at the end with the final max and denominator. A method with no
//     valid context comes out as attn = 0 and code = 0, as in the
//     reference (an online softmax over all -1e9 scores would otherwise
//     give a uniform average).
//
// One block per method leaves most of the 132 SMs idle at small batch and
// the product does not use the tensor cores; both are left for later work
// (split C across blocks, wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kChunk = 32;         // contexts per chunk: one lane of warp 0 each
constexpr int kMaxThreads = 512;   // D <= 512 keeps acc[] in registers
constexpr float kMaskedScore = -1e9f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

constexpr int kMaxDevices = 64;

// The dynamic shared-memory limit is a per-device attribute of each kernel
// instance. It is raised once per (instance, device) to what the largest D
// needs (above the 48 KB default), so a launch pays no attribute call.
template <typename T>
cudaError_t ensure_smem_limit(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxThreads));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t launch(const void* ctx, const void* transform, const void* attention,
                   const void* mask, void* code, void* attn, int B, int C, int D,
                   int device, cudaStream_t stream) {
  cudaError_t err = ensure_smem_limit<T>(device);
  if (err != cudaSuccess) return err;
  attention_pool_kernel<T><<<B, D, smem_bytes(D), stream>>>(
      static_cast<const T*>(ctx), static_cast<const float*>(transform),
      static_cast<const float*>(attention), static_cast<const float*>(mask),
      static_cast<float*>(code), static_cast<float*>(attn), C, D);
  return cudaGetLastError();
}

}  // namespace

// ctx: [B, C, D] float32 (ctx_bf16 = 0) or bfloat16 (ctx_bf16 = 1);
// transform: [D, D] float32; attention: [D] float32; mask: [B, C] float32;
// code: [B, D] float32 out; attn: [B, C] float32 out. All contiguous, on
// `device`. Launches on `stream` without synchronising; returns the CUDA
// error code of the launch (0 on success).
extern "C" int attention_pool_forward(const void* ctx, int ctx_bf16,
                                      const void* transform, const void* attention,
                                      const void* mask, void* code, void* attn, int B,
                                      int C, int D, int device, void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || D % 32 != 0 || D > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  // launch on `device`, and leave the calling thread's current device as
  // it was
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = ctx_bf16 ? launch<__nv_bfloat16>(ctx, transform, attention, mask, code, attn,
                                         B, C, D, device, s)
                 : launch<float>(ctx, transform, attention, mask, code, attn, B, C, D,
                                 device, s);
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

extern "C" const char* attention_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
