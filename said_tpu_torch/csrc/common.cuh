// Shared helpers for the hand-written Hopper kernels of said_tpu_torch.
//
// Every kernel takes f32 or bf16 activations and keeps statistics and
// accumulation in f32. The C entry points take a dtype code and return
// the cudaError_t of the launch (0 = success); the Python wrapper raises
// on anything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace said {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Exact-erf GELU in f32 (torch's F.gelu default; the TPU kernels used an
// Abramowitz-Stegun erf only because Mosaic has no erf lowering).
__device__ __forceinline__ float gelu_erf(float h) {
  return h * 0.5f * (1.0f + erff(h * 0.70710678118654752440f));
}

}  // namespace said
