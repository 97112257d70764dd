// Shared helpers for the port's hand-written Hopper kernels: element loads
// and stores in the working type (int8 codes widen exactly: |q| <= 127), and
// the f32 activations the MLP uses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// tanh-approximate GELU: the JAX default (jax.nn.gelu), not the exact erf.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// dtype codes shared with the Python wrappers
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int DT_I8 = 2;  // int8 codes with f32 scales (storage only)

}  // namespace rt
