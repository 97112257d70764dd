// Shared helpers for the port's hand-written Hopper kernels: element loads
// and stores in the working type (int8 codes widen exactly: |q| <= 127), and
// the f32 activations the MLP uses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// A launcher's geometry query (the *_geometry C entries): the launch's own
// host code fills one record per kernel it would launch (grid, block
// threads, dynamic shared bytes) and stops before the launch.
// kernels/ops.py::launch_geometry states the same in Python.
constexpr int GEOM_MAX = 4;
struct Geom {
  int n = 0;
  int v[GEOM_MAX][5];
};
struct Launch {
  dim3 grid;
  int threads, smem;
};

// Records `ls` into g; returns 0 (the launcher's "no error").
inline int record(Geom* g, std::initializer_list<Launch> ls) {
  for (const Launch& l : ls) {
    if (g->n == GEOM_MAX) return (int)cudaErrorInvalidValue;
    int* r = g->v[g->n++];
    r[0] = (int)l.grid.x, r[1] = (int)l.grid.y, r[2] = (int)l.grid.z;
    r[3] = l.threads, r[4] = l.smem;
  }
  return 0;
}

// Copies g into the caller's int array: n, then n x (gx, gy, gz, threads,
// smem). Returns rc.
inline int geometry_out(const Geom& g, int* out, int rc) {
  out[0] = g.n;
  for (int i = 0; i < g.n; ++i)
    for (int j = 0; j < 5; ++j) out[1 + 5 * i + j] = g.v[i][j];
  return rc;
}

}  // namespace rt
