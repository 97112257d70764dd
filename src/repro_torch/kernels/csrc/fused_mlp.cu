// Fused gated MLP for Hopper (sm_90a), hand-written CUDA C++, in two modes.
//
// Dense mode replaces the TPU kernel kernels/fused_mlp.py::fused_mlp of
// the JAX package:  y[t] = w[t] * (act(x[t] Wg) * (x[t] Wi)) Wo,  x (B,T,D),
// wi/wg (D,F), wo (F,D), f32 or bf16 in, f32 accumulation, x's type out.
// A per-row ragged count valid_count (B,) marks the real leading rows:
// token tiles past it are skipped and written as zeros, the straddling tile
// zeroes its trailing rows. act: silu (swiglu) or tanh-GELU.
//
// Routed mode replaces kernels/fused_mlp.py::fused_mlp_routed: x is the
// full (B,S,D) residual stream and idx (B,Kb) a RoutingPlan's gather
// indices (no duplicates in a row). Buffer row i of batch row b reads x
// row idx[b,i] (the gather happens in the tile load) and, when i <
// count[b], writes tw[b,i] * MLP to out row idx[b,i] (the scatter happens
// in the tile store); the wrapper zero-fills out first, so every other row
// is exactly zero. The (B,Kb,D) gathered buffer never exists in memory.
// The TPU kernel keeps one (S,D) output slab resident in VMEM; nothing
// here depends on S, so no slab limit applies.
//
// The TPU kernel carries the down-projection sum across its SEQUENTIAL F
// grid axis in VMEM. Hopper blocks run in parallel in no order, and a
// block cannot hold a (64 x D) f32 accumulator for D = 3584, so the work is
// two phases in one launch sequence on the caller's stream:
//   up:   one block per (64 buffer rows, 64 hidden columns) reduces over D
//         and writes act(x Wg) * (x Wi) to an f32 scratch (rows x F; 39 MB
//         for 512 Qwen2-7B rows, which the 50 MB L2 mostly holds);
//   down: one block per (64 buffer rows, 64 output columns) reduces over F
//         in a fixed order and applies the token weights and the count.
// No floating-point atomics: every output element is summed by one thread
// in the same order on every run, and each output row has one writer, so
// a row's result depends only on that row (budget 1.0 == teacher,
// staggered == solo and "the same step twice gives the same bits" stay
// bit-exact). Each block stages its x / H rows and weight tiles through
// shared memory, so a weight element is read once per 64-row tile, not
// once per token.
//
// Bound on the H100: at a 512-token prefill the 6*T*D*F FLOPs (~208 GFLOP)
// outweigh the ~0.4 GB of weights, so the tensor-core rate bounds it; this
// first version multiplies on the CUDA cores and is far from that bound.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // token rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // reduction depth per shared-memory stage
constexpr int NT = 256;  // threads per block: 4 x 4 outputs each
constexpr int PAD = 4;

// Row of x (up) or out (down) that buffer row m0 + r maps to: the gather
// index in routed mode, the row itself in dense mode.
__device__ __forceinline__ void load_rows(int* rows, const int* gidx, int b,
                                          int m0, int T_, int S) {
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int m = min(m0 + r, T_ - 1);
    rows[r] = gidx != nullptr ? min(max(gidx[(long)b * T_ + m], 0), S - 1)
                              : m;
  }
}

// T_: buffer rows per batch row (T, or Kb in routed mode); S: rows of x and
// out per batch row (T, or the sequence length in routed mode).
template <typename T>
__global__ void __launch_bounds__(NT) mlp_up(
    const T* __restrict__ x, const int* __restrict__ gidx,
    const T* __restrict__ wi, const T* __restrict__ wg,
    float* __restrict__ hbuf, const int* __restrict__ cnt, int T_, int S,
    int D, int F, int act) {
  __shared__ float Xs[BK][BM + PAD];  // transposed x tile
  __shared__ float Wis[BK][BN + PAD];
  __shared__ float Wgs[BK][BN + PAD];
  __shared__ int rows[BM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  if (m0 >= cnt[b]) return;  // dead tile: the down phase writes no rows of it
  const bool gated = wg != nullptr;
  const T* xb = x + (long)b * S * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_rows(rows, gidx, b, m0, T_, S);
  __syncthreads();
  float au[4][4], ag[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) au[i][j] = ag[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK;
      const bool in = m0 + r < T_ && k0 + kk < D;
      Xs[kk][r] = in ? rt::to_f(xb[(long)rows[r] * D + k0 + kk]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, n = idx % BN;
      const bool in = k0 + kk < D && n0 + n < F;
      const long off = (long)(k0 + kk) * F + n0 + n;
      Wis[kk][n] = in ? rt::to_f(wi[off]) : 0.f;
      if (gated) Wgs[kk][n] = in ? rt::to_f(wg[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bu[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bu[j] = Wis[kk][tx + 16 * j];
      if (gated) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bg[j] = Wgs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ag[i][j] += a[i] * bg[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) au[i][j] += a[i] * bu[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= T_) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= F) continue;
      float hv;
      if (gated)
        hv = (act == 0 ? rt::silu(ag[i][j]) : rt::gelu_tanh(ag[i][j])) * au[i][j];
      else
        hv = act == 0 ? rt::silu(au[i][j]) : rt::gelu_tanh(au[i][j]);
      hbuf[((long)b * T_ + r) * F + n] = hv;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) mlp_down(
    const float* __restrict__ hbuf, const int* __restrict__ gidx,
    const T* __restrict__ wo, const float* __restrict__ tw,
    const int* __restrict__ cnt, T* __restrict__ out, int T_, int S, int D,
    int F) {
  __shared__ float Hs[BK][BM + PAD];  // transposed hidden tile
  __shared__ float Ws[BK][BN + PAD];
  __shared__ int rows[BM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  const int c = cnt[b];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  T* ob = out + (long)b * S * D;
  if (m0 >= c) {  // dead tile: no compute; dense mode writes its zeros
    if (gidx != nullptr) return;  // routed: the zero fill covers them
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r >= T_) continue;
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < D) ob[(long)r * D + n] = rt::from_f<T>(0.f);
      }
    }
    return;
  }
  const float* hb = hbuf + (long)b * T_ * F;
  load_rows(rows, gidx, b, m0, T_, S);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK;
      const bool in = m0 + r < T_ && k0 + kk < F;
      Hs[kk][r] = in ? hb[(long)(m0 + r) * F + k0 + kk] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, n = idx % BN;
      const bool in = k0 + kk < F && n0 + n < D;
      Ws[kk][n] = in ? rt::to_f(wo[(long)(k0 + kk) * D + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bw[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= T_ || (gidx != nullptr && r >= c)) continue;
    const float wr = tw != nullptr ? tw[(long)b * T_ + r] : 1.f;
    const long orow = rows[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= D) continue;
      ob[orow * D + n] = rt::from_f<T>(r < c ? acc[i][j] * wr : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const int* gidx, const void* wi, const void* wg,
           const void* wo, const float* tw, const int* cnt, float* hbuf,
           void* out, int B, int T_, int S, int D, int F, int act,
           cudaStream_t stream) {
  const int mt = (T_ + BM - 1) / BM;
  mlp_up<T><<<dim3((F + BN - 1) / BN, mt, B), NT, 0, stream>>>(
      (const T*)x, gidx, (const T*)wi, (const T*)wg, hbuf, cnt, T_, S, D, F,
      act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlp_down<T><<<dim3((D + BN - 1) / BN, mt, B), NT, 0, stream>>>(
      hbuf, gidx, (const T*)wo, tw, cnt, (T*)out, T_, S, D, F);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* x, const int* gidx, const void* wi,
             const void* wg, const void* wo, const void* tw, const void* cnt,
             void* hbuf, void* out, int B, int T_, int S, int D, int F,
             int act, cudaStream_t s) {
  const float* w = (const float*)tw;
  const int* c = (const int*)cnt;
  float* h = (float*)hbuf;
  if (dtype == rt::DT_F32)
    return launch<float>(x, gidx, wi, wg, wo, w, c, h, out, B, T_, S, D, F,
                         act, s);
  if (dtype == rt::DT_BF16)
    return launch<__nv_bfloat16>(x, gidx, wi, wg, wo, w, c, h, out, B, T_, S,
                                 D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points bound with ctypes: both phases on `stream`; `hbuf` is the
// caller's (B*T*F, or B*Kb*F) f32 scratch. act: 0 = silu, 1 = tanh-GELU;
// wg == NULL for an ungated MLP; tw == NULL for unit token weights. Each
// returns the launches' cudaError_t.
extern "C" int fused_mlp_launch(int dtype, const void* x, const void* wi,
                                const void* wg, const void* wo,
                                const void* tw, const void* cnt, void* hbuf,
                                void* out, int B, int T, int D, int F,
                                int act, void* stream) {
  return dispatch(dtype, x, nullptr, wi, wg, wo, tw, cnt, hbuf, out, B, T, T,
                  D, F, act, (cudaStream_t)stream);
}

// Routed mode: x and out are (B,S,D), idx (B,Kb) int32; out is zero-filled
// on the stream first, then the selected rows are written.
extern "C" int fused_mlp_routed_launch(int dtype, const void* x,
                                       const void* idx, const void* wi,
                                       const void* wg, const void* wo,
                                       const void* tw, const void* cnt,
                                       void* hbuf, void* out, int B, int S,
                                       int Kb, int D, int F, int act,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t esz = dtype == rt::DT_BF16 ? 2 : 4;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * S * D * esz, s);
  if (e != cudaSuccess) return (int)e;
  return dispatch(dtype, x, (const int*)idx, wi, wg, wo, tw, cnt, hbuf, out,
                  B, Kb, S, D, F, act, s);
}
