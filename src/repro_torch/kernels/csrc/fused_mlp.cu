// Fused gated MLP for Hopper (sm_90a), hand-written CUDA C++, in three modes.
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
// Grouped-expert mode replaces kernels/moe_gmm.py::moe_gmm: x (B,E,C,D)
// holds the capacity-dispatched token buffers of E experts, one group per
// (b, e) with its own count cnt (B,E), and expert e = g % E of group g
// reads wi/wg (E,D,Fe, one layout for both) and wo (E,Fe,D) through an
// expert stride and a row stride (elements; the last dimension is
// contiguous). So one kernel reads both layouts in place: the moefied
// views of a dense (D,F) / (F,D) MLP (expert e of wi is columns
// [e*Fe, (e+1)*Fe) of the dense matrix: expert stride Fe, row stride F)
// and native contiguous expert stacks. No weight is copied. The dense mode
// is the grouped mode with one expert (groups are batch rows), compiled
// apart so that it keeps the index arithmetic of a plain matrix (runtime
// strides cost it ~7 % on the H100). As in dense mode, tiles past a
// group's count do no work and are written as zeros (the TPU kernel's
// `_dead` branch), so the work follows the dispatched tokens, not the
// capacity.
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

// Where expert e = g % E of group g finds its weights in grouped mode
// (GROUPED = true): element strides between experts (es) and between rows
// (rs) of wi and wg (one layout) and of wo. The dense and routed modes
// compile with GROUPED = false: one expert, rows of F (wi, wg) and D (wo),
// the index arithmetic of a plain (D,F) / (F,D) matrix.
struct Experts {
  int E;
  long w_es, w_rs, wo_es, wo_rs;
};

// Row of x (up) or out (down) that buffer row m0 + r maps to: the gather
// index in routed mode, the row itself otherwise.
__device__ __forceinline__ void load_rows(int* rows, const int* gidx, int g,
                                          int m0, int T_, int S) {
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int m = min(m0 + r, T_ - 1);
    rows[r] = gidx != nullptr ? min(max(gidx[(long)g * T_ + m], 0), S - 1)
                              : m;
  }
}

// g = blockIdx.z: the group (a batch row, or a (b, e) expert group). T_:
// buffer rows per group (T, Kb in routed mode, C in grouped mode); S: rows
// of x and out per group (T_, or the sequence length in routed mode).
// At least 4 blocks per SM: the grouped mode's offsets would otherwise take
// the compiler to 80 registers (3 blocks per SM) in the dense mode too,
// ~2.5 % slower on the H100.
template <typename T, bool GROUPED>
__global__ void __launch_bounds__(NT, 4) mlp_up(
    const T* __restrict__ x, const int* __restrict__ gidx,
    const T* __restrict__ wi, const T* __restrict__ wg, Experts ex,
    float* __restrict__ hbuf, const int* __restrict__ cnt, int T_, int S,
    int D, int F, int act) {
  __shared__ float Xs[BK][BM + PAD];  // transposed x tile
  __shared__ float Wis[BK][BN + PAD];
  __shared__ float Wgs[BK][BN + PAD];
  __shared__ int rows[BM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, g = blockIdx.z;
  if (m0 >= cnt[g]) return;  // dead tile: the down phase writes no rows of it
  const bool gated = wg != nullptr;
  const T* xb = x + (long)g * S * D;
  const long w_off = GROUPED ? (long)(g % ex.E) * ex.w_es : 0;
  const long w_rs = GROUPED ? ex.w_rs : F;
  const T* wie = wi + w_off;
  const T* wge = gated ? wg + w_off : nullptr;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_rows(rows, gidx, g, m0, T_, S);
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
      const long off = (long)(k0 + kk) * w_rs + n0 + n;
      Wis[kk][n] = in ? rt::to_f(wie[off]) : 0.f;
      if (gated) Wgs[kk][n] = in ? rt::to_f(wge[off]) : 0.f;
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
      hbuf[((long)g * T_ + r) * F + n] = hv;
    }
  }
}

template <typename T, bool GROUPED>
__global__ void __launch_bounds__(NT) mlp_down(
    const float* __restrict__ hbuf, const int* __restrict__ gidx,
    const T* __restrict__ wo, Experts ex, const float* __restrict__ tw,
    const int* __restrict__ cnt, T* __restrict__ out, int T_, int S, int D,
    int F) {
  __shared__ float Hs[BK][BM + PAD];  // transposed hidden tile
  __shared__ float Ws[BK][BN + PAD];
  __shared__ int rows[BM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, g = blockIdx.z;
  const int c = cnt[g];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  T* ob = out + (long)g * S * D;
  if (m0 >= c) {  // dead tile: no compute; unrouted modes write its zeros
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
  const float* hb = hbuf + (long)g * T_ * F;
  const T* woe = GROUPED ? wo + (long)(g % ex.E) * ex.wo_es : wo;
  const long wo_rs = GROUPED ? ex.wo_rs : D;
  load_rows(rows, gidx, g, m0, T_, S);
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
      Ws[kk][n] = in ? rt::to_f(woe[(long)(k0 + kk) * wo_rs + n0 + n]) : 0.f;
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
    const float wr = tw != nullptr ? tw[(long)g * T_ + r] : 1.f;
    const long orow = rows[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= D) continue;
      ob[orow * D + n] = rt::from_f<T>(r < c ? acc[i][j] * wr : 0.f);
    }
  }
}

// G groups (grid z), each with T_ buffer rows.
template <typename T, bool GROUPED>
int launch(const void* x, const int* gidx, const void* wi, const void* wg,
           const void* wo, const Experts& ex, const float* tw, const int* cnt,
           float* hbuf, void* out, int G, int T_, int S, int D, int F,
           int act, cudaStream_t stream) {
  const int mt = (T_ + BM - 1) / BM;
  if (G > 65535 || mt > 65535) return (int)cudaErrorInvalidConfiguration;
  mlp_up<T, GROUPED><<<dim3((F + BN - 1) / BN, mt, G), NT, 0, stream>>>(
      (const T*)x, gidx, (const T*)wi, (const T*)wg, ex, hbuf, cnt, T_, S, D,
      F, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlp_down<T, GROUPED><<<dim3((D + BN - 1) / BN, mt, G), NT, 0, stream>>>(
      hbuf, gidx, (const T*)wo, ex, tw, cnt, (T*)out, T_, S, D, F);
  return (int)cudaGetLastError();
}

template <bool GROUPED>
int dispatch(int dtype, const void* x, const int* gidx, const void* wi,
             const void* wg, const void* wo, const Experts& ex,
             const void* tw, const void* cnt, void* hbuf, void* out, int G,
             int T_, int S, int D, int F, int act, cudaStream_t s) {
  const float* w = (const float*)tw;
  const int* c = (const int*)cnt;
  float* h = (float*)hbuf;
  if (dtype == rt::DT_F32)
    return launch<float, GROUPED>(x, gidx, wi, wg, wo, ex, w, c, h, out, G,
                                  T_, S, D, F, act, s);
  if (dtype == rt::DT_BF16)
    return launch<__nv_bfloat16, GROUPED>(x, gidx, wi, wg, wo, ex, w, c, h,
                                          out, G, T_, S, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points bound with ctypes: both phases on `stream`; `hbuf` is the
// caller's (B*T*F, B*Kb*F or B*E*C*Fe) f32 scratch. act: 0 = silu, 1 =
// tanh-GELU; wg == NULL for an ungated MLP; tw == NULL for unit token
// weights. Each returns the launches' cudaError_t.
extern "C" int fused_mlp_launch(int dtype, const void* x, const void* wi,
                                const void* wg, const void* wo,
                                const void* tw, const void* cnt, void* hbuf,
                                void* out, int B, int T, int D, int F,
                                int act, void* stream) {
  return dispatch<false>(dtype, x, nullptr, wi, wg, wo, Experts{}, tw, cnt,
                         hbuf, out, B, T, T, D, F, act, (cudaStream_t)stream);
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
  return dispatch<false>(dtype, x, (const int*)idx, wi, wg, wo, Experts{},
                         tw, cnt, hbuf, out, B, Kb, S, D, F, act, s);
}

// Grouped-expert mode: x and out are (B,E,C,D); strides in elements (wg,
// when given, has wi's); `cnt` (B*E) int32 counts clipped to [0, C]; w
// (B*E*C) f32 or NULL.
extern "C" int moe_gmm_launch(int dtype, const void* x, const void* wi,
                              const void* wg, const void* wo, long long w_es,
                              long long w_rs, long long wo_es,
                              long long wo_rs, const void* w, const void* cnt,
                              void* hbuf, void* out, int B, int E, int C,
                              int D, int Fe, int act, void* stream) {
  const Experts ex{E, w_es, w_rs, wo_es, wo_rs};
  return dispatch<true>(dtype, x, nullptr, wi, wg, wo, ex, w, cnt, hbuf, out,
                        B * E, C, C, D, Fe, act, (cudaStream_t)stream);
}
