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
// contiguous; the tensor-core body turns them into tile coordinates). So
// one kernel reads both layouts in place: the moefied views of a dense
// (D,F) / (F,D) MLP (expert e of wi is columns [e*Fe, (e+1)*Fe) of the
// dense matrix: expert stride Fe, row stride F) and native contiguous
// expert stacks. No weight is copied. The dense mode is the grouped mode
// with one expert (groups are batch rows): the tensor-core body runs both
// through one code, the CUDA-core body compiles the dense mode apart so
// that it keeps the index arithmetic of a plain matrix (runtime strides
// cost it ~7 % on the H100). As in dense mode, tiles past a
// group's count do no work and are written as zeros (the TPU kernel's
// `_dead` branch), so the work follows the dispatched tokens, not the
// capacity.
//
// The TPU kernel carries the down-projection sum across its SEQUENTIAL F
// grid axis in VMEM. Hopper blocks run in parallel in no order, and a
// block cannot hold a (rows x D) f32 accumulator for D = 3584, so the work
// is two phases on the caller's stream:
//   up:   each block reduces over D for a tile of buffer rows x hidden
//         columns and writes act(x Wg) * (x Wi) to a scratch (rows x F);
//   down: each block reduces over F in a fixed order for a tile of rows x
//         output columns, and the token weights and the count are applied.
// No floating-point atomics: every output element is summed in the same
// order on every run, and each output row has one writer, so a row's
// result depends only on that row (budget 1.0 == teacher, staggered ==
// solo and "the same step twice gives the same bits" stay bit-exact).
//
// Bound on the H100: at a 512-token prefill the 6*T*D*F FLOPs (~208 GFLOP)
// outweigh the ~0.4 GB of weights, so the tensor-core rate bounds it; at a
// 16-row prefill chunk the weights' bytes do, and in grouped mode so do the
// live experts' weights when each holds few rows (60 Qwen1.5-MoE experts:
// ~1 GB). Two bodies, chosen by the wrapper (kernels/ops.py::mlp_plan and
// gmm_plan) from dtype and shape:
//
// * bf16 in all three modes with D and F multiples of 64 (every Qwen2-7B
//   and Qwen1.5-MoE call): the tensor-core body (namespace tc below): TMA
//   weight tiles through a multi-stage mbarrier ring (in grouped mode the
//   expert moves the tile's coordinates, so both expert layouts are read in
//   place), a cp.async row gather in routed mode, wgmma into f32
//   accumulators, a bf16 H scratch (19.4 MB for 512 Qwen2-7B rows, which
//   the 50 MB L2 holds) and, where the row tiles are few, a down phase
//   split over F with an in-order sum of the parts.
//   NUMERICS: H is rounded to bf16 between the phases (the wgmma A operand
//   is bf16); the JAX kernels and the plain versions keep it in f32. The
//   difference is one bf16 rounding of each hidden value, well inside the
//   bf16 tolerance (tests/test_torch_kernels.py and tests/test_torch_moe.py
//   hold the emulation to the JAX kernels; chip_smoke.py and
//   tests/test_torch_cuda.py hold this body to the plain versions).
// * f32 (TF32 would break the 1e-4 tolerance) and widths that are not
//   multiples of 64 (the toy configs), in every mode: the first, CUDA-core
//   body: one block per (64 buffer rows, 64 columns), x / H rows and weight
//   tiles staged through shared memory in f32 per 16-deep step, f32 FMAs,
//   H in an f32 scratch.
//
// Weights in another storage type than x (the serving engine's
// weight_dtype; every mode): bf16 weights of an f32 model, or int8 codes
// with f32 per-output-channel scales (dense and routed wi/wg (F,), wo (D,);
// grouped (E,Fe) and (E,D), expert e's row). The weights are read in their
// storage type (an int8 weight is half a bf16 weight's bytes, which is what
// bounds a prefill chunk) and widened in registers as the tile is staged
// (exact: |q| <= 127). A per-output-channel scale commutes with the
// reduction, x (q * s) = (x q) * s, so the scales are applied in the
// epilogues: on the up and gate accumulators before the activation, and on
// the down accumulator before the token weight and the store. int8 weights
// under bf16 x at widths that are multiples of 64 (Qwen2-7B, the native
// MoE) run the tensor-core body's int8 form (below), in the routed mode
// too (a train-mode serving engine's admissions); f32 x with int8 or
// bf16 weights, and the toy widths, the CUDA-core body, which widens the
// weights in registers as it stages them (kernels/ops.py::mlp_plan).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// f32 per-output-channel scales of int8 weights (NULL otherwise): wi and wg
// (F per expert), wo (D per expert); expert e's start at e * F / e * D.
struct Scales {
  const float *wi, *wg, *wo;
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
template <typename T, typename TW, bool GROUPED>
__global__ void __launch_bounds__(NT, 4) mlp_up(
    const T* __restrict__ x, const int* __restrict__ gidx,
    const TW* __restrict__ wi, const TW* __restrict__ wg, Experts ex,
    Scales sc, float* __restrict__ hbuf, const int* __restrict__ cnt,
    int T_, int S, int D, int F, int act) {
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
  const TW* wie = wi + w_off;
  const TW* wge = gated ? wg + w_off : nullptr;
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

  const long s_off = GROUPED ? (long)(g % ex.E) * F : 0;  // expert e's scales
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= T_) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= F) continue;
      if constexpr (std::is_same<TW, int8_t>::value) {  // x (q s) = (x q) s
        au[i][j] *= sc.wi[s_off + n];
        if (gated) ag[i][j] *= sc.wg[s_off + n];
      }
      float hv;
      if (gated)
        hv = (act == 0 ? rt::silu(ag[i][j]) : rt::gelu_tanh(ag[i][j])) * au[i][j];
      else
        hv = act == 0 ? rt::silu(au[i][j]) : rt::gelu_tanh(au[i][j]);
      hbuf[((long)g * T_ + r) * F + n] = hv;
    }
  }
}

template <typename T, typename TW, bool GROUPED>
__global__ void __launch_bounds__(NT) mlp_down(
    const float* __restrict__ hbuf, const int* __restrict__ gidx,
    const TW* __restrict__ wo, Experts ex, Scales sc,
    const float* __restrict__ tw, const int* __restrict__ cnt,
    T* __restrict__ out, int T_, int S, int D, int F) {
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
  const TW* woe = GROUPED ? wo + (long)(g % ex.E) * ex.wo_es : wo;
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  const float* wos = Q8 ? sc.wo + (GROUPED ? (long)(g % ex.E) * D : 0)
                        : nullptr;
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
      float a = acc[i][j];
      if constexpr (Q8) a *= wos[n];  // int8 weights: (h q) s
      ob[orow * D + n] = rt::from_f<T>(r < c ? a * wr : 0.f);
    }
  }
}

// G groups (grid z), each with T_ buffer rows; T: x's and out's type, TW:
// the weights' storage type.
template <typename T, typename TW, bool GROUPED>
int launch(const void* x, const int* gidx, const void* wi, const void* wg,
           const void* wo, const Experts& ex, const Scales& sc,
           const float* tw, const int* cnt, float* hbuf, void* out, int G,
           int T_, int S, int D, int F, int act, cudaStream_t stream,
           rt::Geom* geo) {
  const int mt = (T_ + BM - 1) / BM;
  if (G > 65535 || mt > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 gu((F + BN - 1) / BN, mt, G), gd((D + BN - 1) / BN, mt, G);
  if (geo != nullptr) return rt::record(geo, {{gu, NT, 0}, {gd, NT, 0}});
  mlp_up<T, TW, GROUPED><<<gu, NT, 0, stream>>>(
      (const T*)x, gidx, (const TW*)wi, (const TW*)wg, ex, sc, hbuf, cnt, T_,
      S, D, F, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlp_down<T, TW, GROUPED><<<gd, NT, 0, stream>>>(
      hbuf, gidx, (const TW*)wo, ex, sc, tw, cnt, (T*)out, T_, S, D, F);
  return (int)cudaGetLastError();
}

// (x type, weight storage): f32 over f32, bf16 or int8; bf16 over bf16 or
// int8; int8 weights come with their three scales (wg's when gated)
template <bool GROUPED>
int dispatch(int dtype, int w_dtype, const void* x, const int* gidx,
             const void* wi, const void* wg, const void* wo,
             const Experts& ex, const Scales& sc, const void* tw,
             const void* cnt, void* hbuf, void* out, int G, int T_, int S,
             int D, int F, int act, cudaStream_t s, rt::Geom* geo) {
  const float* w = (const float*)tw;
  const int* c = (const int*)cnt;
  float* h = (float*)hbuf;
  if ((w_dtype == rt::DT_I8) !=
      (sc.wi != nullptr && sc.wo != nullptr &&
       (wg == nullptr || sc.wg != nullptr)))
    return (int)cudaErrorInvalidValue;
#define MLP_LAUNCH(T, TW)                                                     \
  return launch<T, TW, GROUPED>(x, gidx, wi, wg, wo, ex, sc, w, c, h, out, G, \
                                T_, S, D, F, act, s, geo)
  if (dtype == rt::DT_F32 && w_dtype == rt::DT_F32) MLP_LAUNCH(float, float);
  if (dtype == rt::DT_F32 && w_dtype == rt::DT_BF16)
    MLP_LAUNCH(float, __nv_bfloat16);
  if (dtype == rt::DT_F32 && w_dtype == rt::DT_I8) MLP_LAUNCH(float, int8_t);
  if (dtype == rt::DT_BF16 && w_dtype == rt::DT_BF16)
    MLP_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == rt::DT_BF16 && w_dtype == rt::DT_I8)
    MLP_LAUNCH(__nv_bfloat16, int8_t);
#undef MLP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ----------------------------- tensor-core body -----------------------------
//
// bf16 dense, routed and grouped-expert modes with D and F multiples of 64.
// Each phase is one launch of mlp_tc<UP, WGS> (one code for all three
// modes): a block computes BM = 64 * WGS buffer rows x BN = 128 output
// columns of one group,
// reducing over its share of K in 64-deep steps, with WGS consumer
// warpgroups (64 rows each) and producer_warps<WGS>().
//
// * Producer warps: keep a ring of Smem::S stages in flight, each guarded by
//   a full and an empty mbarrier. Lane 0 loads the B tiles (wi and wg in the
//   up phase, wo in the down phase) by TMA with the 128-byte swizzle, two
//   64-column boxes of [64 k][64 columns] per matrix: the (K, N) weights are
//   N-contiguous, the MN-major B operand (as V in flash_attention.cu). Each
//   B map is one 2-D map over the weights' storage (WMap: as many columns
//   as the row stride) and expert e = g % E's tile sits at (e * cs, e * rs)
//   from expert 0's (E = 1 in the dense and routed modes): moefied views
//   of a dense (D, E*Fe) wi step by Fe columns, native (E, D, Fe) stacks
//   and every wo by D (or Fe) rows. A 128-column tile that runs past an
//   expert's Fe columns reads the next expert's (or TMA's zeros past the
//   last); the up epilogue's n < F guard keeps them out of H, and D and Fe
//   are multiples of 64, so no 64-deep step crosses an expert. The A
//   tile ([BM rows][64 k], K-major) comes by TMA too (x in dense mode, H in
//   the down phase; rows past T_ are TMA's zero fill), except in the routed
//   up phase: tiled TMA cannot gather indexed rows, so the producer warps
//   gather x rows through idx with 16-byte cp.async copies (chunk c of row
//   r at chunk c ^ (r & 7): the layout TMA's swizzle writes); each thread's
//   copies arrive on the stage's full barrier when they land
//   (cp.async.mbarrier.arrive), and the consumers fence the async proxy
//   before wgmma reads them. On the H100 one warp's copies kept too few
//   bytes in flight for 128-row tiles (the routed call took ~2x the dense
//   one's time); four warps take most of that gap away (copies issued by
//   the 256 consumer threads instead did no better), and per-row TMA boxes
//   (one 128-byte box per gathered row) measured slower still (PERF.md).
// * Consumer warpgroups: wgmma.mma_async m64n128k16 (bf16 -> f32) from
//   shared memory, two accumulators (up, gate) on one A tile in the up
//   phase. One stage's products stay in flight while the next stage's are
//   issued; a stage's slot is released when its products are done.
// * Up epilogue: act(gate) * up in registers, rounded to bf16, into H
//   (G, T_, F). Down epilogue: f32 partial sums into part (split, G, T_, D):
//   the down phase's F reduction is cut into `split` parts when its row
//   tiles alone are too few to fill the card. mlp_finalize then sums the
//   parts in split order, applies the token weight and the count, rounds to
//   bf16 and (routed) scatters to the idx rows. With one part and no
//   scatter (dense and grouped modes) the down epilogue does that itself
//   (the same arithmetic, so the same bits) and dead tiles' down blocks
//   write their zeros: the (G, T_, D) f32 part never exists (143 MB at a
//   native Qwen1.5-MoE call) and there is no second launch.
// * Block order: one grid axis over (expert, column tile, batch row, row
//   tile), row tile fastest (for one expert, as in the dense and routed
//   modes: row tiles, then column tiles).
// * int8 weights (Q8: a bf16 model served with weight_dtype int8, in all
//   three modes): the TMA ring loads each B tile as int8, a
//   [64 k][128 columns] box of 8 KB (half the bf16 tile's bytes) landed
//   unswizzled in the second half of the stage's bf16 B buffer. Once the
//   stage is full the consumer warpgroups widen it, matrix by matrix, into
//   the stage's bf16 buffer in the 128-byte-swizzled layout wgmma reads
//   (chunk c of row k at c ^ (k & 7), as TMA's swizzle lays it out): each
//   thread reads its 8-byte pieces into registers, a named barrier of the
//   consumers, the exact widening stores (|q| <= 127), a proxy fence and a
//   second barrier; then the stage's wgmma run as for bf16. The stage is
//   released after its products, as before, so the bf16 buffer it writes
//   is free. The per-output-channel scales are applied in the epilogues:
//   on the up and gate accumulators before the activation, on the down
//   accumulator before the store or the partials (x (q s) = (x q) s). In
//   the routed up phase the int8 B boxes and the cp.async row gather share
//   a stage: its full barrier takes lane 0's expect_tx (the B boxes' bytes
//   only: the A tile is not TMA's) and one arrival per copier thread; the
//   consumers fence the async proxy once for the gathered rows, then widen
//   (whose closing fence covers its own stores) before wgmma.
// Tile shape and split come from the wrapper (kernels/ops.py::mlp_plan)
// and depend on the shape only; every output element is summed
// in one fixed order, no atomics, and a row's products read only that row
// of A, so a row's result does not depend on the other rows of its tile.
namespace tc {

using namespace hp;

constexpr int BN = 128;       // output columns per block: two 64-column boxes
constexpr int BOX = 64 * 64;  // elements of a [64 rows][64 columns] box (8 KB)

// producer warps: four gather the routed mode's 128-row tiles (one warp's
// copies keep too few bytes in flight); at 64-row tiles two blocks share an
// SM, which leaves registers for one
template <int WGS>
__host__ __device__ constexpr int producer_warps() {
  return WGS == 2 ? 4 : 1;
}

template <bool UP, int WGS>
struct Smem {
  // stages: an up-phase stage (x, wi, wg) is 40-48 KB; at WGS = 1 (a
  // bandwidth-bound call of few rows) two blocks share an SM
  static constexpr int S = UP && WGS == 1 ? 2 : 4;
  static constexpr int NB = UP ? 2 : 1;  // B matrices: wi, wg | wo
  bf16 a[S][WGS][BOX];    // A: [BM rows][64 k], 64 rows per warpgroup
  bf16 b[S][NB][2][BOX];  // B: per matrix two boxes of [64 k][64 columns]
  int rows[WGS * 64];     // routed up phase: x row of each buffer row, -1
  uint64_t full[S], empty[S];
};

struct Params {
  const bf16* x;    // routed up phase: the (G, S_, D) rows gathered
  const int* gidx;  // routed up phase: (G, T_) buffer row -> x row
  const int* cnt;   // (G,) live leading buffer rows
  bf16* h;          // (G, T_, F): written by the up phase
  float* part;      // (split, G, T_, D): written by the down phase
  int G, T_, S_, D, F, mt, act, gated, split;
  // experts (1 but in grouped mode), this phase's B expert step (WMap) and
  // column tiles; out and tw: the down phase's direct store (one part, no
  // scatter), else NULL
  int E, bcs, brs, nt;
  bf16* out;
  const float* tw;
  // int8 weights: the f32 scales of this phase's B matrices (up: wi, wg;
  // down: wo), N per expert
  const float* bs[2];
};

// Where a phase's B matrix lies (wi and wg share one): a 2-D map of `rows`
// rows of `cols` elements (cols = the row stride), expert e's (K, N) tile
// at column and row offset (e * cs, e * rs) from expert 0's. The dense and
// routed modes: one matrix, {N, K, 0, 0}.
struct WMap {
  int cols, rows, cs, rs;
};

// D(64 x 128) += A(64 x 16) B(16 x 128); A K-major, B MN-major, both from
// shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Named barrier 1 over the block's `n` consumer threads (the producer
// warps do not take part).
__device__ __forceinline__ void consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Q8: widens stage buffer `b` (its first `nb` matrices of two boxes; each
// matrix's int8 [64 k][128 columns] tile in its second box) into the bf16
// boxes, 128-byte swizzled; thread `ct` of the `CT` consumers. Ends with
// the tiles complete and visible to wgmma.
template <int CT, int NB>
__device__ __forceinline__ void widen_b(bf16 (*b)[2][BOX], int nb, int ct) {
  constexpr int IT = 64 * 16 / CT;  // 8-element pieces per thread a matrix
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    if (m >= nb) break;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(b[m][1]);
    uint2 v[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int j = ct + it * CT;  // row j / 16, piece j % 16
      v[it] = *reinterpret_cast<const uint2*>(src + (j >> 4) * 128 +
                                              (j & 15) * 8);
    }
    consumer_sync(CT);  // every piece of matrix m read before any store
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int j = ct + it * CT, r = j >> 4, c = j & 15;
      const uint32_t w[2] = {v[it].x, v[it].y};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t word = w[e / 2] >> (16 * (e % 2));
        __nv_bfloat162 h = __floats2bfloat162_rn((float)(int8_t)word,
                                                 (float)(int8_t)(word >> 8));
        o[e] = *reinterpret_cast<uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(b[m][c >> 3] + r * 64 +
                                (((c & 7) ^ (r & 7)) << 3)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  fence_proxy_async();  // the stores, for wgmma
  consumer_sync(CT);
}

// Grid: (G * mt row tiles * N / 128 column tiles, 1, split). ta: the A
// map, 3-D (K, T_, G); tb0 / tb1: the B maps, 2-D over every expert's
// (N, K) tile (WMap; tb1: wg, gated up only); int8 B maps (Q8) have
// [64 k][128 columns] unswizzled boxes.
template <bool UP, int WGS, bool Q8>
__global__ void __launch_bounds__(WGS * 128 + producer_warps<WGS>() * 32,
                                  WGS == 1 ? 2 : 1) mlp_tc(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb0,
    const __grid_constant__ CUtensorMap tb1, const Params p) {
  using Sm = Smem<UP, WGS>;
  constexpr int S = Sm::S;
  constexpr int BM = 64 * WGS;
  constexpr int PT = producer_warps<WGS>() * 32;  // producer threads
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // blockIdx.x runs over (expert, column tile, batch row, row tile), row
  // tile fastest (E = 1 outside grouped mode: column tile, group, row
  // tile): the row tiles sharing an expert's weight tile run together, and
  // one expert's rows stay in L2 across its column tiles (the native MoE's
  // 60 experts hold ~94 MB of x and H: a column-major sweep over every
  // group would read them from memory once per column tile)
  int blk = blockIdx.x;
  const int t = blk % p.mt, B = p.G / p.E;
  blk /= p.mt;
  const int b = blk % B;
  blk /= B;
  const int ex = blk / p.nt;  // the expert (0 outside grouped mode)
  const int g = b * p.E + ex, m0 = t * BM, n0 = (blk % p.nt) * BN;
  if (m0 >= p.cnt[g]) {  // dead tile: no work
    if (!UP && p.out != nullptr) {  // direct store: its zeros
      const int rows = min(BM, p.T_ - m0), q = min(BN, p.D - n0) / 8;
      bf16* ob = p.out + ((long)g * p.T_ + m0) * p.D + n0;
      for (int i = threadIdx.x; i < rows * q; i += blockDim.x)
        *reinterpret_cast<uint4*>(ob + (long)(i / q) * p.D + i % q * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;  // else mlp_finalize writes its zeros
  }
  const int ks = (UP ? p.D : p.F) / 64;  // 64-deep steps of the reduction
  const int kb = (int)((long)blockIdx.z * ks / p.split);
  const int nk = (int)((long)(blockIdx.z + 1) * ks / p.split) - kb;
  const bool routed = UP && p.gidx != nullptr;
  const bool two = UP && p.gated;  // a second B matrix (the gate)
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], routed ? 1 + PT : 1);  // + each copier
      mbar_init(&sm.empty[s], 4 * WGS);         // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (routed)
    for (int r = tid; r < BM; r += blockDim.x) {
      const int m = m0 + r;
      sm.rows[r] = m < p.T_ ? min(max(p.gidx[(long)g * p.T_ + m], 0),
                                  p.S_ - 1)
                            : -1;
    }
  __syncthreads();

  if (tid >= WGS * 128) {  // the producer warps
    const int lane = tid - WGS * 128;  // 0 .. PT - 1
    if (!routed && lane >= 32) return;  // TMA needs one thread
    const int tx = (routed ? 0 : BM * 64 * 2) +
                   (two ? 2 : 1) * (Q8 ? BOX * 2 : 2 * BOX * 2);
    const bf16* xb = routed ? p.x + (long)g * p.S_ * p.D : nullptr;
    const int bn = n0 + ex * p.bcs, bk = ex * p.brs;  // this expert's tile
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      mbar_wait(&sm.empty[s], ((i / S) & 1) ^ 1);  // slot consumed
      const int k0 = (kb + i) * 64;
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], tx);
        if (!routed) tma_load(sm.a[s][0], &ta, &sm.full[s], k0, m0, g);
        if constexpr (Q8) {  // one int8 box per matrix, in its second box
          tma_load(sm.b[s][0][1], &tb0, &sm.full[s], bn, bk + k0);
          if (UP && two)
            tma_load(sm.b[s][1][1], &tb1, &sm.full[s], bn, bk + k0);
        } else {
          tma_load(sm.b[s][0][0], &tb0, &sm.full[s], bn, bk + k0);
          tma_load(sm.b[s][0][1], &tb0, &sm.full[s], bn + 64, bk + k0);
          if constexpr (UP) {
            if (two) {
              tma_load(sm.b[s][1][0], &tb1, &sm.full[s], bn, bk + k0);
              tma_load(sm.b[s][1][1], &tb1, &sm.full[s], bn + 64, bk + k0);
            }
          }
        }
      }
      if (routed) {  // threads 8j .. 8j + 7: the 8 chunks of row j, ...
        const int ch = lane & 7;
        bf16* a = sm.a[s][0];
        for (int r = lane >> 3; r < BM; r += PT / 8) {
          const int xr = sm.rows[r];
          cp_async16_or_zero(a + r * 64 + ((ch ^ (r & 7)) << 3),
                             xb + (long)max(xr, 0) * p.D + k0 + ch * 8,
                             xr >= 0 ? 16 : 0);
        }
        cp_arrive_noinc(&sm.full[s]);  // once this lane's copies landed
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 * wg .. + 63
  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
  float acc[64];           // x wi (up) or H wo (down)
  float acg[UP ? 64 : 1];  // x wg (gated up)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (UP ? 64 : 1); ++i) acg[i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    mbar_wait(&sm.full[s], (i / S) & 1);
    if (routed) fence_proxy_async();  // the gathered rows, for wgmma
    if constexpr (Q8) widen_b<WGS * 128, Sm::NB>(sm.b[s], two ? 2 : 1, tid);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(sm.a[s][wg] + kk * 16, 16, 1024);
      wgmma_n128(acc, da, desc(sm.b[s][0][0] + kk * 16 * 64, BOX * 2, 1024));
      // ungated: wi's product again into the unread gate accumulator, so no
      // branch sits between the wgmmas of a group (a branch there makes
      // ptxas serialise them); an ungated MLP (Whisper's, a ViT's) so does
      // a third more MMA work than it needs (PERF.md, row 2f)
      if constexpr (UP)
        wgmma_n128(acg, da, desc(sm.b[s][two ? 1 : 0][0] + kk * 16 * 64,
                                 BOX * 2, 1024));
    }
    wg_commit();
    wg_wait<1>();  // stage i - 1's products are done: free its slot
    if (i > 0 && lane == 0) mbar_arrive(&sm.empty[(i - 1) % S]);
  }
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(acg);

  // this thread's rows r0 and r0 + 8, columns 8 j + c0 + {0, 1}
  const int r0 = m0 + wg * 64 + wq * 16 + (lane >> 2);
  const int c0 = n0 + (lane & 3) * 2;
  if constexpr (Q8) {  // per-output-channel scales: (x q) s
    const int N = UP ? p.F : p.D;
    const float* s0 = p.bs[0] + (long)ex * N;
    const float* s1 = UP && two ? p.bs[1] + (long)ex * N : nullptr;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = c0 + j * 8 + e;
        if (n >= N) continue;
        const float a0 = s0[n];
        acc[j * 4 + e] *= a0, acc[j * 4 + 2 + e] *= a0;
        if (UP && two) {
          const float a1 = s1[n];
          acg[j * 4 + e] *= a1, acg[j * 4 + 2 + e] *= a1;
        }
      }
  }
  if constexpr (UP) {
    bf16* hb = p.h + (long)g * p.T_ * p.F;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + hr * 8;
      if (r >= p.T_) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = c0 + j * 8;
        if (n >= p.F) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float u = acc[j * 4 + hr * 2 + e];
          if (two) {
            const float gt = acg[j * 4 + hr * 2 + e];
            v[e] = (p.act == 0 ? rt::silu(gt) : rt::gelu_tanh(gt)) * u;
          } else {
            v[e] = p.act == 0 ? rt::silu(u) : rt::gelu_tanh(u);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(hb + (long)r * p.F + n) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  } else if (p.out != nullptr) {
    // the direct store: tw * acc in bf16, zeros past the count
    const int c = p.cnt[g];
    bf16* ob = p.out + (long)g * p.T_ * p.D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + hr * 8;
      if (r >= p.T_) continue;
      const float w = r < c && p.tw != nullptr ? p.tw[(long)g * p.T_ + r]
                                               : 1.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = c0 + j * 8;
        if (n >= p.D) continue;
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)r * p.D + n) =
            r < c ? __floats2bfloat162_rn(acc[j * 4 + hr * 2] * w,
                                          acc[j * 4 + hr * 2 + 1] * w)
                  : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  } else {
    const int live = min(p.T_, p.cnt[g]);  // rows past it are never read
    float* pb = p.part + ((long)blockIdx.z * p.G + g) * p.T_ * p.D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + hr * 8;
      if (r >= live) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = c0 + j * 8;
        if (n >= p.D) continue;
        *reinterpret_cast<float2*>(pb + (long)r * p.D + n) =
            make_float2(acc[j * 4 + hr * 2], acc[j * 4 + hr * 2 + 1]);
      }
    }
  }
}

// Output row of buffer row (g, r) = tw * (part[0] + part[1] + ...), in
// split order; rows past the count: zeros (dense), untouched (routed: the
// zero fill covers them). One thread per 4 columns.
__global__ void __launch_bounds__(256) mlp_finalize(
    const float* __restrict__ part, const int* __restrict__ gidx,
    const float* __restrict__ tw, const int* __restrict__ cnt,
    bf16* __restrict__ out, int G, int T_, int S_, int D, int split) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = D / 4;
  if (i >= (long)G * T_ * q) return;
  const long row = i / q;  // buffer row g * T_ + r
  const int col = (int)(i % q) * 4;
  const int g = (int)(row / T_), r = (int)(row % T_);
  if (r >= cnt[g]) {
    if (gidx == nullptr)
      *reinterpret_cast<uint2*>(out + row * D + col) = make_uint2(0, 0);
    return;
  }
  const long plane = (long)G * T_ * D;
  float4 a = *reinterpret_cast<const float4*>(part + row * D + col);
  for (int s = 1; s < split; ++s) {
    const float4 b =
        *reinterpret_cast<const float4*>(part + s * plane + row * D + col);
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  const float w = tw != nullptr ? tw[row] : 1.f;
  const long orow = gidx != nullptr
                        ? (long)g * S_ + min(max(gidx[row], 0), S_ - 1)
                        : row;
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * w, a.y * w);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * w, a.w * w);
  *reinterpret_cast<uint2*>(out + orow * D + col) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                 *reinterpret_cast<uint32_t*>(&hi));
}

template <bool UP, int WGS, bool Q8>
int launch_phase(const CUtensorMap& ta, const CUtensorMap& tb0,
                 const CUtensorMap& tb1, const Params& p, dim3 grid,
                 cudaStream_t stream, rt::Geom* geo) {
  const int smem = (int)sizeof(Smem<UP, WGS>) + 1024;  // + alignment slack
  const int threads = WGS * 128 + producer_warps<WGS>() * 32;
  if (geo != nullptr) return rt::record(geo, {{grid, threads, smem}});
  cudaError_t e = cudaFuncSetAttribute(
      mlp_tc<UP, WGS, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  mlp_tc<UP, WGS, Q8><<<grid, threads, smem, stream>>>(ta, tb0, tb1, p);
  return (int)cudaGetLastError();
}

// The map of a bf16 (G, rows, cols) tensor, cols contiguous: 3-D (cols,
// rows, G), boxes of 64 columns x `box_rows` rows.
CUresult map3(EncodeTiled enc, CUtensorMap* map, const void* base, int cols,
              int rows, int G, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return make_map_bf16(enc, map, base, 3, dims, strides, box);
}

// The map of a bf16 (rows, cols) weight, cols contiguous: 2-D, boxes of 64
// columns x 64 rows. int8 (q8): boxes of 128 columns x 64 rows (one B
// tile), unswizzled.
CUresult map2(EncodeTiled enc, CUtensorMap* map, const void* base, int cols,
              int rows, bool q8 = false) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (q8 ? 1 : 2)};
  if (!q8) {
    const cuuint32_t box[2] = {64, 64};
    return make_map_bf16(enc, map, base, 2, dims, strides, box);
  }
  const cuuint32_t box[2] = {128, 64}, one[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// G groups of T_ buffer rows; expert e = g % E of group g (E = 1 but in
// grouped mode) reads its B tiles through wim (wi, wg) and wom (wo). Q8:
// the weights are int8 with f32 scales sc = {wi, wg, wo} (N per expert).
template <int WGS, bool Q8>
int launch(const bf16* x, const int* gidx, const void* wi, const void* wg,
           const void* wo, const float* const* sc, const float* tw,
           const int* cnt, bf16* h, float* part, bf16* out, int G, int T_,
           int S_, int D, int F, int act, int split, int E, const WMap& wim,
           const WMap& wom, cudaStream_t stream, rt::Geom* geo) {
  constexpr int BM = 64 * WGS;
  CUtensorMap mx, mwi, mwg, mh, mwo;
  if (geo == nullptr) {  // a geometry query encodes no map
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return ERR_NO_ENCODER;
    CUresult r = map2(enc, &mwi, wi, wim.cols, wim.rows, Q8);
    if (r == CUDA_SUCCESS && wg != nullptr)
      r = map2(enc, &mwg, wg, wim.cols, wim.rows, Q8);
    if (r == CUDA_SUCCESS && gidx == nullptr)
      r = map3(enc, &mx, x, D, T_, G, BM);
    if (r == CUDA_SUCCESS) r = map3(enc, &mh, h, F, T_, G, BM);
    if (r == CUDA_SUCCESS) r = map2(enc, &mwo, wo, wom.cols, wom.rows, Q8);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
    if (wg == nullptr) mwg = mwi;   // unread
    if (gidx != nullptr) mx = mwi;  // unread: the producer gathers x rows
  }
  const int mt = (T_ + BM - 1) / BM;
  Params p{x, gidx, cnt, h, part, G, T_, S_, D, F, mt, act,
           wg != nullptr ? 1 : 0, 1, E, wim.cs, wim.rs, (F + BN - 1) / BN,
           nullptr, nullptr, {Q8 ? sc[0] : nullptr, Q8 ? sc[1] : nullptr}};
  // one grid axis over every (expert, column tile, batch row, row tile)
  int e = launch_phase<true, WGS, Q8>(mx, mwi, mwg, p, dim3(G * mt * p.nt),
                                      stream, geo);
  if (e != 0) return e;
  p.x = nullptr, p.gidx = nullptr, p.split = split;
  p.bcs = wom.cs, p.brs = wom.rs, p.nt = (D + BN - 1) / BN;
  p.bs[0] = Q8 ? sc[2] : nullptr, p.bs[1] = nullptr;
  // one part and no scatter: the down phase stores the output itself
  if (split == 1 && gidx == nullptr) p.out = out, p.tw = tw;
  e = launch_phase<false, WGS, Q8>(mh, mwo, mwo, p,
                                   dim3(G * mt * p.nt, 1, split), stream, geo);
  if (e != 0 || p.out != nullptr) return e;
  const long n = (long)G * T_ * (D / 4);
  const dim3 gf((unsigned)((n + 255) / 256));
  if (geo != nullptr) return rt::record(geo, {{gf, 256, 0}});
  mlp_finalize<<<gf, 256, 0, stream>>>(
      part, gidx, tw, cnt, out, G, T_, S_, D, split);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C entry points bound with ctypes: both phases on `stream`; `hbuf` is the
// caller's (B*T*F, B*Kb*F or B*E*C*Fe) f32 scratch. act: 0 = silu, 1 =
// tanh-GELU; wg == NULL for an ungated MLP; tw == NULL for unit token
// weights. dtype: x's (and out's) rt::DT_*; w_dtype: the weights' storage,
// with wi_s / wg_s / wo_s their f32 scales when int8, else NULL. Each
// returns the launches' cudaError_t.
static int fused_mlp_run(int dtype, int w_dtype, const void* x, const void* wi,
                         const void* wg, const void* wo, const void* wi_s,
                         const void* wg_s, const void* wo_s, const void* tw,
                         const void* cnt, void* hbuf, void* out, int B, int T,
                         int D, int F, int act, void* stream, rt::Geom* geo) {
  const Scales sc{(const float*)wi_s, (const float*)wg_s, (const float*)wo_s};
  return dispatch<false>(dtype, w_dtype, x, nullptr, wi, wg, wo, Experts{},
                         sc, tw, cnt, hbuf, out, B, T, T, D, F, act,
                         (cudaStream_t)stream, geo);
}

extern "C" int fused_mlp_launch(int dtype, int w_dtype, const void* x,
                                const void* wi, const void* wg, const void* wo,
                                const void* wi_s, const void* wg_s,
                                const void* wo_s, const void* tw,
                                const void* cnt, void* hbuf, void* out, int B,
                                int T, int D, int F, int act, void* stream) {
  return fused_mlp_run(dtype, w_dtype, x, wi, wg, wo, wi_s, wg_s, wo_s, tw,
                       cnt, hbuf, out, B, T, D, F, act, stream, nullptr);
}

// fused_mlp_launch's arguments but the stream: the launcher's host code up to
// its launches; `geom` gets rt::geometry_out's record.
extern "C" int fused_mlp_geometry(int dtype, int w_dtype, const void* x,
                                  const void* wi, const void* wg,
                                  const void* wo, const void* wi_s,
                                  const void* wg_s, const void* wo_s,
                                  const void* tw, const void* cnt, void* hbuf,
                                  void* out, int B, int T, int D, int F,
                                  int act, int* geom) {
  rt::Geom g;
  const int rc = fused_mlp_run(dtype, w_dtype, x, wi, wg, wo, wi_s, wg_s, wo_s,
                               tw, cnt, hbuf, out, B, T, D, F, act, nullptr,
                               &g);
  return rt::geometry_out(g, geom, rc);
}

// Routed mode: x and out are (B,S,D), idx (B,Kb) int32; out is zero-filled
// on the stream first, then the selected rows are written. w_dtype and the
// scales as in fused_mlp_launch.
static int fused_mlp_routed_run(int dtype, int w_dtype, const void* x,
                                const void* idx, const void* wi,
                                const void* wg, const void* wo,
                                const void* wi_s, const void* wg_s,
                                const void* wo_s, const void* tw,
                                const void* cnt, void* hbuf, void* out, int B,
                                int S, int Kb, int D, int F, int act,
                                void* stream, rt::Geom* geo) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t esz = dtype == rt::DT_BF16 ? 2 : 4;
  if (geo == nullptr) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * S * D * esz, s);
    if (e != cudaSuccess) return (int)e;
  }
  const Scales sc{(const float*)wi_s, (const float*)wg_s, (const float*)wo_s};
  return dispatch<false>(dtype, w_dtype, x, (const int*)idx, wi, wg, wo,
                         Experts{}, sc, tw, cnt, hbuf, out, B, Kb, S, D, F,
                         act, s, geo);
}

extern "C" int fused_mlp_routed_launch(int dtype, int w_dtype, const void* x,
                                       const void* idx, const void* wi,
                                       const void* wg, const void* wo,
                                       const void* wi_s, const void* wg_s,
                                       const void* wo_s, const void* tw,
                                       const void* cnt, void* hbuf, void* out,
                                       int B, int S, int Kb, int D, int F,
                                       int act, void* stream) {
  return fused_mlp_routed_run(dtype, w_dtype, x, idx, wi, wg, wo, wi_s, wg_s,
                              wo_s, tw, cnt, hbuf, out, B, S, Kb, D, F, act,
                              stream, nullptr);
}

// fused_mlp_routed_launch's arguments but the stream: the launcher's host code
// up to its launches; `geom` gets rt::geometry_out's record.
extern "C" int fused_mlp_routed_geometry(int dtype, int w_dtype, const void* x,
                                         const void* idx, const void* wi,
                                         const void* wg, const void* wo,
                                         const void* wi_s, const void* wg_s,
                                         const void* wo_s, const void* tw,
                                         const void* cnt, void* hbuf,
                                         void* out, int B, int S, int Kb,
                                         int D, int F, int act, int* geom) {
  rt::Geom g;
  const int rc = fused_mlp_routed_run(dtype, w_dtype, x, idx, wi, wg, wo, wi_s,
                                      wg_s, wo_s, tw, cnt, hbuf, out, B, S, Kb,
                                      D, F, act, nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}

// The tensor-core body of the dense and routed modes (bf16, D and F
// multiples of 64): x (G,S_,D) with S_ = T_ (dense, idx NULL) or x the
// (G,S_,D) stream and idx (G,T_) (routed: out (G,S_,D) is zero-filled on
// the stream first); h the bf16 (G,T_,F) scratch, part the f32
// (split,G,T_,D) scratch (NULL in dense mode with split 1: the down phase
// then stores the output); wgs: consumer warpgroups per block (1: 64-row
// tiles, 2: 128-row tiles); split: parts of the down phase's F reduction.
// w_dtype: rt::DT_BF16, or rt::DT_I8 for int8 weights (either mode) with
// their f32 scales wi_s / wg_s (F,) and wo_s (D,). Returns the launches'
// cudaError_t or an hp::ERR_* code.
static int fused_mlp_tc_run(int w_dtype, const void* x, const void* idx,
                            const void* wi, const void* wg, const void* wo,
                            const void* wi_s, const void* wg_s,
                            const void* wo_s, const void* tw, const void* cnt,
                            void* h, void* part, void* out, int G, int T_,
                            int S_, int D, int F, int act, int wgs, int split,
                            void* stream, rt::Geom* geo) {
  using hp::bf16;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx != nullptr && geo == nullptr) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)G * S_ * D * 2, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (G == 0 || T_ == 0) return 0;
  const bool q8 = w_dtype == rt::DT_I8;
  if (D % 64 != 0 || F % 64 != 0 || split < 1 || split > F / 64 ||
      (!q8 && w_dtype != rt::DT_BF16) ||
      (q8 && (wi_s == nullptr || wo_s == nullptr ||
              (wg != nullptr && wg_s == nullptr))))
    return (int)cudaErrorInvalidValue;
  const tc::WMap wim{F, D, 0, 0}, wom{D, F, 0, 0};
  const float* sc[3] = {(const float*)wi_s, (const float*)wg_s,
                        (const float*)wo_s};
#define TC_ARGS (const bf16*)x, (const int*)idx, wi, wg, wo, sc, \
    (const float*)tw, (const int*)cnt, (bf16*)h, (float*)part, (bf16*)out, \
    G, T_, S_, D, F, act, split, 1, wim, wom, s, geo
  if (wgs == 1) return q8 ? tc::launch<1, true>(TC_ARGS)
                          : tc::launch<1, false>(TC_ARGS);
  if (wgs == 2) return q8 ? tc::launch<2, true>(TC_ARGS)
                          : tc::launch<2, false>(TC_ARGS);
#undef TC_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_mlp_tc_launch(int w_dtype, const void* x, const void* idx,
                                   const void* wi, const void* wg,
                                   const void* wo, const void* wi_s,
                                   const void* wg_s, const void* wo_s,
                                   const void* tw, const void* cnt, void* h,
                                   void* part, void* out, int G, int T_,
                                   int S_, int D, int F, int act, int wgs,
                                   int split, void* stream) {
  return fused_mlp_tc_run(w_dtype, x, idx, wi, wg, wo, wi_s, wg_s, wo_s, tw,
                          cnt, h, part, out, G, T_, S_, D, F, act, wgs, split,
                          stream, nullptr);
}

// fused_mlp_tc_launch's arguments but the stream: the launcher's host code up
// to its launches; `geom` gets rt::geometry_out's record.
extern "C" int fused_mlp_tc_geometry(int w_dtype, const void* x,
                                     const void* idx, const void* wi,
                                     const void* wg, const void* wo,
                                     const void* wi_s, const void* wg_s,
                                     const void* wo_s, const void* tw,
                                     const void* cnt, void* h, void* part,
                                     void* out, int G, int T_, int S_, int D,
                                     int F, int act, int wgs, int split,
                                     int* geom) {
  rt::Geom g;
  const int rc = fused_mlp_tc_run(w_dtype, x, idx, wi, wg, wo, wi_s, wg_s, wo_s,
                                  tw, cnt, h, part, out, G, T_, S_, D, F, act,
                                  wgs, split, nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}

// Grouped-expert mode: x and out are (B,E,C,D); strides in elements (wg,
// when given, has wi's); `cnt` (B*E) int32 counts clipped to [0, C]; w
// (B*E*C) f32 or NULL; w_dtype and the scales as in fused_mlp_launch, the
// scales contiguous (E,Fe) / (E,D).
static int moe_gmm_run(int dtype, int w_dtype, const void* x, const void* wi,
                       const void* wg, const void* wo, const void* wi_s,
                       const void* wg_s, const void* wo_s, long long w_es,
                       long long w_rs, long long wo_es, long long wo_rs,
                       const void* w, const void* cnt, void* hbuf, void* out,
                       int B, int E, int C, int D, int Fe, int act,
                       void* stream, rt::Geom* geo) {
  const Experts ex{E, w_es, w_rs, wo_es, wo_rs};
  const Scales sc{(const float*)wi_s, (const float*)wg_s, (const float*)wo_s};
  return dispatch<true>(dtype, w_dtype, x, nullptr, wi, wg, wo, ex, sc, w,
                        cnt, hbuf, out, B * E, C, C, D, Fe, act,
                        (cudaStream_t)stream, geo);
}

extern "C" int moe_gmm_launch(int dtype, int w_dtype, const void* x,
                              const void* wi, const void* wg, const void* wo,
                              const void* wi_s, const void* wg_s,
                              const void* wo_s, long long w_es, long long w_rs,
                              long long wo_es, long long wo_rs, const void* w,
                              const void* cnt, void* hbuf, void* out, int B,
                              int E, int C, int D, int Fe, int act,
                              void* stream) {
  return moe_gmm_run(dtype, w_dtype, x, wi, wg, wo, wi_s, wg_s, wo_s, w_es,
                     w_rs, wo_es, wo_rs, w, cnt, hbuf, out, B, E, C, D, Fe,
                     act, stream, nullptr);
}

// moe_gmm_launch's arguments but the stream: the launcher's host code up to its
// launches; `geom` gets rt::geometry_out's record.
extern "C" int moe_gmm_geometry(int dtype, int w_dtype, const void* x,
                                const void* wi, const void* wg, const void* wo,
                                const void* wi_s, const void* wg_s,
                                const void* wo_s, long long w_es,
                                long long w_rs, long long wo_es,
                                long long wo_rs, const void* w,
                                const void* cnt, void* hbuf, void* out, int B,
                                int E, int C, int D, int Fe, int act,
                                int* geom) {
  rt::Geom g;
  const int rc = moe_gmm_run(dtype, w_dtype, x, wi, wg, wo, wi_s, wg_s, wo_s,
                             w_es, w_rs, wo_es, wo_rs, w, cnt, hbuf, out, B, E,
                             C, D, Fe, act, nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}

// The tensor-core body of the grouped-expert mode (bf16, D and Fe multiples
// of 64): x and out (B,E,C,D), expert e = g % E of group g = b*E + e; h
// the bf16 (B*E,C,Fe) scratch, part the f32 (split,B*E,C,D) scratch
// (NULL when split is 1: the down phase then stores the output); `cnt`
// (B*E) int32 counts clipped to [0, C]; w (B*E*C) f32 or NULL; wgs and
// split as in fused_mlp_tc_launch. wi (and wg, in wi's layout) and wo are
// read in place through 2-D maps of wi_rows x wi_cols and wo_rows x
// wo_cols elements (cols = the row stride), expert e's tile at column and
// row offset (e * *_cs, e * *_rs) (kernels/ops.py::gmm_map derives them
// from the strides). w_dtype and the scales as in fused_mlp_tc_launch, the
// scales (E,Fe) / (E,D) contiguous. Returns the launches' cudaError_t or
// an hp::ERR_* code.
static int moe_gmm_tc_run(int w_dtype, const void* x, const void* wi,
                          const void* wg, const void* wo, const void* wi_s,
                          const void* wg_s, const void* wo_s, const void* w,
                          const void* cnt, void* h, void* part, void* out,
                          int B, int E, int C, int D, int Fe, int act, int wgs,
                          int split, int wi_cols, int wi_rows, int wi_cs,
                          int wi_rs, int wo_cols, int wo_rows, int wo_cs,
                          int wo_rs, void* stream, rt::Geom* geo) {
  using hp::bf16;
  if (B * E == 0 || C == 0) return 0;
  const bool q8 = w_dtype == rt::DT_I8;
  if (D % 64 != 0 || Fe % 64 != 0 || split < 1 || split > Fe / 64 ||
      (!q8 && w_dtype != rt::DT_BF16) ||
      (q8 && (wi_s == nullptr || wo_s == nullptr ||
              (wg != nullptr && wg_s == nullptr))))
    return (int)cudaErrorInvalidValue;
  const tc::WMap wim{wi_cols, wi_rows, wi_cs, wi_rs};
  const tc::WMap wom{wo_cols, wo_rows, wo_cs, wo_rs};
  const float* sc[3] = {(const float*)wi_s, (const float*)wg_s,
                        (const float*)wo_s};
#define TC_ARGS (const bf16*)x, nullptr, wi, wg, wo, sc, (const float*)w, \
    (const int*)cnt, (bf16*)h, (float*)part, (bf16*)out, B * E, C, C, D, \
    Fe, act, split, E, wim, wom, (cudaStream_t)stream, geo
  if (wgs == 1) return q8 ? tc::launch<1, true>(TC_ARGS)
                          : tc::launch<1, false>(TC_ARGS);
  if (wgs == 2) return q8 ? tc::launch<2, true>(TC_ARGS)
                          : tc::launch<2, false>(TC_ARGS);
#undef TC_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int moe_gmm_tc_launch(int w_dtype, const void* x, const void* wi,
                                 const void* wg, const void* wo,
                                 const void* wi_s, const void* wg_s,
                                 const void* wo_s, const void* w,
                                 const void* cnt, void* h, void* part,
                                 void* out, int B, int E, int C, int D, int Fe,
                                 int act, int wgs, int split, int wi_cols,
                                 int wi_rows, int wi_cs, int wi_rs,
                                 int wo_cols, int wo_rows, int wo_cs,
                                 int wo_rs, void* stream) {
  return moe_gmm_tc_run(w_dtype, x, wi, wg, wo, wi_s, wg_s, wo_s, w, cnt, h,
                        part, out, B, E, C, D, Fe, act, wgs, split, wi_cols,
                        wi_rows, wi_cs, wi_rs, wo_cols, wo_rows, wo_cs, wo_rs,
                        stream, nullptr);
}

// moe_gmm_tc_launch's arguments but the stream: the launcher's host code up to
// its launches; `geom` gets rt::geometry_out's record.
extern "C" int moe_gmm_tc_geometry(int w_dtype, const void* x, const void* wi,
                                   const void* wg, const void* wo,
                                   const void* wi_s, const void* wg_s,
                                   const void* wo_s, const void* w,
                                   const void* cnt, void* h, void* part,
                                   void* out, int B, int E, int C, int D,
                                   int Fe, int act, int wgs, int split,
                                   int wi_cols, int wi_rows, int wi_cs,
                                   int wi_rs, int wo_cols, int wo_rows,
                                   int wo_cs, int wo_rs, int* geom) {
  rt::Geom g;
  const int rc = moe_gmm_tc_run(w_dtype, x, wi, wg, wo, wi_s, wg_s, wo_s, w,
                                cnt, h, part, out, B, E, C, D, Fe, act, wgs,
                                split, wi_cols, wi_rows, wi_cs, wi_rs, wo_cols,
                                wo_rows, wo_cs, wo_rs, nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}
