// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention of the
// JAX package. q (B,Sq,H,Dh), k/v (B,Sk,K,Dh) row-major, f32 or bf16 in,
// f32 accumulation, q's type out. Causal and window masks by ARRAY INDEX, a
// per-key validity mask kv_valid (B,Sk) and a ragged per-row count
// kv_count (B,) (null: every row is real): key tiles past the count are
// skipped, query rows past it are written as zeros. GQA maps q-head h to
// kv-head h / (H / K).
//
// A query row with NO attendable key is written as exact zeros (the Pallas
// kernel leaves it undefined); the port's plain version does the same.
//
// Bound on the H100 at the paths' shapes: the causal prefills and training
// steps (Sq = Sk <= 1024, Dh = 128; ~4*Dh*Sq*Sk/2 FLOPs against ~4*S*H*Dh
// bytes), the non-causal encoder self-attention (Whisper: Sq = Sk = 1500,
// Dh = 64, ~4*Dh*S^2 FLOPs) and the cross-attention of a prompt against
// the image tokens (Sq = 17 .. 512 against Sk = 1601 or 961, Dh = 128) are
// bound by the tensor-core rate; a decode-length query (Sq = 1 .. 16)
// against 1601 keys reads ~4*Sk*K*Dh bytes for ~4*Dh*Sk*H FLOPs and is
// bound by the bytes. Two bodies, chosen by type and head width:
//
// * bf16, Dh 64 / 128 / 256 (every path of the port): tensor cores. One
//   block per (64-row q-tile, q-head, batch row): one consumer warpgroup (128 threads)
//   plus one producer warp (two warpgroups on a 128-row tile measured
//   slower at the paths' shapes; see PERF.md). The producer's single
//   thread issues TMA loads (128-byte swizzle, 4-D tensor
//   maps over (Dh, heads, S, B), passed as __grid_constant__ parameters) of
//   the q-tile once and of each 64-key K/V tile into a 2-stage shared-memory
//   ring guarded by mbarriers, so tile j+1 loads while tile j multiplies.
//   The consumers run S = Q K^T as wgmma.mma_async (bf16 -> f32, Q and K
//   both K-major from shared memory), mask and run the online softmax on
//   the f32 accumulator fragments in registers, round P to bf16 in
//   registers as the A operand of O += P V (V's tile is [keys x Dh], Dh
//   contiguous: the transposed, MN-major B operand), and write O / l
//   straight from the fragments. At Dh 256 (RecurrentGemma) the O
//   accumulator is 128 f32 registers a thread, filled by two m64n128 wgmmas
//   over V's column halves, and the 2-stage ring takes ~160 KB of shared
//   memory. Keys past Sk come in as TMA's zero fill
//   and are masked to -inf with every other dead key (the producer warp
//   votes each tile's count-and-valid key mask into one word beside it;
//   rows intersect it with their causal/window span as bit sets); tiles
//   dead by causality, window or count are never loaded. The grid runs the
//   q-tiles with the most causal key tiles first (non-causal, every q-tile
//   loads every key tile; a q-tile past Sq is TMA's zero fill, its rows
//   never stored). No atomics and no split
//   of the key loop, and the arithmetic is the same whether kv_valid is
//   null or all true, so outputs are reproducible bit for bit. An int8 K/V
//   operand would be dequantized between the TMA load and the wgmma.
// * f32 at any Dh (Dh 256: ~215 KB of shared memory), bf16 at Dh 16 / 32:
//   the first, CUDA-core body (Q, K^T, V tiles converted to f32 in shared
//   memory, f32 FMAs). f32 stays off the
//   tensor cores on purpose: TF32 would break the 1e-4 tolerance that the
//   f32 gradient check and the f32 card cases hold; 16 and 32 are the toy
//   widths, below one 64-column swizzle atom.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------ CUDA-core body ------------------------------
//
// One block per (q-tile of 64 rows, head, batch row), 256 threads; the
// online-softmax state in registers and shared memory, K stored transposed.

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1)     // Qs
         + DH * (BK + 1)   // Kt (transposed K tile)
         + BK * DH         // Vs
         + BQ * (BK + 1)   // Ss (scores, then probabilities)
         + 2 * BQ;         // per-row rescale factor and final row sum
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, const uint8_t* __restrict__ kv_valid,
    const int* __restrict__ kv_count, int Sq, int Sk, int H, int K,
    int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int QST = DH + 1;
  constexpr int KST = BK + 1;
  constexpr int OC = DH / 16;  // output columns per thread
  float* Qs = smem;
  float* Kt = Qs + BQ * QST;
  float* Vs = Kt + DH * KST;
  float* Ss = Vs + BK * DH;
  float* row_alpha = Ss + BQ * KST;
  float* row_l = row_alpha + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int cnt = kv_count ? kv_count[b] : max(Sq, Sk);  // null: no count
  const long qs = (long)H * DH;   // row stride of q / out
  const long ks = (long)K * DH;   // row stride of k / v
  const T* qb = q + (long)b * Sq * qs + (long)h * DH;
  const T* kb = k + (long)b * Sk * ks + (long)kh * DH;
  const T* vb = v + (long)b * Sk * ks + (long)kh * DH;
  T* ob = out + (long)b * Sq * qs + (long)h * DH;
  const uint8_t* valid = kv_valid ? kv_valid + (long)b * Sk : nullptr;

  // thread tiles: rows ty + 16*i, columns tx + 16*j (strided: no bank
  // conflicts on the shared-memory reads of the inner loops)
  const int ty = tid / 16, tx = tid % 16;

  if (q0 >= cnt) {  // whole query tile past the ragged count
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r >= Sq) continue;
      for (int j = 0; j < OC; ++j)
        ob[r * qs + tx + 16 * j] = rt::from_f<T>(0.f);
    }
    return;
  }

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    Qs[r * QST + d] = (q0 + r < Sq) ? rt::to_f(qb[(q0 + r) * qs + d]) : 0.f;
  }

  // softmax state of row `srow`, replicated over its 4 owner threads
  const int srow = tid >> 2, ssub = tid & 3;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;

  int n_kt = (min(Sk, cnt) + BK - 1) / BK;        // tiles past the count
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // above diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (window > 0 && q0 - (k0 + BK - 1) >= window) continue;  // out of window
    __syncthreads();  // the previous tile's Kt / Vs / Ss are consumed
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int c = idx / DH, d = idx % DH;
      const bool in = k0 + c < Sk;
      Kt[d * KST + c] = in ? rt::to_f(kb[(k0 + c) * ks + d]) : 0.f;
      Vs[c * DH + d] = in ? rt::to_f(vb[(k0 + c) * ks + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T on this tile, masked; rows ty*4+i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QST + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Kt[d * KST + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        bool ok = kj < Sk && kj < cnt;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && (qi - kj) < window;
        if (valid != nullptr) ok = ok && kj < Sk && valid[kj] != 0;
        Ss[r * KST + c] = ok ? s[i][j] * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row, 16 keys each
    {
      float* sr = Ss + srow * KST + ssub * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, sr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const bool none = m_new == -INFINITY;   // no key for this row yet
      const float alpha = none ? 1.f : expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = none ? 0.f : expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (ssub == 0) row_alpha[srow] = alpha;
    }
    __syncthreads();

    // O = alpha * O + P V; rows ty*4+i, columns tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = row_alpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * KST + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = Vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

  if (ssub == 0) row_l[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = row_l[r];
    const bool live = qi < cnt && l > 0.f;   // l >= 1 once a key is attended
#pragma unroll
    for (int j = 0; j < OC; ++j)
      ob[qi * qs + tx + 16 * j] = rt::from_f<T>(live ? acc[i][j] / l : 0.f);
  }
}

template <typename T, int DH>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                const uint8_t* kv_valid, const int* kv_count, int B, int Sq,
                int Sk, int H, int K, int causal, int window, float sm_scale,
                cudaStream_t stream, rt::Geom* geo) {
  const int smem = smem_floats<DH>() * (int)sizeof(float);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  if (geo != nullptr) return rt::record(geo, {{grid, NT, smem}});
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_simt<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_simt<T, DH><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, kv_valid, kv_count, Sq,
      Sk, H, K, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

// ----------------------------- tensor-core body -----------------------------

namespace tc {

using namespace hp;

constexpr int BQ = 64;       // query rows per block: one consumer warpgroup
constexpr int BK = 64;       // keys per K/V tile
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int NT = 128 + 32;  // the consumer warpgroup + a producer warp
constexpr int HALF = 64 * 64;  // elements of a [64 rows][64 columns] box

// Every box is 8 KB written by TMA with the 128-byte swizzle and starts on
// a 1024-byte boundary (the swizzle atom) given a 1024-aligned base.
template <int DH>
struct Smem {
  bf16 q[DH / 64][HALF];
  bf16 k[STAGES][DH / 64][HALF];
  bf16 v[STAGES][DH / 64][HALF];
  uint64_t key_ok[STAGES];     // bit c: key c of the tile is inside the
                               // count and valid
  uint64_t q_full, full[STAGES], empty[STAGES];
};

// The accumulator fragment of m64nNk16 (f32): register 4*j + e of thread
// (warp w, lane l) is row 16*w + l/4 + 8*(e/2), column 8*j + 2*(l%4) + e%2.
// The bf16 A fragment of m64k16 takes, per 16-column step, the same rows
// and columns in the same order, so S's fragment becomes P's operand in
// registers.

// D(64 x N) (+)= A(64 x 16) B(16 x N); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x N) += A(64 x 16) B(16 x N); A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[OFF .. OFF + 63]: one 128-column half of a Dh 256 accumulator, or all
// of a Dh 128 one.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Bits lo .. hi of a 64-bit word (none when lo > hi), clamped to 0 .. 63.
__device__ __forceinline__ uint64_t span(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 63);
  return lo > hi ? 0ull : (~0ull >> (63 - hi)) & (~0ull << lo);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(NT) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
    const uint8_t* __restrict__ kv_valid, const int* __restrict__ kv_count,
    int Sq, int Sk, int H, int K, int causal, int window, float scale_log2) {
  constexpr int NH = DH / 64;  // 64-column boxes per row
  constexpr int NO = DH / 2;   // O accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int kh = h / (H / K);
  const int cnt = kv_count ? kv_count[b] : max(Sq, Sk);  // null: no count
  const int tid = threadIdx.x;
  const long qs = (long)H * DH;  // row stride of q / out
  bf16* ob = out + (long)b * Sq * qs + (long)h * DH;

  if (q0 >= cnt) {  // whole query tile past the ragged count
    for (int i = tid; i < BQ * DH / 8; i += NT) {
      const int r = q0 + i / (DH / 8), c = (i % (DH / 8)) * 8;
      if (r < Sq)
        *reinterpret_cast<uint4*>(ob + r * qs + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int klim = min(Sk, cnt);
  int kt_hi = (klim + BK - 1) / BK;                         // past the count
  if (causal) kt_hi = min(kt_hi, (q0 + BQ - 1) / BK + 1);   // above diagonal
  int kt_lo = 0;                                            // out of window
  if (window > 0)
    while (kt_lo < kt_hi && q0 - (kt_lo * BK + BK - 1) >= window) ++kt_lo;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp
    // the warp votes each tile's row-independent key mask (inside the
    // count, valid) into one word beside it; lane 0 issues the TMA loads
    const int lane = tid - 128;
    const uint8_t* valid = kv_valid ? kv_valid + (long)b * Sk : nullptr;
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, BQ * DH * 2);
      for (int c = 0; c < NH; ++c)
        tma_load(sm.q[c], &tq, &sm.q_full, c * 64, h, q0, b);
    }
    for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
      const int s = i % STAGES;
      mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);  // slot consumed
      const int k0 = kt * BK + lane, k1 = k0 + 32;
      const uint32_t lo = __ballot_sync(
          0xffffffffu, k0 < klim && (valid == nullptr || valid[k0] != 0));
      const uint32_t hi = __ballot_sync(
          0xffffffffu, k1 < klim && (valid == nullptr || valid[k1] != 0));
      if (lane == 0) {
        sm.key_ok[s] = (uint64_t)hi << 32 | lo;
        mbar_expect_tx(&sm.full[s], 2 * BK * DH * 2);  // releases key_ok
        for (int c = 0; c < NH; ++c) {
          tma_load(sm.k[s][c], &tk, &sm.full[s], c * 64, kh, kt * BK, b);
          tma_load(sm.v[s][c], &tv, &sm.full[s], c * 64, kh, kt * BK, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup (rows q0 .. q0 + 63): this thread's rows q0 + rr
  // and q0 + rr + 8, columns 2*(lane%4) + {0, 1} of every 8-column group
  const int lane = tid & 31;
  const int rr = (tid >> 5) * 16 + (lane >> 2), cc = (lane & 3) * 2;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(&sm.q_full, 0);

  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    mbar_wait(&sm.full[s], (i / STAGES) & 1);

    // S = Q K^T on this tile (Dh / 16 k-steps of 32 bytes in a 128-byte row)
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(sc, desc(sm.q[kk / 4] + (kk % 4) * 16, 16, 1024),
                   desc(sm.k[s][kk / 4] + (kk % 4) * 16, 16, 1024), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // masks as bit sets, without branches: row qi may attend columns
    // [qi - window + 1, qi] - k0 of the tile (causal, window) among the
    // key mask's
    const int k0 = kt * BK;
    uint64_t rowm[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + rr + hr * 8;
      rowm[hr] = (sm.key_ok[s] &
                  span(window > 0 ? qi - window + 1 - k0 : 0,
                       causal ? qi - k0 : BK - 1)) >> cc;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!((rowm[e >> 1] >> (j * 8 + (e & 1))) & 1))
          sc[j * 4 + e] = -INFINITY;

    // online softmax in base 2 (scale_log2 = sm_scale * log2 e, folded into
    // one FMA per score); a row's 4 owner threads are lanes 4r .. 4r + 3
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[j * 4 + 2 * hr], sc[j * 4 + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const bool none = m_new == -INFINITY;  // no key for this row yet
      const float base = none ? 0.f : m_new * scale_log2;
      alpha[hr] = none ? 1.f : ex2(m_run[hr] * scale_log2 - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = j * 4 + 2 * hr + e;
          sc[x] = ex2(fmaf(sc[x], scale_log2, -base));  // -inf -> 0
          sum += sc[x];
        }
      l_run[hr] = l_run[hr] * alpha[hr] + sum;  // this thread's columns
      m_run[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[j * 4 + 0] *= alpha[0];
      o[j * 4 + 1] *= alpha[0];
      o[j * 4 + 2] *= alpha[1];
      o[j * 4 + 3] *= alpha[1];
    }

    // O += P V: P's fragment to bf16 A operands, one per 16 keys
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[kk * 8 + r * 2], sc[kk * 8 + r * 2 + 1]);
    wg_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(sm.v[s][0] + kk * 16 * 64, BK * 128, 1024);
      if constexpr (DH == 256) {  // two 128-column halves, boxes 0-1 and 2-3
        wgmma_rs_n128<0>(o, pa[kk], dv);
        wgmma_rs_n128<64>(
            o, pa[kk], desc(sm.v[s][2] + kk * 16 * 64, BK * 128, 1024));
      } else if constexpr (DH == 128) {
        wgmma_rs_n128<0>(o, pa[kk], dv);
      } else {
        wgmma_rs_n64(o, pa[kk], dv);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // K/V slot free
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + rr + hr * 8;
    const bool live = qi < cnt && l > 0.f;  // l >= 1 once a key is attended
    const float inv = live ? 1.f / l : 0.f;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * qs + j * 8 + cc) =
          __floats2bfloat162_rn(live ? o[j * 4 + 2 * hr] * inv : 0.f,
                                live ? o[j * 4 + 2 * hr + 1] * inv : 0.f);
  }
}

// The map of a bf16 (B, S, heads, DH) tensor: 4-D (DH, heads, S, B), boxes
// of 64 columns x 1 head x 64 rows, 128-byte swizzle, zeros out of bounds.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* base,
                  int DH, int heads, int S, int B) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)heads * DH * 2,
                                 (cuuint64_t)S * heads * DH * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return make_map_bf16(enc, map, base, 4, dims, strides, box);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           const uint8_t* kv_valid, const int* kv_count, int B, int Sq,
           int Sk, int H, int K, int causal, int window, float sm_scale,
           cudaStream_t stream, rt::Geom* geo) {
  const int smem = (int)sizeof(Smem<DH>) + 1024;  // + alignment slack
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  if (geo != nullptr) return rt::record(geo, {{grid, NT, smem}});
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(enc, &mq, q, DH, H, Sq, B);
  if (r == CUDA_SUCCESS) r = make_map(enc, &mk, k, DH, K, Sk, B);
  if (r == CUDA_SUCCESS) r = make_map(enc, &mv, v, DH, K, Sk, B);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wgmma<DH><<<grid, NT, smem, stream>>>(
      mq, mk, mv, (bf16*)out, kv_valid, kv_count, Sq, Sk, H, K, causal,
      window, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The body for (dtype, dh), launched (geo NULL) or asked for its geometry.
int run(int dtype, int dh, const void* q, const void* k, const void* v,
        void* out, const void* kv_valid, const void* kv_count, int B, int Sq,
        int Sk, int H, int K, int causal, int window, float sm_scale,
        void* stream, rt::Geom* geo) {
  const uint8_t* valid = (const uint8_t*)kv_valid;
  const int* cnt = (const int*)kv_count;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_ARGS q, k, v, out, valid, cnt, B, Sq, Sk, H, K, causal, window, \
                   sm_scale, s, geo
  if (dtype == rt::DT_F32) {
    switch (dh) {
      case 16: return launch_simt<float, 16>(FLASH_ARGS);
      case 32: return launch_simt<float, 32>(FLASH_ARGS);
      case 64: return launch_simt<float, 64>(FLASH_ARGS);
      case 128: return launch_simt<float, 128>(FLASH_ARGS);
      case 256: return launch_simt<float, 256>(FLASH_ARGS);
    }
  } else if (dtype == rt::DT_BF16) {
    switch (dh) {
      case 16: return launch_simt<__nv_bfloat16, 16>(FLASH_ARGS);
      case 32: return launch_simt<__nv_bfloat16, 32>(FLASH_ARGS);
      case 64: return tc::launch<64>(FLASH_ARGS);
      case 128: return tc::launch<128>(FLASH_ARGS);
      case 256: return tc::launch<256>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point bound with ctypes. Returns the launch's cudaError_t (or a
// hp::ERR_* code, csrc/hopper.cuh).
extern "C" int flash_attention_launch(int dtype, int dh, const void* q,
                                      const void* k, const void* v, void* out,
                                      const void* kv_valid,
                                      const void* kv_count, int B, int Sq,
                                      int Sk, int H, int K, int causal,
                                      int window, float sm_scale,
                                      void* stream) {
  return run(dtype, dh, q, k, v, out, kv_valid, kv_count, B, Sq, Sk, H, K,
             causal, window, sm_scale, stream, nullptr);
}

// flash_attention_launch's arguments but the stream: the launcher's host
// code up to its launch; `geom` gets rt::geometry_out's record.
extern "C" int flash_attention_geometry(int dtype, int dh, const void* q,
                                        const void* k, const void* v,
                                        void* out, const void* kv_valid,
                                        const void* kv_count, int B, int Sq,
                                        int Sk, int H, int K, int causal,
                                        int window, float sm_scale,
                                        int* geom) {
  rt::Geom g;
  const int rc = run(dtype, dh, q, k, v, out, kv_valid, kv_count, B, Sq, Sk,
                     H, K, causal, window, sm_scale, nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}
