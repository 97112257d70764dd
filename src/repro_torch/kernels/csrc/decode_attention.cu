// Decode attention for Hopper (sm_90a), hand-written CUDA C++: one body, two
// modes, which differ only in how key j of a slot is addressed and masked
// (the Keys policies below).
//
// Ring mode replaces the TPU kernel kernels/decode_attention.py::
// decode_attention of the JAX package. One query token per serving slot: q
// (B,1,H,Dh) against the ring cache k/v (B,L,K,Dh). The ring is not
// position-ordered, so keys are masked by their ABSOLUTE position kv_pos
// (B,L) (-1 = empty slot): slot j is attendable iff 0 <= kv_pos[b,j] <= t[b],
// t[b] - kv_pos[b,j] < window (when windowed) and kv_valid[b,j] (token
// routing).
//
// Paged mode replaces kernels/paged_decode_attention.py::
// paged_decode_attention. K/V live in a global page pool kp/vp
// (N,ps,K,Dh); slot b owns the pages of its page-table row table[b]
// (B,P) (-1 = unused entry), and positions are implicit: key j of slot b
// is row table[b, j/ps] * ps + j%ps of the pool, attendable iff the entry
// is >= 0, j <= t[b] and pvalid[entry, j%ps] (token routing). Keys past
// t[b] are never visited, and a key whose entry is -1 is skipped on one
// load of the (cached) entry, so unused and future pages cost no K/V
// reads. The TPU kernel ran a (B, H, P) grid with the table in scalar
// prefetch and the softmax state carried across the page axis.
//
// Head dims 32, 64, 128 and 256 (RecurrentGemma: one kv-head for 10
// q-heads, two groups of 8 and 2). At Dh 256 a bf16 split block stages
// 2 x 128 rows of 528 bytes (~135 KB), and the f32 body stages K and V in
// turn through one buffer (Smem::ONE_BUF).
//
// In both modes a slot with no attendable key gets exact zeros, and a
// masked key's K/V row is never read (also the 0 * NaN guard of the Pallas
// kernels).
//
// Bound on the H100: bytes. Each attended K/V row is needed once per
// kv-head for 4 * Dh FLOPs per q-head of its GQA group, far below the ~295
// FLOP/byte the tensor cores need. The design reads each attended row once
// and keeps many rows in flight:
//
// * Split-K with a fixed plan. The key range [0, L) (ring) or [0, P*ps)
//   (paged) is cut into splits of split_keys keys (whole pages), computed
//   by the wrapper (kernels/ops.py::decode_split_plan) from L or P*ps and
//   the page size only: never from B, t or which slots are active.
// * A split block: 256 threads per (kv-head, slot, split, group of up to
//   8 q-heads). The block walks its split in chunks of 128 keys: each
//   key's K/V row is resolved through the policy, the attended rows are
//   staged into shared memory with 16-byte cp.async copies (a row's chunks
//   on neighbouring threads), K and V as two groups, all in flight at once;
//   the group's query rows (7 for Qwen2-7B, padded to 8) meet K while V
//   lands; then the online softmax over the block and P V. It writes its
//   partial (m, l, acc) in f32 to scratch the wrapper allocates. bf16 runs
//   the dot products and P V on the tensor cores (decode_split_mma, below);
//   f32 on the CUDA cores (decode_split: two threads per key, then each
//   thread two columns of Dh over a subset of the keys), which keeps f32
//   within the 1e-4 tolerance.
// * K and V arrive in their storage type and are read as such: the query's
//   type (f32 or bf16), bf16 under an f32 query (the bf16 cache of an f32
//   model: the CUDA-core body templated on the storage type), or int8 codes
//   with f32 scales per (key, kv-head) (ring kscale/vscale (B,L,K), paged
//   scale pools (N,ps,K), read through the same row as the key). An int8
//   row is half a bf16 row's bytes, which is what bounds decode. The
//   CUDA-core body widens the codes to f32 in registers; the tensor-core
//   body stages the int8 rows with cp.async and one pass widens them into
//   the bf16 rows mma.sync reads (exact: |q| <= 127). The scales fold in
//   where they cost one multiply a key: s_j = kscale_j * (q . k^_j) *
//   sm_scale after the score, and vscale_j into p_j before the P V
//   product (the row sum l keeps the unscaled p_j). The cache is never
//   widened in device memory.
// * decode_merge: one block per (q-head, slot) combines the splits in split
//   order. So a slot's output depends only on its own keys (staggered ==
//   solo stays bit-exact), and there are no atomics.
//
// One call of a wrapper is these two launches; ops.launch_counts() counts
// the call.
#include <type_traits>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hp::cp_async16;
using hp::cp_async16_or_zero;
using hp::cp_commit;
using hp::cp_wait;

constexpr int NK = 128;   // keys per chunk of a split block
constexpr int NT = 256;   // threads per split block: two per key
constexpr int GMAX = 8;   // q-heads of a GQA group per block
constexpr int GH = GMAX / 2;  // of them, the scores one thread computes
static_assert(GH == 4 && NT == 2 * NK, "two threads per key, 4 rows each");

// Ring keys: key j of slot b is ring slot j of row b, masked by its
// absolute position.
struct RingKeys {
  const int* kv_pos;        // (B, L)
  const uint8_t* kv_valid;  // (B, L) or null
  int L, window;

  struct Slot {
    const int* pos;
    const uint8_t* valid;
    long base;  // b * L
    int L, window, tb;
    __device__ __forceinline__ int count() const { return L; }
    // -> the K/V row of key j, or -1 when it is masked
    __device__ __forceinline__ long row(int j) const {
      const int p = __ldg(pos + j);
      bool ok = p >= 0 && p <= tb;
      if (window > 0) ok = ok && (tb - p) < window;
      if (valid != nullptr) ok = ok && __ldg(valid + j) != 0;
      return ok ? base + j : -1;
    }
  };
  __device__ __forceinline__ Slot at(int b, int tb) const {
    const long base = (long)b * L;
    return {kv_pos + base, kv_valid ? kv_valid + base : nullptr, base, L,
            window, tb};
  }
};

// Paged keys: key j of slot b lives on pool page table[b, j / ps], lane
// j % ps; the position is implicit, so keys past t[b] are not visited.
struct PagedKeys {
  const int* table;       // (B, P), -1 = unused entry
  const uint8_t* pvalid;  // (N, ps)
  int P, ps;

  struct Slot {
    const int* entries;
    const uint8_t* pvalid;
    int P, ps, tb;
    __device__ __forceinline__ int count() const {
      return min(P * ps, tb + 1);
    }
    __device__ __forceinline__ long row(int j) const {
      const int e = __ldg(entries + j / ps);
      if (e < 0) return -1;  // unused entry: its page is never read
      const long r = (long)e * ps + j % ps;
      return __ldg(pvalid + r) != 0 ? r : -1;
    }
  };
  __device__ __forceinline__ Slot at(int b, int tb) const {
    return {table + (long)b * P, pvalid, P, ps, tb};
  }
};

// -------------------------- f32: the CUDA-core body --------------------------
//
// Shared memory of a split block, K and V in their storage type T. K and V
// rows are padded by 16 bytes, so one thread per row reading 16-byte chunks
// hits distinct banks. The final reduction ([NT / (DH/2)][GMAX][DH] f32)
// reuses k, v and pad. ONE_BUF (f32 rows at Dh 256, where two 128-row
// buffers would pass the 227 KB a block may have): V lands in k once the
// scores have read K, and v is a stub.
template <typename T, int DH>
struct Smem {
  static constexpr int E = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr bool ONE_BUF = 2 * NK * (DH + E) * (int)sizeof(T) >
                                  160 * 1024;
  static constexpr int KV =
      (ONE_BUF ? NK + 1 : 2 * NK) * (DH + E) * (int)sizeof(T);
  static constexpr int RED = NT / (DH / 2) * GMAX * DH * 4;
  T k[NK][DH + E];
  T v[ONE_BUF ? 1 : NK][DH + E];
  float pad[KV >= RED ? 4 : (RED - KV) / 4];
  alignas(16) float q[GMAX][DH];  // the group's query rows, times sm_scale
  alignas(16) float p[NK][GMAX];  // each key's probabilities, the group's rows
  float red[NT / 32][GH];  // per-warp max, then per-warp sum
  float ks[NK], vs[NK];  // int8 K/V: each key's scales (0 when masked)
  long row[NK];          // the chunk's K/V rows, -1 = masked
};


// 16 bytes of a row in shared memory -> f32 (the CUDA-core body's loads:
// an int8 or bf16 row widens here)
__device__ __forceinline__ void chunk_f(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* p,
                                        float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void chunk_f(const int8_t* p, float (&f)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}
// two neighbouring elements -> f32
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

template <typename TQ, typename T, int DH, typename Keys>
__global__ void __launch_bounds__(NT) decode_split(
    const TQ* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kscale,
    const float* __restrict__ vscale, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, const int* __restrict__ t, const Keys keys,
    int H, int K, int split_keys, int n_split, float sm_scale) {
  using S = Smem<T, DH>;
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr int E = S::E, CH = DH / E;          // 16-byte chunks per row
  constexpr int NDP = DH / 2, NKS = NT / NDP;   // P V: column pairs x key sets
  static_assert(sizeof(S::k) + sizeof(S::v) + sizeof(S::pad) >=
                    NKS * GMAX * DH * 4,
                "the final reduction reuses the K and V buffers");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % n_split;
  const int G = H / K, g0 = (blockIdx.z / n_split) * GMAX;
  const int ng = min(GMAX, G - g0);  // q-heads kh*G + g0 + [0, ng)
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int key = tid % NK, half = tid / NK;   // scores: rows half*GH + [0, GH)
  const int dp = tid % NDP, ks = tid / NDP;    // P V
  const typename Keys::Slot slot = keys.at(b, t[b]);
  const int j_end = min(slot.count(), (split + 1) * split_keys);

  for (int i = tid; i < GMAX * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    sm.q[g][d] = g < ng ? rt::to_f(q[((long)b * H + kh * G + g0 + g) * DH +
                                     d]) * sm_scale
                        : 0.f;
  }
  // the group's softmax state (the same in every thread) and this thread's
  // columns 2*dp, 2*dp + 1 of the unnormalised output
  float m_run[GMAX], l_run[GMAX], acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }

  for (int j0 = split * split_keys; j0 < j_end; j0 += NK) {
    long r = -1;
    if (tid < NK && j0 + tid < j_end) r = slot.row(j0 + tid);
    __syncthreads();  // the previous chunk is consumed
    if (tid < NK) {
      sm.row[tid] = r;
      if constexpr (Q8) {
        sm.ks[tid] = r >= 0 ? __ldg(kscale + r * K + kh) : 0.f;
        sm.vs[tid] = r >= 0 ? __ldg(vscale + r * K + kh) : 0.f;
      }
    }
    if (!__syncthreads_or(r >= 0)) continue;  // nothing to read here
    r = sm.row[key];

    // stage the attended K rows, then the V rows (ONE_BUF: V later)
    auto stage = [&](T (*dst)[DH + E], const T* src) {
      for (int i = tid; i < NK * CH; i += NT) {
        const long rr = sm.row[i / CH];
        if (rr >= 0)
          cp_async16(&dst[i / CH][(i % CH) * E],
                     src + (rr * K + kh) * DH + (i % CH) * E);
      }
      cp_commit();
    };
    stage(sm.k, k);
    if constexpr (S::ONE_BUF) {
      cp_wait<0>();  // this thread's K copies
    } else {
      stage(sm.v, v);
      cp_wait<1>();  // this thread's K copies
    }
    __syncthreads();

    // this thread's key against its half of the group's rows
    float s[GH];
#pragma unroll
    for (int g = 0; g < GH; ++g) s[g] = 0.f;
    if (r >= 0) {
#pragma unroll 4
      for (int c = 0; c < CH; ++c) {
        float kf[E];
        chunk_f(&sm.k[key][c * E], kf);  // int8 / bf16 K: widened here
#pragma unroll
        for (int g = 0; g < GH; ++g)
#pragma unroll
          for (int e = 0; e < E; e += 4) {  // q: one broadcast 16-byte read
            const float4 qq = *reinterpret_cast<const float4*>(
                &sm.q[half * GH + g][c * E + e]);
            s[g] += qq.x * kf[e] + qq.y * kf[e + 1] + qq.z * kf[e + 2] +
                    qq.w * kf[e + 3];
          }
      }
      if constexpr (Q8)  // s = kscale * (q . k^) * sm_scale
#pragma unroll
        for (int g = 0; g < GH; ++g) s[g] *= sm.ks[key];
    }
    float x[GH];
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      x[g] = r >= 0 ? s[g] : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x[g] = fmaxf(x[g], __shfl_xor_sync(0xffffffffu, x[g], o));
    }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < GH; ++g) sm.red[w][g] = x[g];
    __syncthreads();
    if constexpr (S::ONE_BUF) stage(sm.k, v);  // every K read is done
    // rows 0 .. GH-1 are reduced by warps 0-3, rows GH .. by warps 4-7
    float alpha[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float m = m_run[g];
#pragma unroll
      for (int ww = 0; ww < NK / 32; ++ww)
        m = fmaxf(m, sm.red[(g / GH) * (NK / 32) + ww][g % GH]);
      alpha[g] = expf(m_run[g] - m);  // the chunk has a key: m is finite
      m_run[g] = m;
    }
#pragma unroll
    for (int g = 0; g < GH; ++g)
      x[g] = r >= 0 ? expf(s[g] - (half ? m_run[GH + g] : m_run[g])) : 0.f;
    if constexpr (Q8) {  // vscale folds into p; the row sum keeps p
      const float vsc = sm.vs[key];
      *reinterpret_cast<float4*>(&sm.p[key][half * GH]) =
          make_float4(x[0] * vsc, x[1] * vsc, x[2] * vsc, x[3] * vsc);
    } else {
      *reinterpret_cast<float4*>(&sm.p[key][half * GH]) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
#pragma unroll
    for (int g = 0; g < GH; ++g)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x[g] += __shfl_xor_sync(0xffffffffu, x[g], o);
    __syncthreads();  // every max is read before the sums overwrite it
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < GH; ++g) sm.red[w][g] = x[g];
    cp_wait<0>();  // this thread's V copies
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int ww = 0; ww < NK / 32; ++ww)
        sum += sm.red[(g / GH) * (NK / 32) + ww][g % GH];
      l_run[g] = l_run[g] * alpha[g] + sum;
      acc[g][0] *= alpha[g];
      acc[g][1] *= alpha[g];
    }

    // P V over the chunk: keys ks, ks + NKS, ...; masked keys were never
    // loaded and are skipped
    const T(*vrows)[DH + E] = S::ONE_BUF ? sm.k : sm.v;
    for (int kk = ks; kk < NK; kk += NKS) {
      if (sm.row[kk] < 0) continue;
      const float2 vv = pair_f(&vrows[kk][2 * dp]);  // int8 / bf16 V: widened
      const float4 pa = *reinterpret_cast<const float4*>(&sm.p[kk][0]);
      const float4 pb = *reinterpret_cast<const float4*>(&sm.p[kk][4]);
      const float pk[GMAX] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        acc[g][0] += pk[g] * vv.x;
        acc[g][1] += pk[g] * vv.y;
      }
    }
  }

  // sum the key sets' shares in order, through the (free) K and V buffers
  float* red = reinterpret_cast<float*>(&sm.k[0][0]);  // [NKS][GMAX][DH]
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    red[(ks * GMAX + g) * DH + 2 * dp] = acc[g][0];
    red[(ks * GMAX + g) * DH + 2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  // partial of q-head h = kh*G + g0 + g at (b, h, split)
  const long base = ((long)b * H + kh * G + g0) * n_split + split;
  for (int i = tid; i < ng * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    float o = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < NKS; ++s2) o += red[(s2 * GMAX + g) * DH + d];
    part_acc[(base + (long)g * n_split) * DH + d] = o;
  }
  if (tid == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < ng)  // l == 0: the split attended no key
        part_ml[base + (long)g * n_split] = make_float2(m_run[g], l_run[g]);
}

// ------------------------ bf16: the tensor-core body ------------------------
//
// The same split block, with Q K^T and P V as mma.sync m16n8k16 (bf16 in,
// f32 accumulate): the group's 8 query rows are the A operand's rows 0-7
// (rows 8-15 are zero registers), held in registers for the whole block;
// each of the 8 warps takes 16 keys of a chunk. A warp's scores come out
// as row lane/4, keys 2*(lane%4) + {0, 1} of each 8-key tile, which is the
// P operand of its P V product in registers; V's B operand comes from
// shared memory through ldmatrix.trans. Masked keys are staged as zeros
// (cp.async with no source bytes: nothing is read), so no 0 * NaN reaches
// the product. Shared-memory traffic is K and V once per chunk, where the
// CUDA-core body reads the query rows once per key. int8 K/V (Q8): the
// rows land as int8 (k8, v8; masked rows zeros) and one pass of the block
// widens them into k and v, after which the chunk runs as for bf16, with
// the scales folded into the score and into P.

template <int DH>
struct SmemMmaBase {
  __nv_bfloat16 k[NK][DH + 8];  // padded rows: conflict-free fragment reads
  __nv_bfloat16 v[NK][DH + 8];
  float red[2][NT / 32][GMAX];  // per-warp row max, row sum
  float alpha[GMAX];            // this chunk's rescale of each row
  long row[NK];                 // the chunk's K/V rows, -1 = masked
};
template <int DH, bool Q8>
struct SmemMma : SmemMmaBase<DH> {};
template <int DH>
struct SmemMma<DH, true> : SmemMmaBase<DH> {
  alignas(16) int8_t k8[NK][DH + 16];  // the int8 rows as they land
  int8_t v8[NK][DH + 16];
  float ks[NK], vs[NK];    // each key's scales (0 when masked)
};

// int8 rows of a chunk (row stride DH + 16) -> the bf16 rows mma.sync
// reads (row stride DH + 8), exactly
template <int DH>
__device__ __forceinline__ void widen_rows(const int8_t* src,
                                           __nv_bfloat16* dst, int tid) {
  for (int i = tid; i < NK * (DH / 16); i += NT) {
    const int r = i / (DH / 16), c = (i % (DH / 16)) * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(src + r * (DH + 16) + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float lo = (float)(int8_t)(w[j / 2] >> (16 * (j % 2)));
      const float hi = (float)(int8_t)(w[j / 2] >> (16 * (j % 2) + 8));
      __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
      o[j] = *reinterpret_cast<uint32_t*>(&b);
    }
    __nv_bfloat16* d = dst + r * (DH + 8) + c;
    *reinterpret_cast<uint4*>(d) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(d + 8) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// D(16 x 8) += A(16 x 16) B(16 x 8), A's rows 8-15 zero: a0 = row lane/4,
// columns 2*(lane%4) + {0, 1}; a2 = the same row, columns + 8
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int DH, typename Keys, bool Q8>
__global__ void __launch_bounds__(NT) decode_split_mma(
    const __nv_bfloat16* __restrict__ q,
    const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ k,
    const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ v,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    float* __restrict__ part_acc, float2* __restrict__ part_ml,
    const int* __restrict__ t, const Keys keys, int H, int K, int split_keys,
    int n_split, float sm_scale) {
  using S = SmemMma<DH, Q8>;
  constexpr int CH = DH / 8;             // 16-byte chunks per row
  constexpr int NW = NT / 32;            // warps, 16 keys each
  constexpr int NV = GMAX * DH / NT;     // output values per thread
  static_assert(NW * 16 == NK, "16 keys per warp");
  static_assert(sizeof(S::k) >= NW * GMAX * DH * 4,
                "the warps' partial outputs reuse the K buffer");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % n_split;
  const int G = H / K, g0 = (blockIdx.z / n_split) * GMAX;
  const int ng = min(GMAX, G - g0);  // q-heads kh*G + g0 + [0, ng)
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const typename Keys::Slot slot = keys.at(b, t[b]);
  const int j_end = min(slot.count(), (split + 1) * split_keys);

  // A fragments of query row gq (zero past the group), all of Dh
  uint32_t qa[DH / 16][2];
  {
    const __nv_bfloat16* qr = q + ((long)b * H + kh * G + g0 + gq) * DH;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qa[kk][h] = gq < ng ? *reinterpret_cast<const uint32_t*>(
                                  qr + 16 * kk + 8 * h + 2 * tq)
                            : 0u;
  }
  // the group's softmax state (the same in every thread) and this
  // thread's output values tid + NT * i: row / DH, column % DH
  float m_run[GMAX], l_run[GMAX], acc[NV];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) m_run[g] = -INFINITY, l_run[g] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  float* part = reinterpret_cast<float*>(&sm.k[0][0]);  // [NW][GMAX][DH]

  for (int j0 = split * split_keys; j0 < j_end; j0 += NK) {
    long r = -1;
    if (tid < NK && j0 + tid < j_end) r = slot.row(j0 + tid);
    __syncthreads();  // the previous chunk is consumed
    if (tid < NK) {
      sm.row[tid] = r;
      if constexpr (Q8) {
        sm.ks[tid] = r >= 0 ? __ldg(kscale + r * K + kh) : 0.f;
        sm.vs[tid] = r >= 0 ? __ldg(vscale + r * K + kh) : 0.f;
      }
    }
    if (!__syncthreads_or(r >= 0)) continue;  // nothing to read here

    // stage K then V; a masked key's rows become zeros, unread
    if constexpr (Q8) {
      constexpr int C8 = DH / 16;  // 16-byte chunks of an int8 row
      for (int i = tid; i < NK * C8; i += NT) {
        const long rr = sm.row[i / C8];
        cp_async16_or_zero(&sm.k8[i / C8][(i % C8) * 16],
                           k + ((rr < 0 ? 0 : rr) * K + kh) * DH +
                               (i % C8) * 16,
                           rr >= 0 ? 16 : 0);
      }
      cp_commit();
      for (int i = tid; i < NK * C8; i += NT) {
        const long rr = sm.row[i / C8];
        cp_async16_or_zero(&sm.v8[i / C8][(i % C8) * 16],
                           v + ((rr < 0 ? 0 : rr) * K + kh) * DH +
                               (i % C8) * 16,
                           rr >= 0 ? 16 : 0);
      }
      cp_commit();
    } else {
      for (int i = tid; i < NK * CH; i += NT) {
        const long rr = sm.row[i / CH];
        cp_async16_or_zero(&sm.k[i / CH][(i % CH) * 8],
                           k + ((rr < 0 ? 0 : rr) * K + kh) * DH +
                               (i % CH) * 8,
                           rr >= 0 ? 16 : 0);
      }
      cp_commit();
      for (int i = tid; i < NK * CH; i += NT) {
        const long rr = sm.row[i / CH];
        cp_async16_or_zero(&sm.v[i / CH][(i % CH) * 8],
                           v + ((rr < 0 ? 0 : rr) * K + kh) * DH +
                               (i % CH) * 8,
                           rr >= 0 ? 16 : 0);
      }
      cp_commit();
    }
    cp_wait<1>();  // this thread's K copies
    __syncthreads();
    if constexpr (Q8) {  // int8 K -> bf16
      widen_rows<DH>(&sm.k8[0][0], &sm.k[0][0], tid);
      __syncthreads();
    }

    // S = Q K^T: this warp's keys 16w + 8j + {0..7}, B column gq
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* kr = &sm.k[16 * w + 8 * j + gq][2 * tq];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma16816(sc[j], qa[kk][0], qa[kk][1],
                 *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
    }
    // row gq, keys 16w + 8j + 2tq + e: masked to -inf, row max
    float x[2][2], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = 16 * w + 8 * j + 2 * tq + e;
        if constexpr (Q8)  // s = kscale * (q . k^) * sm_scale
          x[j][e] = sm.row[kj] >= 0 ? sc[j][e] * sm.ks[kj] * sm_scale
                                    : -INFINITY;
        else
          x[j][e] = sm.row[kj] >= 0 ? sc[j][e] * sm_scale : -INFINITY;
        mx = fmaxf(mx, x[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (tq == 0) sm.red[0][w][gq] = mx;
    __syncthreads();
    float alpha[GMAX], m_row = 0.f;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float m = m_run[g];
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) m = fmaxf(m, sm.red[0][ww][g]);
      alpha[g] = expf(m_run[g] - m);  // the chunk has a key: m is finite
      m_run[g] = m;
      m_row = g == gq ? m : m_row;
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[j][e] = expf(x[j][e] - m_row);  // masked: exp(-inf) = 0
        sum += x[j][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (tq == 0) sm.red[1][w][gq] = sum;
    if (tid == 0)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sm.alpha[g] = alpha[g];
    cp_wait<0>();  // this thread's V copies
    __syncthreads();
    if constexpr (Q8) {  // int8 V -> bf16
      widen_rows<DH>(&sm.v8[0][0], &sm.v[0][0], tid);
      __syncthreads();
    }

    // O_w = P V over this warp's 16 keys, two 8-column tiles per ldmatrix
    uint32_t pa0, pa2;
    if constexpr (Q8) {  // vscale folds into P; the row sum keeps p
      const float* vs = &sm.vs[16 * w + 2 * tq];
      pa0 = pack2(x[0][0] * vs[0], x[0][1] * vs[1]);
      pa2 = pack2(x[1][0] * vs[8], x[1][1] * vs[9]);
    } else {
      pa0 = pack2(x[0][0], x[0][1]);
      pa2 = pack2(x[1][0], x[1][1]);
    }
    // NB 8-column tiles at a time, stored when done: all of Dh up to 128;
    // at Dh 256 two (Dh / 2 = 128 accumulators a thread would not fit
    // beside the query fragments)
    constexpr int NB = DH > 128 ? 2 : DH / 8;
#pragma unroll
    for (int d0 = 0; d0 < DH / 8; d0 += NB) {
      float o[NB][4];
#pragma unroll
      for (int dt = 0; dt < NB; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, &sm.v[16 * w + ((lane >> 3) & 1) * 8 + (lane & 7)]
                               [8 * (d0 + dt + (lane >> 4))]);
        o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
        o[dt + 1][0] = o[dt + 1][1] = o[dt + 1][2] = o[dt + 1][3] = 0.f;
        mma16816(o[dt], pa0, pa2, bv[0], bv[1]);
        mma16816(o[dt + 1], pa0, pa2, bv[2], bv[3]);
      }
#pragma unroll
      for (int dt = 0; dt < NB; ++dt)
        *reinterpret_cast<float2*>(
            &part[(w * GMAX + gq) * DH + 8 * (d0 + dt) + 2 * tq]) =
            make_float2(o[dt][0], o[dt][1]);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float lsum = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) lsum += sm.red[1][ww][g];
      l_run[g] = l_run[g] * alpha[g] + lsum;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {  // the warps' shares, in warp order
      const int x_ = tid + NT * i, g = x_ / DH, d = x_ % DH;
      float o_ = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) o_ += part[(ww * GMAX + g) * DH + d];
      acc[i] = acc[i] * sm.alpha[g] + o_;
    }
  }

  // partial of q-head h = kh*G + g0 + g at (b, h, split)
  const long base = ((long)b * H + kh * G + g0) * n_split + split;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int x_ = tid + NT * i, g = x_ / DH, d = x_ % DH;
    if (g < ng) part_acc[(base + (long)g * n_split) * DH + d] = acc[i];
  }
  if (tid == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < ng)  // l == 0: the split attended no key
        part_ml[base + (long)g * n_split] = make_float2(m_run[g], l_run[g]);
}

// out[b, h] = the splits of (b, h) combined in split order; exact zeros
// when no split attended a key.
template <typename T, int DH>
__global__ void __launch_bounds__(DH) decode_merge(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    T* __restrict__ out, int n_split) {
  const long bh = (long)blockIdx.y * gridDim.x + blockIdx.x;  // b * H + h
  const int d = threadIdx.x;
  const float2* ml = part_ml + bh * n_split;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (ml[s].y > 0.f) M = fmaxf(M, ml[s].x);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 x = ml[s];
    if (x.y > 0.f) {
      const float sc = expf(x.x - M);
      L += x.y * sc;
      o += part_acc[(bh * n_split + s) * DH + d] * sc;
    }
  }
  out[bh * DH + d] = rt::from_f<T>(L > 0.f ? o / L : 0.f);
}

template <typename F, typename... A>
cudaError_t start(F fn, int smem, dim3 grid, cudaStream_t stream,
                  A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fn<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

// T: the query's (and the output's) type; TKV: K and V's storage type.
template <typename T, typename TKV, int DH, typename Keys>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* out, float* part_acc, float* part_ml,
           const int* t, const Keys& keys, int B, int H, int K,
           int split_keys, int n_split, float sm_scale, cudaStream_t stream,
           rt::Geom* geo) {
  const dim3 grid(K, B, n_split * ((H / K + GMAX - 1) / GMAX));
  constexpr bool Q8 = std::is_same<TKV, int8_t>::value;
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  const int smem = MMA ? (int)sizeof(SmemMma<DH, Q8>)
                       : (int)sizeof(Smem<TKV, DH>);
  if (geo != nullptr)
    return rt::record(geo, {{grid, NT, smem}, {dim3(H, B), DH, 0}});
  cudaError_t e;
  if constexpr (MMA)
    e = start(decode_split_mma<DH, Keys, Q8>, smem, grid, stream,
              (const T*)q, (const TKV*)k, (const TKV*)v, ks,
              vs, part_acc, (float2*)part_ml, t, keys, H, K, split_keys,
              n_split, sm_scale);
  else
    e = start(decode_split<T, TKV, DH, Keys>, smem, grid, stream,
              (const T*)q, (const TKV*)k, (const TKV*)v, ks,
              vs, part_acc, (float2*)part_ml, t, keys, H, K, split_keys,
              n_split, sm_scale);
  if (e != cudaSuccess) return (int)e;
  decode_merge<T, DH><<<dim3(H, B), DH, 0, stream>>>(
      part_acc, (const float2*)part_ml, (T*)out, n_split);
  return (int)cudaGetLastError();
}

// (query type, K/V storage type): f32 over f32, bf16 or int8; bf16 over
// bf16 or int8
template <typename Keys>
int dispatch(int dtype, int kv_dtype, int dh, const void* q, const void* k,
             const void* v, const void* kscale, const void* vscale,
             void* out, void* scratch, const void* t, const Keys& keys,
             int B, int H, int K, int split_keys, int n_split, float sm_scale,
             void* stream, rt::Geom* geo) {
  const int* tt = (const int*)t;
  const float* ks = (const float*)kscale;
  const float* vs = (const float*)vscale;
  float* pa = (float*)scratch;                    // (B, H, n_split, Dh)
  float* pm = pa + (long)B * H * n_split * dh;    // (B, H, n_split, 2)
  cudaStream_t s = (cudaStream_t)stream;
  if ((kv_dtype == rt::DT_I8) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
#define DECODE_DH(T, TKV)                                                     \
  switch (dh) {                                                               \
    case 32: return launch<T, TKV, 32>(q, k, v, ks, vs, out, pa, pm, tt,      \
                                       keys, B, H, K, split_keys, n_split,    \
                                       sm_scale, s, geo);                     \
    case 64: return launch<T, TKV, 64>(q, k, v, ks, vs, out, pa, pm, tt,      \
                                       keys, B, H, K, split_keys, n_split,    \
                                       sm_scale, s, geo);                     \
    case 128: return launch<T, TKV, 128>(q, k, v, ks, vs, out, pa, pm, tt,    \
                                         keys, B, H, K, split_keys, n_split,  \
                                         sm_scale, s, geo);                   \
    case 256: return launch<T, TKV, 256>(q, k, v, ks, vs, out, pa, pm, tt,    \
                                         keys, B, H, K, split_keys, n_split,  \
                                         sm_scale, s, geo);                   \
    default: return (int)cudaErrorInvalidValue;                               \
  }
  if (dtype == rt::DT_F32 && kv_dtype == rt::DT_F32) DECODE_DH(float, float)
  if (dtype == rt::DT_F32 && kv_dtype == rt::DT_BF16)
    DECODE_DH(float, __nv_bfloat16)
  if (dtype == rt::DT_F32 && kv_dtype == rt::DT_I8) DECODE_DH(float, int8_t)
  if (dtype == rt::DT_BF16 && kv_dtype == rt::DT_BF16)
    DECODE_DH(__nv_bfloat16, __nv_bfloat16)
  if (dtype == rt::DT_BF16 && kv_dtype == rt::DT_I8)
    DECODE_DH(__nv_bfloat16, int8_t)
#undef DECODE_DH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points bound with ctypes. Each returns the first failing launch's
// cudaError_t, or 0. dtype: q's (and out's) rt::DT_*; kv_dtype: K and V's
// storage, with kscale / vscale the f32 scales of int8 K/V (ring (B,L,K),
// paged (N,ps,K)), else NULL. scratch: B*H*n_split*(Dh + 2) f32, the
// splits' partial outputs (B,H,n_split,Dh) then their (max, sum)
// (B,H,n_split,2).
static int decode_attention_run(int dtype, int kv_dtype, int dh, const void* q,
                                const void* k, const void* v,
                                const void* kscale, const void* vscale,
                                void* out, void* scratch, const void* kv_pos,
                                const void* t, const void* kv_valid, int B,
                                int L, int H, int K, int window,
                                int split_keys, int n_split, float sm_scale,
                                void* stream, rt::Geom* geo) {
  const RingKeys keys{(const int*)kv_pos, (const uint8_t*)kv_valid, L,
                      window};
  return dispatch(dtype, kv_dtype, dh, q, k, v, kscale, vscale, out, scratch,
                  t, keys, B, H, K, split_keys, n_split, sm_scale, stream,
                  geo);
}

extern "C" int decode_attention_launch(int dtype, int kv_dtype, int dh,
                                       const void* q, const void* k,
                                       const void* v, const void* kscale,
                                       const void* vscale, void* out,
                                       void* scratch, const void* kv_pos,
                                       const void* t, const void* kv_valid,
                                       int B, int L, int H, int K, int window,
                                       int split_keys, int n_split,
                                       float sm_scale, void* stream) {
  return decode_attention_run(dtype, kv_dtype, dh, q, k, v, kscale, vscale,
                              out, scratch, kv_pos, t, kv_valid, B, L, H, K,
                              window, split_keys, n_split, sm_scale, stream,
                              nullptr);
}

// decode_attention_launch's arguments but the stream: the launcher's host code
// up to its launches; `geom` gets rt::geometry_out's record.
extern "C" int decode_attention_geometry(int dtype, int kv_dtype, int dh,
                                         const void* q, const void* k,
                                         const void* v, const void* kscale,
                                         const void* vscale, void* out,
                                         void* scratch, const void* kv_pos,
                                         const void* t, const void* kv_valid,
                                         int B, int L, int H, int K,
                                         int window, int split_keys,
                                         int n_split, float sm_scale,
                                         int* geom) {
  rt::Geom g;
  const int rc = decode_attention_run(dtype, kv_dtype, dh, q, k, v, kscale,
                                      vscale, out, scratch, kv_pos, t, kv_valid,
                                      B, L, H, K, window, split_keys, n_split,
                                      sm_scale, nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}

static int paged_decode_attention_run(int dtype, int kv_dtype, int dh,
                                      const void* q, const void* kp,
                                      const void* vp, const void* kscale,
                                      const void* vscale, void* out,
                                      void* scratch, const void* table,
                                      const void* t, const void* pvalid, int B,
                                      int P, int ps, int H, int K,
                                      int split_keys, int n_split,
                                      float sm_scale, void* stream,
                                      rt::Geom* geo) {
  const PagedKeys keys{(const int*)table, (const uint8_t*)pvalid, P, ps};
  return dispatch(dtype, kv_dtype, dh, q, kp, vp, kscale, vscale, out,
                  scratch, t, keys, B, H, K, split_keys, n_split, sm_scale,
                  stream, geo);
}

extern "C" int paged_decode_attention_launch(int dtype, int kv_dtype, int dh,
                                             const void* q, const void* kp,
                                             const void* vp,
                                             const void* kscale,
                                             const void* vscale, void* out,
                                             void* scratch, const void* table,
                                             const void* t, const void* pvalid,
                                             int B, int P, int ps, int H,
                                             int K, int split_keys,
                                             int n_split, float sm_scale,
                                             void* stream) {
  return paged_decode_attention_run(dtype, kv_dtype, dh, q, kp, vp, kscale,
                                    vscale, out, scratch, table, t, pvalid, B,
                                    P, ps, H, K, split_keys, n_split, sm_scale,
                                    stream, nullptr);
}

// paged_decode_attention_launch's arguments but the stream: the launcher's host
// code up to its launches; `geom` gets rt::geometry_out's record.
extern "C" int paged_decode_attention_geometry(int dtype, int kv_dtype, int dh,
                                               const void* q, const void* kp,
                                               const void* vp,
                                               const void* kscale,
                                               const void* vscale, void* out,
                                               void* scratch,
                                               const void* table,
                                               const void* t,
                                               const void* pvalid, int B,
                                               int P, int ps, int H, int K,
                                               int split_keys, int n_split,
                                               float sm_scale, int* geom) {
  rt::Geom g;
  const int rc = paged_decode_attention_run(dtype, kv_dtype, dh, q, kp, vp,
                                            kscale, vscale, out, scratch, table,
                                            t, pvalid, B, P, ps, H, K,
                                            split_keys, n_split, sm_scale,
                                            nullptr, &g);
  return rt::geometry_out(g, geom, rc);
}
