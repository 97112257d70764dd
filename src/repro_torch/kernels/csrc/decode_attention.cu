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
// prefetch and the softmax state carried across the page axis; here one
// block loads its own table row and loops over the keys.
//
// In both modes a slot with no attendable key gets exact zeros.
//
// One block per (head, slot); its 8 warps stride over the keys, each warp
// keeping its own online-softmax state (one key per step: a warp dot
// product over Dh), merged through shared memory at the end. A masked key
// is skipped before its K/V row is read, which is also the 0 * NaN guard of
// the Pallas kernels.
//
// Bound on the H100: bytes. Each attended K/V row is read once per q-head
// (GQA groups re-read it from L2) for 4*Dh FLOPs per head, far below the
// ~295 FLOP/byte the tensor cores need; the time is set by the K/V bytes
// and, at small B, by the latency of the per-key warp reductions.
#include "common.cuh"

namespace {

constexpr int NW = 8;  // warps per block

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

template <typename T, int DH, typename Keys>
__global__ void __launch_bounds__(NW * 32) decode_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, const int* __restrict__ t, const Keys keys, int H,
    int K, float sm_scale) {
  constexpr int PER = DH / 32;  // elements of a row per lane
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][DH];

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const typename Keys::Slot slot = keys.at(b, t[b]);

  float qv[PER];
  const T* qr = q + ((long)b * H + h) * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) qv[i] = rt::to_f(qr[lane + 32 * i]);

  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  const int n = slot.count();
  for (int j = w; j < n; j += NW) {
    const long r = slot.row(j);
    if (r < 0) continue;  // warp-uniform: the whole warp is on key j
    const long row = (r * K + kh) * DH;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) s += qv[i] * rt::to_f(k[row + lane + 32 * i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s *= sm_scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // m == -inf -> 0
    const float pe = expf(s - m_new);
    l = l * alpha + pe;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      acc[i] = acc[i] * alpha + pe * rt::to_f(v[row + lane + 32 * i]);
    m = m_new;
  }

  if (lane == 0) {
    sm_m[w] = m;
    sm_l[w] = l;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) sm_acc[w][lane + 32 * i] = acc[i];
  __syncthreads();
  if (w != 0) return;
  float M = -INFINITY;
#pragma unroll
  for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww]);
  float lsum = 0.f, o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) o[i] = 0.f;
#pragma unroll
  for (int ww = 0; ww < NW; ++ww) {
    if (sm_m[ww] == -INFINITY) continue;  // this warp saw no key
    const float sc = expf(sm_m[ww] - M);
    lsum += sm_l[ww] * sc;
#pragma unroll
    for (int i = 0; i < PER; ++i) o[i] += sm_acc[ww][lane + 32 * i] * sc;
  }
  T* orow = out + ((long)b * H + h) * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    orow[lane + 32 * i] = rt::from_f<T>(lsum > 0.f ? o[i] / lsum : 0.f);
}

template <typename T, int DH, typename Keys>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* t, const Keys& keys, int B, int H, int K,
           float sm_scale, cudaStream_t stream) {
  dim3 grid(H, B);
  decode_fwd<T, DH, Keys><<<grid, NW * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, t, keys, H, K,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename Keys>
int dispatch(int dtype, int dh, const void* q, const void* k, const void* v,
             void* out, const void* t, const Keys& keys, int B, int H, int K,
             float sm_scale, void* stream) {
  const int* tt = (const int*)t;
  cudaStream_t s = (cudaStream_t)stream;
#define DECODE_DH(T)                                                        \
  switch (dh) {                                                             \
    case 32: return launch<T, 32>(q, k, v, out, tt, keys, B, H, K, sm_scale, s);   \
    case 64: return launch<T, 64>(q, k, v, out, tt, keys, B, H, K, sm_scale, s);   \
    case 128: return launch<T, 128>(q, k, v, out, tt, keys, B, H, K, sm_scale, s); \
    default: return (int)cudaErrorInvalidValue;                             \
  }
  if (dtype == rt::DT_F32) DECODE_DH(float)
  if (dtype == rt::DT_BF16) DECODE_DH(__nv_bfloat16)
#undef DECODE_DH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points bound with ctypes. Each returns the launch's cudaError_t.
extern "C" int decode_attention_launch(int dtype, int dh, const void* q,
                                       const void* k, const void* v,
                                       void* out, const void* kv_pos,
                                       const void* t, const void* kv_valid,
                                       int B, int L, int H, int K, int window,
                                       float sm_scale, void* stream) {
  const RingKeys keys{(const int*)kv_pos, (const uint8_t*)kv_valid, L,
                      window};
  return dispatch(dtype, dh, q, k, v, out, t, keys, B, H, K, sm_scale,
                  stream);
}

extern "C" int paged_decode_attention_launch(
    int dtype, int dh, const void* q, const void* kp, const void* vp,
    void* out, const void* table, const void* t, const void* pvalid, int B,
    int P, int ps, int H, int K, float sm_scale, void* stream) {
  const PagedKeys keys{(const int*)table, (const uint8_t*)pvalid, P, ps};
  return dispatch(dtype, dh, q, kp, vp, out, t, keys, B, H, K, sm_scale,
                  stream);
}
