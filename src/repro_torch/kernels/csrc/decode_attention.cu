// Ring-cache decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel kernels/decode_attention.py::decode_attention of
// the JAX package. One query token per serving slot: q (B,1,H,Dh) against
// the ring cache k/v (B,L,K,Dh). The ring is not position-ordered, so keys
// are masked by their ABSOLUTE position kv_pos (B,L) (-1 = empty slot):
// slot j is attendable iff 0 <= kv_pos[b,j] <= t[b], t[b] - kv_pos[b,j] <
// window (when windowed) and kv_valid[b,j] (token routing). A slot with no
// attendable key gets exact zeros.
//
// One block per (head, slot); its 8 warps stride over the L ring slots,
// each warp keeping its own online-softmax state (one key per step: a warp
// dot product over Dh), merged through shared memory at the end. A masked
// slot is skipped before its K/V row is read, which is also the 0 * NaN
// guard of the Pallas kernel.
//
// Bound on the H100: bytes. Each attended K/V row is read once per q-head
// (GQA groups re-read it from L2) for 4*Dh FLOPs per head, far below the
// ~295 FLOP/byte the tensor cores need; the time is set by the K/V bytes
// and, at small B, by the latency of the per-key warp reductions.
#include "common.cuh"

namespace {

constexpr int NW = 8;  // warps per block

template <typename T, int DH>
__global__ void __launch_bounds__(NW * 32) decode_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, const int* __restrict__ kv_pos,
    const int* __restrict__ t, const uint8_t* __restrict__ kv_valid, int L,
    int H, int K, int window, float sm_scale) {
  constexpr int PER = DH / 32;  // elements of a row per lane
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][DH];

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tb = t[b];
  const int* pos = kv_pos + (long)b * L;
  const uint8_t* valid = kv_valid ? kv_valid + (long)b * L : nullptr;

  float qv[PER];
  const T* qr = q + ((long)b * H + h) * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) qv[i] = rt::to_f(qr[lane + 32 * i]);

  float m = -INFINITY, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  for (int j = w; j < L; j += NW) {
    const int p = pos[j];
    bool ok = p >= 0 && p <= tb;
    if (window > 0) ok = ok && (tb - p) < window;
    if (valid != nullptr) ok = ok && valid[j] != 0;
    if (!ok) continue;  // warp-uniform: the whole warp is on slot j
    const long row = (((long)b * L + j) * K + kh) * DH;
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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* kv_pos, const int* t, const uint8_t* kv_valid, int B,
           int L, int H, int K, int window, float sm_scale,
           cudaStream_t stream) {
  dim3 grid(H, B);
  decode_fwd<T, DH><<<grid, NW * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, kv_pos, t, kv_valid, L,
      H, K, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              const int* kv_pos, const int* t, const uint8_t* kv_valid, int B,
              int L, int H, int K, int window, float sm_scale,
              cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, kv_pos, t, kv_valid, B, L, H, K, window, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, kv_pos, t, kv_valid, B, L, H, K, window, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, kv_pos, t, kv_valid, B, L, H, K, window, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes. Returns the launch's cudaError_t.
extern "C" int decode_attention_launch(int dtype, int dh, const void* q,
                                       const void* k, const void* v,
                                       void* out, const void* kv_pos,
                                       const void* t, const void* kv_valid,
                                       int B, int L, int H, int K, int window,
                                       float sm_scale, void* stream) {
  const int* pos = (const int*)kv_pos;
  const int* tt = (const int*)t;
  const uint8_t* valid = (const uint8_t*)kv_valid;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DT_F32)
    return launch_dh<float>(dh, q, k, v, out, pos, tt, valid, B, L, H, K, window, sm_scale, s);
  if (dtype == rt::DT_BF16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, pos, tt, valid, B, L, H, K, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
