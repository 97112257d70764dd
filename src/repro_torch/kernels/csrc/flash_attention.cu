// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention of the
// JAX package. q (B,Sq,H,Dh), k/v (B,Sk,K,Dh) row-major, f32 or bf16 in,
// f32 accumulation, q's type out. Causal and window masks by ARRAY INDEX, a
// per-key validity mask kv_valid (B,Sk) and a ragged per-row count
// kv_count (B,): key tiles past the count are skipped, query rows past it
// are written as zeros. GQA maps q-head h to kv-head h / (H / K).
//
// One block per (q-tile of 64 rows, head, batch row). The TPU's sequential
// kv grid axis becomes the loop over key tiles inside the block, with the
// online-softmax state (row max, row sum, output tile) held in registers
// and shared memory. Tiles dead by causality, window or count are skipped.
//
// A query row with NO attendable key is written as exact zeros (the Pallas
// kernel leaves it undefined); the port's plain version does the same.
//
// Bound on the H100: at the serving shapes (Sq = Sk <= 1024, Dh = 128) the
// work is ~4*Dh*Sq*Sk/2 FLOPs against ~4*S*H*Dh bytes, so the tensor-core
// rate bounds it; this first version multiplies on the CUDA cores in f32
// from shared-memory tiles and is far from that bound.
#include "common.cuh"

namespace {

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
__global__ void __launch_bounds__(NT) flash_fwd(
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
  const int cnt = kv_count[b];
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
      for (int j = 0; j < OC; ++j) ob[r * qs + tx + 16 * j] = rt::from_f<T>(0.f);
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
int launch(const void* q, const void* k, const void* v, void* out,
           const uint8_t* kv_valid, const int* kv_count, int B, int Sq,
           int Sk, int H, int K, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  const int smem = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, kv_valid, kv_count, Sq,
      Sk, H, K, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              const uint8_t* kv_valid, const int* kv_count, int B, int Sq,
              int Sk, int H, int K, int causal, int window, float sm_scale,
              cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, kv_valid, kv_count, B, Sq, Sk, H, K, causal, window, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, kv_valid, kv_count, B, Sq, Sk, H, K, causal, window, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, kv_valid, kv_count, B, Sq, Sk, H, K, causal, window, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, kv_valid, kv_count, B, Sq, Sk, H, K, causal, window, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(int dtype, int dh, const void* q,
                                      const void* k, const void* v, void* out,
                                      const void* kv_valid,
                                      const void* kv_count, int B, int Sq,
                                      int Sk, int H, int K, int causal,
                                      int window, float sm_scale,
                                      void* stream) {
  const uint8_t* valid = (const uint8_t*)kv_valid;
  const int* cnt = (const int*)kv_count;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == rt::DT_F32)
    return launch_dh<float>(dh, q, k, v, out, valid, cnt, B, Sq, Sk, H, K, causal, window, sm_scale, s);
  if (dtype == rt::DT_BF16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, valid, cnt, B, Sq, Sk, H, K, causal, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
