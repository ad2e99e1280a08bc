// K2: the fused pre-norm encoder attention sublayer, by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_attention.py::linear_encoder_attention_pallas
// (kernel _linear_encoder_kernel). Per batch row b and head h:
//   kv_in = round(LN(src) + s_pos), q_in = round(LN(x) + x_pos)  (LN in f32, eps 1e-5)
//   k, v = round(kv_in · Wk_h), round(kv_in · Wv_h);  q = round(q_in · Wq_h)
//   K = round(elu(k)+1)·kmask,  V = round(v·kmask·inv_s),  Q = round(elu(q)+1)·qmask
//   KV = Kᵀ V, ΣK = Σ_s K   (f32 sums, rounded to the I/O type before use)
//   out[b, l, h·D:(h+1)·D] = round((Q·KV) / max(Q·ΣK, eps) · S)
// "round" is a cast to the I/O type T (a no-op in f32): the points where
// the Pallas kernel rounds.
//
// Design: one block per (head, batch row). The head's D columns of Wq, Wk
// and Wv stay in shared memory for the whole block (3·C·D·4 bytes, 96 KB at
// C=256, D=32), transposed so that lane j of a warp reads column j. A warp
// owns one token row at a time: it takes the row's LayerNorm with shuffles
// and projects it, lane j computing output column j (D <= 32). Pass 1
// streams the S source rows and sums KV and ΣK in f32; pass 2 streams the L
// query rows and writes the output. Nothing but the output goes back to
// device memory.
//
// Bound on the H100: at the flagship shape ([8, 400, 256], H=8, D=32) the
// sublayer moves ~6 MB and does ~1.3 GFLOP, so the card's bound is a few
// microseconds. This simple kernel does its products on the FP32 pipes,
// recomputes each row's LayerNorm once per head (8x redundant) and fills
// only B·H = 64 of 132 SMs: it is far from that bound. Tensor-core
// products and one LayerNorm per row are the first things to change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 32;
constexpr int kKvPerThread = kMaxD * kMaxD / kThreads;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float round_t(float v);
template <>
__device__ __forceinline__ float round_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float elu_p1(float x) {
  return x > 0.f ? x + 1.f : expf(x);
}

// One warp: buf[0..C) = round(LN(row) * g + b + pos), LN statistics in f32.
template <typename T>
__device__ void layernorm_row(const T* row, const T* pos, const float* ln,
                              int C, float* buf, int lane) {
  float s = 0.f;
  for (int i = lane; i < C; i += 32) {
    const float v = load_f(row + i);
    buf[i] = v;
    s += v;
  }
  const float mu = warp_sum(s) / C;
  float ss = 0.f;
  for (int i = lane; i < C; i += 32) {
    const float c = buf[i] - mu;
    ss += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ss) / C + 1e-5f);
  for (int i = lane; i < C; i += 32) {
    const float y = (buf[i] - mu) * rstd * ln[i] + ln[C + i];
    buf[i] = round_t<T>(y + load_f(pos + i));
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) linear_encoder_kernel(
    const T* __restrict__ x, const T* __restrict__ src,
    const T* __restrict__ xpos, long long xpos_bstride,
    const T* __restrict__ spos, long long spos_bstride,
    const float* __restrict__ lnq, const float* __restrict__ lnkv,
    const float* __restrict__ wq, const float* __restrict__ wk,
    const float* __restrict__ wv, const uint8_t* __restrict__ qmask,
    const uint8_t* __restrict__ kmask, T* __restrict__ out, int L, int S,
    int C, int H, float eps, float inv_s) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = C / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int jj = lane < D ? lane : 0;  // lanes >= D compute, then discard

  extern __shared__ float smem[];
  float* wq_s = smem;                   // [C][D]
  float* wk_s = wq_s + C * D;           // [C][D]
  float* wv_s = wk_s + C * D;           // [C][D]
  float* rows = wv_s + C * D;           // [kWarps][C]
  float* kt = rows + kWarps * C;        // [kWarps][kMaxD]
  float* vt = kt + kWarps * kMaxD;      // [kWarps][kMaxD]
  float* kv_s = vt + kWarps * kMaxD;    // [kMaxD][kMaxD]
  float* ks_s = kv_s + kMaxD * kMaxD;   // [kMaxD]
  float* buf = rows + warp * C;

  // Weights arrive in torch's [out, in] layout; head h owns rows h·D..h·D+D.
  for (int idx = threadIdx.x; idx < C * D; idx += kThreads) {
    const int j = idx / C;
    const int i = idx % C;
    const long long g = (long long)(h * D + j) * C + i;
    wq_s[i * D + j] = round_t<T>(wq[g]);
    wk_s[i * D + j] = round_t<T>(wk[g]);
    wv_s[i * D + j] = round_t<T>(wv[g]);
  }
  __syncthreads();

  // Pass 1: KV = Kᵀ V and ΣK over the source rows, kWarps rows a step.
  const T* src_b = src + (long long)b * S * C;
  const T* spos_b = spos + b * spos_bstride;
  float acc_kv[kKvPerThread];
  for (int e = 0; e < kKvPerThread; ++e) acc_kv[e] = 0.f;
  float acc_ks = 0.f;
  for (int s0 = 0; s0 < S; s0 += kWarps) {
    const int s = s0 + warp;
    float kval = 0.f;
    float vval = 0.f;
    if (s < S) {  // uniform across the warp
      layernorm_row<T>(src_b + (long long)s * C, spos_b + (long long)s * C,
                       lnkv, C, buf, lane);
      float ak = 0.f;
      float av = 0.f;
      for (int i = 0; i < C; ++i) {
        const float xi = buf[i];
        ak = fmaf(xi, wk_s[i * D + jj], ak);
        av = fmaf(xi, wv_s[i * D + jj], av);
      }
      const float m = (kmask == nullptr || kmask[(long long)b * S + s]) ? 1.f : 0.f;
      kval = round_t<T>(elu_p1(round_t<T>(ak))) * m;
      vval = round_t<T>(round_t<T>(av) * m * inv_s);
      if (lane >= D) kval = vval = 0.f;
    }
    kt[warp * kMaxD + lane] = kval;
    vt[warp * kMaxD + lane] = vval;
    __syncthreads();
    for (int e = 0; e < kKvPerThread; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int d = idx / kMaxD;
      const int c = idx % kMaxD;
      float a = acc_kv[e];
      for (int r = 0; r < kWarps; ++r) a = fmaf(kt[r * kMaxD + d], vt[r * kMaxD + c], a);
      acc_kv[e] = a;
    }
    if (threadIdx.x < kMaxD) {
      for (int r = 0; r < kWarps; ++r) acc_ks += kt[r * kMaxD + threadIdx.x];
    }
    __syncthreads();
  }
  for (int e = 0; e < kKvPerThread; ++e) {
    kv_s[threadIdx.x + e * kThreads] = round_t<T>(acc_kv[e]);
  }
  if (threadIdx.x < kMaxD) ks_s[threadIdx.x] = round_t<T>(acc_ks);
  __syncthreads();

  // Pass 2: each warp takes query rows on its own; no block barrier needed.
  const T* x_b = x + (long long)b * L * C;
  const T* xpos_b = xpos + b * xpos_bstride;
  T* out_b = out + (long long)b * L * C;
  const float s_len = (float)S;
  for (int l = warp; l < L; l += kWarps) {
    layernorm_row<T>(x_b + (long long)l * C, xpos_b + (long long)l * C, lnq, C,
                     buf, lane);
    float aq = 0.f;
    for (int i = 0; i < C; ++i) aq = fmaf(buf[i], wq_s[i * D + jj], aq);
    const float m = (qmask == nullptr || qmask[(long long)b * L + l]) ? 1.f : 0.f;
    float qv = round_t<T>(elu_p1(round_t<T>(aq))) * m;
    if (lane >= D) qv = 0.f;
    const float den = warp_sum(qv * ks_s[jj]);
    float o = 0.f;
    for (int d = 0; d < D; ++d) {
      o = fmaf(__shfl_sync(0xffffffffu, qv, d), kv_s[d * kMaxD + jj], o);
    }
    o = o * (1.f / fmaxf(den, eps)) * s_len;
    if (lane < D) store_t(out_b + (long long)l * C + h * D + lane, o);
    __syncwarp();  // buf is rewritten by the next row's LayerNorm
  }
}

template <typename T>
int launch(const void* x, const void* src, const void* xpos,
           long long xpos_bstride, const void* spos, long long spos_bstride,
           const void* lnq, const void* lnkv, const void* wq, const void* wk,
           const void* wv, const void* qmask, const void* kmask, void* out,
           int B, int L, int S, int C, int H, float eps, float inv_s,
           void* stream) {
  const int D = C / H;
  if (H <= 0 || C % H != 0 || D > kMaxD || C % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)3 * C * D + (size_t)kWarps * C +
                                       2 * kWarps * kMaxD + kMaxD * kMaxD + kMaxD);
  cudaError_t err = cudaFuncSetAttribute(
      linear_encoder_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check reports it
    return (int)err;
  }
  const dim3 grid(H, B);
  linear_encoder_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)src, (const T*)xpos, xpos_bstride,
      (const T*)spos, spos_bstride, (const float*)lnq, (const float*)lnkv,
      (const float*)wq, (const float*)wk, (const float*)wv,
      (const uint8_t*)qmask, (const uint8_t*)kmask, (T*)out, L, S, C, H, eps,
      inv_s);
  return (int)cudaGetLastError();
}

}  // namespace

#define OETR_LINEAR_ENCODER_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void* x, const void* src, const void* xpos,        \
                      long long xpos_bstride, const void* spos,                \
                      long long spos_bstride, const void* lnq,                 \
                      const void* lnkv, const void* wq, const void* wk,        \
                      const void* wv, const void* qmask, const void* kmask,    \
                      void* out, int B, int L, int S, int C, int H, float eps, \
                      float inv_s, void* stream) {                             \
    return launch<T>(x, src, xpos, xpos_bstride, spos, spos_bstride, lnq,      \
                     lnkv, wq, wk, wv, qmask, kmask, out, B, L, S, C, H, eps,  \
                     inv_s, stream);                                           \
  }

OETR_LINEAR_ENCODER_ENTRY(oetr_linear_encoder_f32, float)
OETR_LINEAR_ENCODER_ENTRY(oetr_linear_encoder_bf16, __nv_bfloat16)
