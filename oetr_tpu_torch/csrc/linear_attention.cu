// K1: masked linear attention, by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_attention.py::linear_attention_pallas
// (kernel _linear_attn_kernel). Per batch row b and head h, on q [B, L, H·D]
// and k, v [B, S, H·D] read in place (no transpose to [B, H, N, D]):
//   Q = round(elu(q)+1)·qmask,  K = round(elu(k)+1)·kmask
//   V = round(v·kmask · inv_s)       (inv_s = 1/S as T holds it)
//   KV = Kᵀ V, ΣK = Σ_s K            (f32 sums, rounded to T before use)
//   out = round((Q·KV) · 1/max(Q·ΣK, eps) · S)
// "round" is a cast to the I/O type T (a no-op in f32). The clamp
// max(den, eps) where the plain op adds eps is the Pallas kernel's.
//
// Design: one block per (head, batch row) runs the two passes of
// linear_attention.cuh: pass 1 streams
// the S key/value rows, a warp per row, and sums KV and ΣK in f32
// registers; pass 2 streams the L query rows, a warp per row, lane j
// writing the head's columns j and j + 32. Head widths up to 64.
//
// Bound on the H100 at [8, 400, 8, 32] bf16: 6.6 MB moved (2.0 us at
// 3.35 TB/s) against 2·B·H·(S + L)·D² = 52 MFLOP, so bytes bind. This
// simple kernel fills only B·H = 64 blocks and does its products on the
// FP32 pipes; splitting pass 1 over more blocks is the first thing to do.
#include "linear_attention.cuh"

namespace {

using namespace oetr;
using linear::kMaxD;
using linear::kThreads;
using linear::kWarps;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) linear_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ qmask, const uint8_t* __restrict__ kmask,
    T* __restrict__ out, int L, int S, int H, int D, float eps, float inv_s) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HD = H * D;

  __shared__ float pass_mem[linear::kPassFloats];
  linear::Pass pass(pass_mem);

  // Pass 1: KV = Kᵀ V and ΣK over the key rows, kWarps rows a step.
  for (int s0 = 0; s0 < S; s0 += kWarps) {
    const int s = s0 + warp;
    float kval[NC], vval[NC];
    for (int c = 0; c < NC; ++c) kval[c] = vval[c] = 0.f;
    if (s < S) {
      const long long row = ((long long)b * S + s) * HD + h * D;
      const float m = (kmask == nullptr || kmask[(long long)b * S + s]) ? 1.f : 0.f;
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c;
        if (j < D) {
          kval[c] = round_t<T>(elu_p1(load_f(k + row + j))) * m;
          vval[c] = round_t<T>(load_f(v + row + j) * m * inv_s);
        }
      }
    }
    for (int c = 0; c < NC; ++c) {
      pass.kt[warp * kMaxD + lane + 32 * c] = kval[c];
      pass.vt[warp * kMaxD + lane + 32 * c] = vval[c];
    }
    __syncthreads();
    pass.accumulate(D);
    __syncthreads();
  }
  pass.finish<T>(D);
  __syncthreads();

  // Pass 2: each warp takes query rows on its own.
  const float s_len = (float)S;
  for (int l = warp; l < L; l += kWarps) {
    const long long row = ((long long)b * L + l) * HD + h * D;
    const float m = (qmask == nullptr || qmask[(long long)b * L + l]) ? 1.f : 0.f;
    float qv[NC], o[NC];
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c;
      qv[c] = j < D ? round_t<T>(elu_p1(load_f(q + row + j))) * m : 0.f;
    }
    pass.output_row<NC>(qv, D, lane, eps, s_len, o);
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c;
      if (j < D) store_t(out + row + j, o[c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qmask,
           const void* kmask, void* out, int B, int L, int S, int H, int D,
           float eps, float inv_s, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(H, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) {
    linear_attention_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)qmask,
        (const uint8_t*)kmask, (T*)out, L, S, H, D, eps, inv_s);
  } else {
    linear_attention_kernel<T, 2><<<grid, kThreads, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)qmask,
        (const uint8_t*)kmask, (T*)out, L, S, H, D, eps, inv_s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define OETR_LINEAR_ATTENTION_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v,             \
                      const void* qmask, const void* kmask, void* out, int B,  \
                      int L, int S, int H, int D, float eps, float inv_s,      \
                      void* stream) {                                          \
    return launch<T>(q, k, v, qmask, kmask, out, B, L, S, H, D, eps, inv_s,    \
                     stream);                                                  \
  }

OETR_LINEAR_ATTENTION_ENTRY(oetr_linear_attention_f32, float)
OETR_LINEAR_ATTENTION_ENTRY(oetr_linear_attention_bf16, __nv_bfloat16)
