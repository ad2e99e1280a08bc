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
// Design: one block per (head, batch row), the two passes of
// linear_attention.cuh. A warp owns one token row at a time: it takes the
// row's LayerNorm with shuffles and projects it, lane j computing the head's
// output columns j and j + 32. Pass 1 streams the S source rows and sums KV
// and ΣK in f32; pass 2 streams the L query rows and writes the output.
// Nothing but the output goes back to device memory.
// The weights each pass needs (Wk and Wv in pass 1, Wq in pass 2) are
// staged in shared memory, rounded to the I/O type, transposed so that lane
// j reads column j: as f32 where 2·C·D·4 bytes fit beside the row buffers
// (64 KB at the flagship's C = 256, D = 32), else in the I/O type (bf16 at
// C = 512, D = 64: 128 KB). Where neither fits (f32 at C = 512, D = 64),
// the lanes read the f32 weights from global memory, through L1 and L2.
// Any C that is a multiple of 32 and any D = C/H up to 64 is taken.
//
// Bound on the H100: at the flagship shape ([8, 400, 256], H=8, D=32) the
// sublayer moves ~6 MB and does ~1.3 GFLOP, so the card's bound is a few
// microseconds. This simple kernel does its products on the FP32 pipes,
// recomputes each row's LayerNorm once per head (8x redundant) and fills
// only B·H = 64 of 132 SMs: it is far from that bound. Tensor-core
// products and one LayerNorm per row are the first things to change.
#include "linear_attention.cuh"

namespace {

using namespace oetr;
using linear::kMaxD;
using linear::kThreads;
using linear::kWarps;

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

// The head's weight columns, from shared memory (transposed, rounded to T,
// held as W: float or T) or from the f32 [out, in] array in global memory.
template <typename T, typename W, bool kSmem>
struct Weights {
  const W* s;          // [C][D] in shared memory
  const float* g;      // row h·D of the global [C, C] array
  int C, D;
  __device__ __forceinline__ float operator()(int i, int j) const {
    if (kSmem) return load_f(s + i * D + j);
    return round_t<T>(__ldg(g + (long long)j * C + i));
  }
};

template <typename T, typename W>
__device__ void stage(W* dst, const float* w, int h, int C, int D) {
  for (int idx = threadIdx.x; idx < C * D; idx += kThreads) {
    const int j = idx / C;
    const int i = idx % C;
    store_t(dst + i * D + j, round_t<T>(w[(long long)(h * D + j) * C + i]));
  }
}

// One projected column pair per lane: acc[k][c] = Σ_i buf[i] W_k(i, j_c).
template <int NC, int NW, typename W>
__device__ __forceinline__ void project(const float* buf, int C, const W* w,
                                        const int (&jj)[NC],
                                        float (&acc)[NW][NC]) {
  for (int k = 0; k < NW; ++k)
    for (int c = 0; c < NC; ++c) acc[k][c] = 0.f;
  for (int i = 0; i < C; ++i) {
    const float xi = buf[i];
    for (int k = 0; k < NW; ++k)
      for (int c = 0; c < NC; ++c) acc[k][c] = fmaf(xi, w[k](i, jj[c]), acc[k][c]);
  }
}

template <typename T, typename W, int NC, bool kSmem>
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
  int jj[NC];
  for (int c = 0; c < NC; ++c) {
    const int j = lane + 32 * c;
    jj[c] = j < D ? j : 0;  // lanes past D compute, then discard
  }

  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                                  // [kWarps][C]
  linear::Pass pass(rows + kWarps * C);
  W* w_s = reinterpret_cast<W*>(rows + kWarps * C + linear::kPassFloats);
  float* buf = rows + warp * C;

  // Pass 1: KV = Kᵀ V and ΣK over the source rows, kWarps rows a step.
  Weights<T, W, kSmem> w1[2] = {{w_s, wk + (long long)h * D * C, C, D},
                                {w_s + C * D, wv + (long long)h * D * C, C, D}};
  if (kSmem) {
    stage<T>(w_s, wk, h, C, D);
    stage<T>(w_s + C * D, wv, h, C, D);
    __syncthreads();
  }
  const T* src_b = src + (long long)b * S * C;
  const T* spos_b = spos + b * spos_bstride;
  for (int s0 = 0; s0 < S; s0 += kWarps) {
    const int s = s0 + warp;
    float kval[NC], vval[NC];
    for (int c = 0; c < NC; ++c) kval[c] = vval[c] = 0.f;
    if (s < S) {  // uniform across the warp
      layernorm_row<T>(src_b + (long long)s * C, spos_b + (long long)s * C,
                       lnkv, C, buf, lane);
      float acc[2][NC];
      project<NC, 2>(buf, C, w1, jj, acc);
      const float m = (kmask == nullptr || kmask[(long long)b * S + s]) ? 1.f : 0.f;
      for (int c = 0; c < NC; ++c) {
        if (lane + 32 * c < D) {
          kval[c] = round_t<T>(elu_p1(round_t<T>(acc[0][c]))) * m;
          vval[c] = round_t<T>(round_t<T>(acc[1][c]) * m * inv_s);
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

  // Pass 2: Wq replaces Wk and Wv; then each warp takes query rows on its
  // own, with no block barrier.
  Weights<T, W, kSmem> w2[1] = {{w_s, wq + (long long)h * D * C, C, D}};
  if (kSmem) stage<T>(w_s, wq, h, C, D);
  __syncthreads();
  const T* x_b = x + (long long)b * L * C;
  const T* xpos_b = xpos + b * xpos_bstride;
  T* out_b = out + (long long)b * L * C;
  const float s_len = (float)S;
  for (int l = warp; l < L; l += kWarps) {
    layernorm_row<T>(x_b + (long long)l * C, xpos_b + (long long)l * C, lnq, C,
                     buf, lane);
    float acc[1][NC];
    project<NC, 1>(buf, C, w2, jj, acc);
    const float m = (qmask == nullptr || qmask[(long long)b * L + l]) ? 1.f : 0.f;
    float qv[NC], o[NC];
    for (int c = 0; c < NC; ++c) {
      qv[c] = lane + 32 * c < D ? round_t<T>(elu_p1(round_t<T>(acc[0][c]))) * m : 0.f;
    }
    pass.output_row<NC>(qv, D, lane, eps, s_len, o);
    for (int c = 0; c < NC; ++c) {
      if (lane + 32 * c < D) store_t(out_b + (long long)l * C + h * D + lane + 32 * c, o[c]);
    }
    __syncwarp();  // buf is rewritten by the next row's LayerNorm
  }
}

template <typename T, typename W, int NC, bool kSmem>
int launch_one(const void* x, const void* src, const void* xpos,
               long long xpos_bstride, const void* spos, long long spos_bstride,
               const void* lnq, const void* lnkv, const void* wq,
               const void* wk, const void* wv, const void* qmask,
               const void* kmask, void* out, int B, int L, int S, int C, int H,
               float eps, float inv_s, size_t smem, cudaStream_t stream) {
  auto kernel = linear_encoder_kernel<T, W, NC, kSmem>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check reports it
    return (int)err;
  }
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)x, (const T*)src, (const T*)xpos, xpos_bstride,
      (const T*)spos, spos_bstride, (const float*)lnq, (const float*)lnkv,
      (const float*)wq, (const float*)wk, (const float*)wv,
      (const uint8_t*)qmask, (const uint8_t*)kmask, (T*)out, L, S, C, H, eps,
      inv_s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* src, const void* xpos,
           long long xpos_bstride, const void* spos, long long spos_bstride,
           const void* lnq, const void* lnkv, const void* wq, const void* wk,
           const void* wv, const void* qmask, const void* kmask, void* out,
           int B, int L, int S, int C, int H, float eps, float inv_s,
           void* stream) {
  if (H <= 0 || C % H != 0 || C % 32 != 0 || C / H > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = C / H;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t base = sizeof(float) * ((size_t)kWarps * C + linear::kPassFloats);
  const size_t w_f32 = base + 2 * sizeof(float) * (size_t)C * D;
  const size_t w_t = base + 2 * sizeof(T) * (size_t)C * D;
  cudaStream_t st = (cudaStream_t)stream;
#define OETR_K2_ARGS(SMEM)                                                    \
  x, src, xpos, xpos_bstride, spos, spos_bstride, lnq, lnkv, wq, wk, wv,     \
      qmask, kmask, out, B, L, S, C, H, eps, inv_s, SMEM, st
#define OETR_K2_LAUNCH(NC)                                                    \
  if (w_f32 <= (size_t)max_smem)                                              \
    return launch_one<T, float, NC, true>(OETR_K2_ARGS(w_f32));               \
  if (sizeof(T) < sizeof(float) && w_t <= (size_t)max_smem)                   \
    return launch_one<T, T, NC, true>(OETR_K2_ARGS(w_t));                     \
  return launch_one<T, float, NC, false>(OETR_K2_ARGS(base));
  if (D <= 32) {
    OETR_K2_LAUNCH(1)
  }
  OETR_K2_LAUNCH(2)
#undef OETR_K2_LAUNCH
#undef OETR_K2_ARGS
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
