// K3: GroupNorm + ReLU + 3x3/s2 max-pool (pad 1), by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_norm.py::groupnorm_relu_maxpool: the
// statistics that the JAX wrapper folds into a per-(batch, channel) scale
// and shift outside its pallas_call (gn_scale_shift), and the kernel
// _apply_pool_kernel, which computes
//   out[b, oy, ox, c] = max over the 3x3 window at rows 2·oy-1..2·oy+1 and
//                       columns 2·ox-1..2·ox+1 of relu(x·scale + shift)
// on NHWC tensors, in f32, rounded once to the I/O type. Three launches:
//   1. statistics: each block sums x and x² per channel (f32) over a run of
//      kPixPerBlock pixels of one image, V channels a thread, and writes the
//      block's partial sums;
//   2. fold: one block per image sums the partials in block order, then
//      the channels of each group, and writes scale and shift [B, C] by
//      gn_scale_shift's formula: var = E[x²] - E[x]², not clipped at 0
//      (as oetr_tpu/ops/pallas_norm.py:52 computes it);
//   3. apply + ReLU + pool: a thread owns V channels of one output column
//      over a strip of kStripRows output rows. It walks down the strip's
//      input rows once, keeping each row's max over its three columns in
//      registers, so a window's rows are shared with the next output row;
//      the columns shared with the neighbouring output column are read by
//      the neighbouring lane and come from L1.
// V is 8 (16-byte loads and stores) where C is a multiple of 8 and every
// tensor is 16-byte aligned, as at the stem; else 1, so that any C and any
// element offset run, at scalar loads.
// Taps outside the image are skipped. That is exact: after the ReLU every
// value is >= 0, and every window holds at least one tap inside the image,
// so a skipped tap (-inf padding) never wins the max. No atomics: every sum
// is taken in a fixed order.
//
// Bound on the H100: bytes. At the stem's [16, 320, 320, 64] bf16 input one
// read of x and one write of the output are 210 + 52 MB, 78 us at
// 3.35 TB/s; the statistics read x a second time unless it stays in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatThreads = 256;
constexpr int kPixPerBlock = 2048;   // pixels of one image a stats block sums
constexpr int kFoldThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kStripRows = 8;        // output rows an apply thread walks

// V consecutive channels as f32; for V = 8, p is 16-byte aligned.
__device__ __forceinline__ void loadv(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void loadv(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void storev(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void storev(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[1]) {
  p[0] = __float2bfloat16(v[0]);
}

// Block (run, image, z): per-channel sums of x and x² over pixels
// [run·kPixPerBlock, +kPixPerBlock) of the image, for the `per_block`
// groups of V channels from z·per_block on, into part[image][run][2][C].
// Thread t owns group t % per_block and pixels t / per_block + k·lanes.
template <typename T, int V>
__global__ void __launch_bounds__(kStatThreads) gn_stats_kernel(
    const T* __restrict__ x, float* __restrict__ part, int HW, int C,
    int per_block) {
  __shared__ float red[2][kStatThreads * 8];
  const int lanes = blockDim.x / per_block, width = per_block * V;
  const int cl = threadIdx.x % per_block, pl = threadIdx.x / per_block;
  const int c0 = blockIdx.z * width;            // the block's first channel
  const int runs = gridDim.x;
  const int p0 = blockIdx.x * kPixPerBlock;
  const int p1 = min(HW, p0 + kPixPerBlock);
  const T* xb = x + (long long)blockIdx.y * HW * C + c0 + cl * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (c0 + cl * V < C) {
#pragma unroll 4
    for (int p = p0 + pl; p < p1; p += lanes) {
      float v[V];
      loadv(xb + (long long)p * C, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += v[k];
        s2[k] = fmaf(v[k], v[k], s2[k]);
      }
    }
  }
  // red[.][lane·width + c]: lanes·width <= V·blockDim.x floats. Summed in
  // lane order.
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[0][pl * width + cl * V + k] = s1[k];
    red[1][pl * width + cl * V + k] = s2[k];
  }
  __syncthreads();
  float* out = part + ((long long)blockIdx.y * runs + blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < width && c0 + c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += red[0][l * width + c];
      b += red[1][l * width + c];
    }
    out[c0 + c] = a;
    out[C + c0 + c] = b;
  }
}

// Block b: scale and shift [C] of image b from its `runs` partials, which
// it sums in run order into its first run's place.
__global__ void __launch_bounds__(kFoldThreads) gn_fold_kernel(
    float* __restrict__ part, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ scale,
    float* __restrict__ shift, int HW, int C, int groups, int runs,
    float eps) {
  float* pb = part + (long long)blockIdx.x * runs * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < runs; ++r) acc += pb[(long long)r * 2 * C + c];
    pb[c] = acc;
  }
  __syncthreads();
  const int per = C / groups;
  const float n = (float)HW * per;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g0 = c / per * per;
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < per; ++k) {
      t1 += pb[g0 + k];
      t2 += pb[C + g0 + k];
    }
    const float mean = t1 / n;
    const float var = t2 / n - mean * mean;
    const float inv = rsqrtf(var + eps);
    const float sc = inv * gamma[c];
    scale[(long long)blockIdx.x * C + c] = sc;
    shift[(long long)blockIdx.x * C + c] = beta[c] - mean * inv * gamma[c];
  }
}

// h = max over columns 2·ox-1..2·ox+1 of relu(x·sc + sh) at input row iy;
// 0 where the row or a column lies outside the image.
template <typename T, int V>
__device__ __forceinline__ void row_max3(const T* __restrict__ xb, int iy,
                                         int ox, int H, int W, int C,
                                         const float (&sc)[V],
                                         const float (&sh)[V],
                                         float (&h)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = 0.f;
  if (iy < 0 || iy >= H) return;
  const T* row = xb + (long long)iy * W * C;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const int ix = 2 * ox + dx;
    if (ix < 0 || ix >= W) continue;
    float v[V];
    loadv(row + (long long)ix * C, v);
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = fmaxf(h[k], fmaf(v[k], sc[k], sh[k]));
  }
}

// Thread (image, strip, ox, channel group): output rows
// [strip·kStripRows, +kStripRows) of column ox, V channels.
template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads) gn_apply_pool_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ out, int H, int W, int C,
    int strips, long long total) {
  const long long idx = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
  if (idx >= total) return;
  const int cgroups = C / V, Ho = H / 2, Wo = W / 2;
  const int cg = (int)(idx % cgroups);
  long long t = idx / cgroups;
  const int ox = (int)(t % Wo);
  t /= Wo;
  const int strip = (int)(t % strips);
  const int b = (int)(t / strips);
  float sc[V], sh[V];
  loadv(scale + (long long)b * C + cg * V, sc);
  loadv(shift + (long long)b * C + cg * V, sh);
  const T* xb = x + (long long)b * H * W * C + cg * V;
  T* ob = out + ((long long)b * Ho * Wo + ox) * C + cg * V;
  const int oy0 = strip * kStripRows, oy1 = min(Ho, oy0 + kStripRows);
  float acc[V];
  row_max3<T, V>(xb, 2 * oy0 - 1, ox, H, W, C, sc, sh, acc);
  for (int oy = oy0; oy < oy1; ++oy) {
    float h0[V], h1[V];
    row_max3<T, V>(xb, 2 * oy, ox, H, W, C, sc, sh, h0);
    row_max3<T, V>(xb, 2 * oy + 1, ox, H, W, C, sc, sh, h1);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = fmaxf(acc[k], fmaxf(h0[k], h1[k]));
    storev(ob + (long long)oy * Wo * C, acc);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = h1[k];   // row 2·(oy + 1) - 1
  }
}

bool shape_ok(int B, int H, int W, int C, int groups) {
  return B > 0 && H >= 2 && W >= 2 && H % 2 == 0 && W % 2 == 0 && C > 0 &&
         groups > 0 && C % groups == 0;
}

// 8 channels a thread where C and every pointer allow 16-byte accesses.
bool vec8(int C, const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                        (uintptr_t)d;
  return C % 8 == 0 && (any & 15) == 0;
}

int runs_per_image(int H, int W) {
  return (H * W + kPixPerBlock - 1) / kPixPerBlock;
}

// Statistics and fold of B images: part holds B · runs · 2 · C floats.
template <typename T, int V>
cudaError_t stats(const T* x, const float* gamma, const float* beta,
                  float* part, float* scale, float* shift, int B, int H,
                  int W, int C, int groups, float eps, cudaStream_t stream) {
  const int runs = runs_per_image(H, W);
  const int vgroups = C / V;
  const int per_block = vgroups < kStatThreads ? vgroups : kStatThreads;
  const int threads = per_block * (kStatThreads / per_block);
  const dim3 grid(runs, B, (vgroups + per_block - 1) / per_block);
  gn_stats_kernel<T, V><<<grid, threads, 0, stream>>>(x, part, H * W, C,
                                                      per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_fold_kernel<<<B, kFoldThreads, 0, stream>>>(part, gamma, beta, scale,
                                                 shift, H * W, C, groups,
                                                 runs, eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t apply(const T* x, const float* scale, const float* shift, T* out,
                  int B, int H, int W, int C, cudaStream_t stream) {
  const int strips = (H / 2 + kStripRows - 1) / kStripRows;
  const long long total = (long long)B * strips * (W / 2) * (C / V);
  const long long blocks = (total + kApplyThreads - 1) / kApplyThreads;
  gn_apply_pool_kernel<T, V><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
      x, scale, shift, out, H, W, C, strips, total);
  return cudaGetLastError();
}

template <typename T>
int gn_relu_maxpool(const void* x, const void* gamma, const void* beta,
                    void* work, void* out, int B, int H, int W, int C,
                    int groups, float eps, void* stream) {
  if (!shape_ok(B, H, W, C, groups)) return (int)cudaErrorInvalidValue;
  // work: scale [B, C], shift [B, C], then the partials.
  float* scale = (float*)work;
  float* shift = scale + (long long)B * C;
  float* part = shift + (long long)B * C;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool v8 = vec8(C, x, out, scale, shift);
  cudaError_t err =
      v8 ? stats<T, 8>((const T*)x, (const float*)gamma, (const float*)beta,
                       part, scale, shift, B, H, W, C, groups, eps, s)
         : stats<T, 1>((const T*)x, (const float*)gamma, (const float*)beta,
                       part, scale, shift, B, H, W, C, groups, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = v8 ? apply<T, 8>((const T*)x, scale, shift, (T*)out, B, H, W, C, s)
           : apply<T, 1>((const T*)x, scale, shift, (T*)out, B, H, W, C, s);
  return (int)err;
}

template <typename T>
int gn_stats(const void* x, const void* gamma, const void* beta, void* work,
             int B, int H, int W, int C, int groups, float eps, void* stream) {
  if (!shape_ok(B, H, W, C, groups)) return (int)cudaErrorInvalidValue;
  float* scale = (float*)work;
  float* shift = scale + (long long)B * C;
  float* part = shift + (long long)B * C;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec8(C, x, x, x, x)
                   ? stats<T, 8>((const T*)x, (const float*)gamma,
                                 (const float*)beta, part, scale, shift, B, H,
                                 W, C, groups, eps, s)
                   : stats<T, 1>((const T*)x, (const float*)gamma,
                                 (const float*)beta, part, scale, shift, B, H,
                                 W, C, groups, eps, s));
}

template <typename T>
int gn_apply_pool(const void* x, const void* scale, const void* shift,
                  void* out, int B, int H, int W, int C, void* stream) {
  if (!shape_ok(B, H, W, C, 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec8(C, x, scale, shift, out)
                   ? apply<T, 8>((const T*)x, (const float*)scale,
                                 (const float*)shift, (T*)out, B, H, W, C, s)
                   : apply<T, 1>((const T*)x, (const float*)scale,
                                 (const float*)shift, (T*)out, B, H, W, C, s));
}

}  // namespace

// Floats of the work buffer for B images: scale [B, C] and shift [B, C],
// then the statistics' partials [B, runs, 2, C].
extern "C" long long oetr_gn_workspace_floats(int B, int H, int W, int C) {
  return 2LL * B * C + 2LL * B * runs_per_image(H, W) * C;
}

// The whole of K3: x [B, H, W, C] NHWC, gamma/beta [C] f32, out
// [B, H/2, W/2, C].
extern "C" int oetr_gn_relu_maxpool_f32(const void* x, const void* gamma,
                                        const void* beta, void* work,
                                        void* out, int B, int H, int W, int C,
                                        int groups, float eps, void* stream) {
  return gn_relu_maxpool<float>(x, gamma, beta, work, out, B, H, W, C,
                                groups, eps, stream);
}

extern "C" int oetr_gn_relu_maxpool_bf16(const void* x, const void* gamma,
                                         const void* beta, void* work,
                                         void* out, int B, int H, int W,
                                         int C, int groups, float eps,
                                         void* stream) {
  return gn_relu_maxpool<__nv_bfloat16>(x, gamma, beta, work, out, B, H, W,
                                        C, groups, eps, stream);
}

// The statistics alone: scale and shift [B, C] at the head of `work`.
extern "C" int oetr_gn_stats_f32(const void* x, const void* gamma,
                                 const void* beta, void* work, int B, int H,
                                 int W, int C, int groups, float eps,
                                 void* stream) {
  return gn_stats<float>(x, gamma, beta, work, B, H, W, C, groups, eps,
                         stream);
}

extern "C" int oetr_gn_stats_bf16(const void* x, const void* gamma,
                                  const void* beta, void* work, int B, int H,
                                  int W, int C, int groups, float eps,
                                  void* stream) {
  return gn_stats<__nv_bfloat16>(x, gamma, beta, work, B, H, W, C, groups,
                                 eps, stream);
}

// The apply + ReLU + pool alone, from a given scale and shift [B, C].
extern "C" int oetr_gn_apply_pool_f32(const void* x, const void* scale,
                                      const void* shift, void* out, int B,
                                      int H, int W, int C, void* stream) {
  return gn_apply_pool<float>(x, scale, shift, out, B, H, W, C, stream);
}

extern "C" int oetr_gn_apply_pool_bf16(const void* x, const void* scale,
                                       const void* shift, void* out, int B,
                                       int H, int W, int C, void* stream) {
  return gn_apply_pool<__nv_bfloat16>(x, scale, shift, out, B, H, W, C,
                                      stream);
}

// The message of a cudaError_t returned by an entry point of the library.
extern "C" const char* oetr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
