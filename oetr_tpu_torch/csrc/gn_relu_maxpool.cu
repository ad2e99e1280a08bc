// K3: GroupNorm-apply + ReLU + 3x3/s2 max-pool (pad 1), by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_norm.py::groupnorm_relu_maxpool (kernel
// _apply_pool_kernel). The GroupNorm statistics are folded on the host side
// into a per-(batch, channel) scale and shift (f32, [B, C]), as the JAX
// wrapper does outside its pallas_call; this kernel computes
//   out[b, oy, ox, c] = max over the 3x3 window at rows 2·oy-1..2·oy+1 and
//                       columns 2·ox-1..2·ox+1 of relu(x·scale + shift)
// on NHWC tensors, in f32, rounded once to the I/O type.
//
// Taps outside the image are skipped. That is exact: after the ReLU every
// value is >= 0, and every window holds at least one tap inside the image,
// so a skipped tap (-inf padding) never wins the max.
//
// Bound on the H100: bytes. At the stem's [16, 320, 320, 64] bf16 input it
// reads 210 MB and writes 52 MB, ~78 us at 3.35 TB/s; the arithmetic is a
// few operations per byte. One thread per output element with C innermost
// keeps each warp's loads of a tap on consecutive addresses; the windows
// overlap, so L1/L2 absorb most of the 2.25x re-reads of the input.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gn_relu_maxpool_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ out, int H, int W, int C,
    long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int Ho = H / 2;
  const int Wo = W / 2;
  const int c = (int)(idx % C);
  long long t = idx / C;
  const int ox = (int)(t % Wo);
  t /= Wo;
  const int oy = (int)(t % Ho);
  const int b = (int)(t / Ho);
  const float sc = scale[b * C + c];
  const float sh = shift[b * C + c];
  const T* xb = x + (long long)b * H * W * C + c;
  float m = 0.f;  // the ReLU: every candidate is >= 0
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = 2 * oy - 1 + ky;
    if (iy < 0 || iy >= H) continue;
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = 2 * ox - 1 + kx;
      if (ix < 0 || ix >= W) continue;
      m = fmaxf(m, load_f(xb + ((long long)iy * W + ix) * C) * sc + sh);
    }
  }
  store_t(out + idx, m);
}

template <typename T>
int launch(const void* x, const void* scale, const void* shift, void* out,
           int B, int H, int W, int C, void* stream) {
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || H % 2 != 0 || W % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)B * (H / 2) * (W / 2) * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gn_relu_maxpool_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const T*)x, (const float*)scale, (const float*)shift, (T*)out, H, W, C,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int oetr_gn_relu_maxpool_f32(const void* x, const void* scale,
                                        const void* shift, void* out, int B,
                                        int H, int W, int C, void* stream) {
  return launch<float>(x, scale, shift, out, B, H, W, C, stream);
}

extern "C" int oetr_gn_relu_maxpool_bf16(const void* x, const void* scale,
                                         const void* shift, void* out, int B,
                                         int H, int W, int C, void* stream) {
  return launch<__nv_bfloat16>(x, scale, shift, out, B, H, W, C, stream);
}

// The message of a cudaError_t returned by an entry point above.
extern "C" const char* oetr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
