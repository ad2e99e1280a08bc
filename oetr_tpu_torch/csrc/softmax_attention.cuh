// f32 masked softmax attention on the FP32 pipes, shared by K5
// (full_attention.cu: whole-row softmax) and K6 (flash_attention.cu:
// streaming softmax with an online max). bf16 runs on the tensor cores
// instead (softmax_attention_mma.cuh); in f32 they would round the inputs
// to TF32.
//
// Layout: q [B, L, H·D], k, v [B, S, H·D], out [B, L, H·D] f32, read and written
// in place for head h (no transpose to [B, H, N, D]); masks [B, L] / [B, S]
// as bytes, or null for all true. A pair (l, s) is visible when both masks
// are true; a row with no visible key gives 0.
//
// Block: one (query tile of kBQ = 64 rows, head, batch row), 256 threads.
// Thread (r, t) = (tid / 4, tid % 4) owns query row r of the tile, holds
// its D query values and a D-wide f32 accumulator in registers, and takes
// the keys t, t + 4, ... of each 64-key tile (16 a tile). The four threads
// of a row are adjacent lanes, so the row's max and sum are two xor
// shuffles, and the four partial accumulators are summed the same way at
// the end. Key and value rows are staged in shared memory, padded by 4
// elements a row so that the four keys a warp reads at once fall in
// distinct banks; each thread reads them 4 elements at a time.
// Logits are f32 dot products times 1/sqrt(D), as the Pallas kernels do;
// the products run on the FP32 pipes.
#pragma once

#include <math.h>

#include "common.cuh"

namespace oetr {
namespace softmax {

constexpr int kBQ = 64;          // query rows per block
constexpr int kTPR = 4;          // threads per query row
constexpr int kThreads = kBQ * kTPR;
constexpr int kBK = 64;          // keys per tile (K6's block_k)
constexpr int kKPT = kBK / kTPR;  // keys per thread per tile
constexpr int kPad = 4;          // elements of padding per staged row

// Shared-memory bytes for `rows` staged key/value rows.
template <int D>
inline size_t stage_bytes(int rows) {
  return (2 * (size_t)rows * (D + kPad) * sizeof(float) + rows + 15) / 16 * 16;
}

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// kFlash = false: K5. Pass 1 walks the key tiles for each row's max and
// sum (the sum rescaled when the max grows); pass 2 walks them again with
// p = exp(logit - max), attn = round(p / max(sum, 1e-30)) and acc += attn·v.
// When every key row fits `chunk` staged rows the keys are staged once for
// both passes; otherwise each pass stages them chunk by chunk.
// kFlash = true: K6. One pass; at each tile of kBK keys, with the running
// max m and the tile's max, new = max(m, tile), safe = new if finite else
// 0, corr = exp(m - safe) if m is finite else 0, p = exp(logit - safe) (0
// off the masks), acc = acc·corr + p·v, sum = sum·corr + Σp; at the end
// out = acc / max(sum, 1e-30). (The Pallas kernels' roundings to the I/O
// type are no-ops in f32.)
template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ qmask,
    const uint8_t* __restrict__ kmask, float* __restrict__ out, int L, int S,
    int H, float temp, int chunk) {
  constexpr int RS = D + kPad;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r = threadIdx.x / kTPR;
  const int t = threadIdx.x % kTPR;
  const int l = blockIdx.x * kBQ + r;
  const long long HD = (long long)H * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [chunk][RS]
  float* vs = ks + (size_t)chunk * RS;             // [chunk][RS]
  uint8_t* kok = reinterpret_cast<uint8_t*>(vs + (size_t)chunk * RS);  // [chunk]

  const bool row_ok = l < L && (qmask == nullptr || qmask[(long long)b * L + l]);
  float qr[D];
  float acc[D];
  if (l < L) {
    const float* qrow = q + ((long long)b * L + l) * HD + (long long)h * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x = load4(qrow + d);
      qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  float m = -INFINITY;   // running max of the row (same in its 4 threads)
  float lsum = 0.f;      // this thread's share of the row's sum
  float safe = 0.f;      // K5 pass 2: the row's max, 0 if none is finite
  float den = 1e-30f;    // K5 pass 2: max(sum, 1e-30)
  const bool resident = S <= chunk;
  constexpr int kPasses = kFlash ? 1 : 2;

  for (int pass = 0; pass < kPasses; ++pass) {
    for (int c0 = 0; c0 < S; c0 += chunk) {
      const int rows = min(chunk, S - c0);
      const int staged = (rows + kBK - 1) / kBK * kBK;
      if (!(resident && pass > 0)) {
        __syncthreads();  // the previous chunk is no longer read
        const float* kb = k + ((long long)b * S + c0) * HD + (long long)h * D;
        const float* vb = v + ((long long)b * S + c0) * HD + (long long)h * D;
        for (int idx = threadIdx.x; idx < staged * (D / 4); idx += kThreads) {
          const int row = idx / (D / 4);
          const int col = (idx % (D / 4)) * 4;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(ks + row * RS + col) =
              row < rows ? load4(kb + row * HD + col) : zero;
          *reinterpret_cast<float4*>(vs + row * RS + col) =
              row < rows ? load4(vb + row * HD + col) : zero;
        }
        for (int row = threadIdx.x; row < staged; row += kThreads) {
          kok[row] = row < rows &&
                     (kmask == nullptr || kmask[(long long)b * S + c0 + row]);
        }
        __syncthreads();
      }

      for (int t0 = 0; t0 < rows; t0 += kBK) {
        float lg[kKPT];
#pragma unroll
        for (int j = 0; j < kKPT; ++j) lg[j] = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
#pragma unroll
          for (int j = 0; j < kKPT; ++j) {
            const float4 kk = load4(ks + (t0 + t + kTPR * j) * RS + d);
            lg[j] = fmaf(qr[d], kk.x, lg[j]);
            lg[j] = fmaf(qr[d + 1], kk.y, lg[j]);
            lg[j] = fmaf(qr[d + 2], kk.z, lg[j]);
            lg[j] = fmaf(qr[d + 3], kk.w, lg[j]);
          }
        }
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKPT; ++j) {
          const bool ok = row_ok && kok[t0 + t + kTPR * j];
          lg[j] = ok ? lg[j] * temp : -INFINITY;
          tile_max = fmaxf(tile_max, lg[j]);
        }
        tile_max = row_max(tile_max);

        if (!kFlash && pass == 0) {
          // K5, pass 1: the row's max and its sum, rescaled as the max grows.
          const float new_m = fmaxf(m, tile_max);
          if (new_m != -INFINITY) {
            float s = m != -INFINITY ? lsum * expf(m - new_m) : 0.f;
#pragma unroll
            for (int j = 0; j < kKPT; ++j) {
              if (lg[j] != -INFINITY) s += expf(lg[j] - new_m);
            }
            lsum = s;
            m = new_m;
          }
          continue;
        }

        float p[kKPT];
        if (kFlash) {
          const float new_m = fmaxf(m, tile_max);
          const float sm = new_m != -INFINITY ? new_m : 0.f;
          const float corr = m != -INFINITY ? expf(m - sm) : 0.f;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kKPT; ++j) {
            p[j] = lg[j] != -INFINITY ? expf(lg[j] - sm) : 0.f;
            s += p[j];
          }
          lsum = lsum * corr + s;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] *= corr;
          m = new_m;
        } else {
#pragma unroll
          for (int j = 0; j < kKPT; ++j) {
            const float e = lg[j] != -INFINITY ? expf(lg[j] - safe) : 0.f;
            p[j] = __fdiv_rn(e, den);
          }
        }
#pragma unroll
        for (int j = 0; j < kKPT; ++j) {
          const float* vrow = vs + (t0 + t + kTPR * j) * RS;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 vv = load4(vrow + d);
            acc[d] = fmaf(p[j], vv.x, acc[d]);
            acc[d + 1] = fmaf(p[j], vv.y, acc[d + 1]);
            acc[d + 2] = fmaf(p[j], vv.z, acc[d + 2]);
            acc[d + 3] = fmaf(p[j], vv.w, acc[d + 3]);
          }
        }
      }
    }
    if (!kFlash && pass == 0) {
      den = fmaxf(row_sum(lsum), 1e-30f);
      safe = m != -INFINITY ? m : 0.f;
    }
  }

  // Sum the row's four partial accumulators; thread t writes columns
  // [t·D/4, (t+1)·D/4).
  const float total = kFlash ? fmaxf(row_sum(lsum), 1e-30f) : 1.f;
  float* orow = out + ((long long)b * L + l) * HD + (long long)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float a = row_sum(acc[d]);
    if (l < L && d / (D / kTPR) == t) orow[d] = kFlash ? __fdiv_rn(a, total) : a;
  }
}

// Launch one of the kernels; `chunk` is the number of key rows staged at
// once (a multiple of kBK). Returns the cudaError_t of the launch.
template <int D, bool kFlash>
int launch(const void* q, const void* k, const void* v, const void* qmask,
           const void* kmask, void* out, int B, int L, int S, int H,
           float temp, int chunk, cudaStream_t stream) {
  auto kernel = attention_kernel<D, kFlash>;
  const size_t smem = stage_bytes<D>(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check reports it
    return (int)err;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const uint8_t*)qmask,
      (const uint8_t*)kmask, (float*)out, L, S, H, temp, chunk);
  return (int)cudaGetLastError();
}

// Dispatch on the head width (16, 32 or 64).
template <bool kFlash>
int launch_d(const void* q, const void* k, const void* v, const void* qmask,
             const void* kmask, void* out, int B, int L, int S, int H, int D,
             float temp, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk % kBK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16, kFlash>(q, k, v, qmask, kmask, out, B, L, S, H, temp, chunk, st);
    case 32:
      return launch<32, kFlash>(q, k, v, qmask, kmask, out, B, L, S, H, temp, chunk, st);
    case 64:
      return launch<64, kFlash>(q, k, v, qmask, kmask, out, B, L, S, H, temp, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace softmax
}  // namespace oetr
