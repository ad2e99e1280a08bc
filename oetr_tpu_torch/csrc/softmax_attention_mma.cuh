// bf16 masked softmax attention on the tensor cores (mma.sync m16n8k16),
// shared by K5 (full_attention.cu: whole-row softmax, normalised before
// rounding) and K6 (flash_attention.cu: streaming softmax with an online
// max). The f32 kernels stay on the FP32 pipes (softmax_attention.cuh):
// the tensor cores would round f32 inputs to TF32.
//
// Layout: q [B, L, H·D], k, v [B, S, H·D], out [B, L, H·D] bf16, read and
// written in place for head h; masks [B, L] / [B, S] as bytes, or null for
// all true. A pair (l, s) is visible when both masks are true; a row with
// no visible key gives 0.
//
// Block: one (tile of kBQ = 64 query rows, head, batch row), 4 warps; warp
// w owns query rows 16w..16w+15 and loads its Q fragment once (global ->
// shared -> A registers through ldmatrix). Keys and values stream through
// a ring of kStages tiles of kBK = 64 rows in shared memory, filled with
// cp.async kStages - 1 tiles ahead; rows are padded by 16 bytes, so the 8
// row addresses of each ldmatrix fall in distinct bank quads. Rows past S
// are zero-filled, and each tile carries a bias per key: 0 for a visible
// key, -inf off the key mask or past S. A row off the query mask is
// computed like any other and written as 0.
//
// Per tile, each warp computes its 16 x 64 logits S = Q·Kᵀ with D/16 x 8
// mma.sync in f32 (exact for bf16 inputs up to summation order, as the
// Pallas kernels' f32 dot) and adds the key bias. A row of the C fragments
// sits in the 4 lanes of a quad, so a row max or sum is two xor shuffles.
// p is packed from the C registers straight into the A fragments of P·V
// (two n8 tiles of S make one k16 step), and V's B fragments come from
// ldmatrix.trans.
//
// kFlash = false, K5: two passes over the ring. Pass 1 computes only S and
// keeps each row's max and sum, the sum rescaled as the max grows; pass 2
// recomputes S and forms attn = round(exp(logit - max) / max(sum, 1e-30))
// before attn·V, so the order stays: normalise, round, then the product.
// kFlash = true, K6: one pass; per tile new = max(m, tile max), safe = new
// if finite else 0, corr = exp(m - safe), p = exp(logit - safe) (0 off the
// masks), acc = acc·corr + round(p)·V, sum = sum·corr + Σp with the
// unrounded p; at the end out = round(acc / max(sum, 1e-30)).
//
// Arithmetic against the FP32-pipe kernels: the logits are kept in base 2
// (1/sqrt(D) · log2(e) folded into one scale) and every exp is ex2.approx
// on the special-function unit, where exp(-inf) = 0 needs no select; K5
// multiplies by 1 / max(sum, 1e-30) where they divide. Each moves a bf16
// rounding of p by at most one step; the kernels are held to their plain
// versions at the same tolerance as the FP32-pipe ones.
#pragma once

#include <math.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace oetr {
namespace softmax_mma {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;       // query rows per block
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;       // keys per tile (K6's block_k)
constexpr int kStages = 3;    // tiles in the ring
constexpr int kPad = 8;       // bf16 of padding per staged row (16 bytes)

// Shared-memory bytes: the key biases, the Q tile and the K and V rings.
template <int D>
constexpr size_t smem_bytes() {
  return kStages * kBK * sizeof(float) +
         (size_t)(kBQ + 2 * kStages * kBK) * (D + kPad) * sizeof(bf16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads) mma_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ qmask,
    const uint8_t* __restrict__ kmask, bf16* __restrict__ out, int L, int S,
    int H, float temp) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int RS = D + kPad;          // elements per staged row
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  constexpr int kDK = D / 16;           // k16 steps of Q·Kᵀ
  constexpr int kDN = D / 8;            // n8 tiles of the output
  constexpr int kSN = kBK / 8;          // n8 tiles of a logit tile
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long long HD = (long long)H * D;
  const float scale = temp * 1.4426950408889634f;  // 1/sqrt(D) · log2(e)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kbias = reinterpret_cast<float*>(smem_raw);         // [kStages][kBK]
  bf16* qs = reinterpret_cast<bf16*>(kbias + kStages * kBK); // [kBQ][RS]
  bf16* ks = qs + kBQ * RS;                                  // [kStages][kBK][RS]
  bf16* vs = ks + kStages * kBK * RS;                        // [kStages][kBK][RS]

  const int n_tiles = (S + kBK - 1) / kBK;
  const int n_steps = kFlash ? n_tiles : 2 * n_tiles;
  const bf16* kb = k + (long long)b * S * HD + (long long)h * D;
  const bf16* vb = v + (long long)b * S * HD + (long long)h * D;

  // Step i of the walk stages key tile i (mod n_tiles) and its key bias (0
  // for a visible key, -inf off the mask or past S); K5's pass 1 needs no
  // values.
  auto stage_tile = [&](int step) {
    const int tile = step < n_tiles ? step : step - n_tiles;
    const int st = step % kStages;
    const int s0 = tile * kBK;
    const bool with_v = kFlash || step >= n_tiles;
    for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
      const int row = idx / kChunks;
      const int col = (idx % kChunks) * 8;
      const bool in = s0 + row < S;
      const long long off = (long long)(in ? s0 + row : 0) * HD + col;
      const int dst = (st * kBK + row) * RS + col;
      mma::cp_async16(ks + dst, kb + off, in);
      if (with_v) mma::cp_async16(vs + dst, vb + off, in);
    }
    if (threadIdx.x < kBK) {
      const int s = s0 + threadIdx.x;
      const bool ok = s < S && (kmask == nullptr || kmask[(long long)b * S + s]);
      kbias[st * kBK + threadIdx.x] = ok ? 0.f : -INFINITY;
    }
  };

  // The Q tile rides in the first group, with key tile 0.
  {
    const bf16* qb = q + (long long)b * L * HD + (long long)h * D;
    for (int idx = threadIdx.x; idx < kBQ * kChunks; idx += kThreads) {
      const int row = idx / kChunks;
      const int col = (idx % kChunks) * 8;
      const bool in = q0 + row < L;
      mma::cp_async16(qs + row * RS + col,
                      qb + (long long)(in ? q0 + row : 0) * HD + col, in);
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) stage_tile(st);
    mma::cp_async_commit();
  }

  mma::cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qf[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk) {
    mma::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * RS +
                                 kk * 16 + 8 * (lane / 16));
  }

  // This thread's rows g and g + 8 of the warp's 16 (index i = 0, 1).
  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running row max (same in the quad)
  float lsum[2] = {0.f, 0.f};           // this lane's share of the row sum
  float safe[2] = {0.f, 0.f};           // the max subtracted, 0 if none
  float inv[2] = {1.f, 1.f};            // K5 pass 2: 1 / max(sum, 1e-30)

  for (int step = 0; step < n_steps; ++step) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `step` is in; the stage refilled below is free
    if (step + kStages - 1 < n_steps) stage_tile(step + kStages - 1);
    mma::cp_async_commit();

    const bool pass1 = !kFlash && step < n_tiles;
    if (!kFlash && step == n_tiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        inv[i] = __frcp_rn(fmaxf(quad_sum(lsum[i]), 1e-30f));
        safe[i] = m[i] != -INFINITY ? m[i] : 0.f;
      }
    }
    const int st = step % kStages;
    const bf16* kt = ks + st * kBK * RS;
    const bf16* vt = vs + st * kBK * RS;
    const float* bt = kbias + st * kBK;

    // Logits of the warp's 16 rows and the tile's 64 keys, in base 2:
    // (q·k) · 1/sqrt(D) · log2(e) + key bias.
    float sc[kSN][4];
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kSN / 2; ++jp) {
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, kt + (jp * 16 + (lane % 8) + 8 * (lane / 16)) * RS +
                                 kk * 16 + 8 * ((lane / 8) % 2));
        mma::mma_bf16(sc[2 * jp], qf[kk], kf[0], kf[1]);
        mma::mma_bf16(sc[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
      const float2 kbj = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
      sc[j][0] = fmaf(sc[j][0], scale, kbj.x);
      sc[j][1] = fmaf(sc[j][1], scale, kbj.y);
      sc[j][2] = fmaf(sc[j][2], scale, kbj.x);
      sc[j][3] = fmaf(sc[j][3], scale, kbj.y);
    }

    if (kFlash || pass1) {
      // The row max moves to cover this tile; K6 rescales its sum and
      // accumulator by corr, K5's pass 1 its sum.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSN; ++j) {
          tmax = fmaxf(tmax, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
        }
        const float new_m = fmaxf(m[i], quad_max(tmax));
        safe[i] = new_m != -INFINITY ? new_m : 0.f;
        const float corr = mma::exp2_approx(m[i] - safe[i]);
        m[i] = new_m;
        lsum[i] *= corr;
        if (kFlash) {
#pragma unroll
          for (int n = 0; n < kDN; ++n) {
            acc[n][2 * i] *= corr;
            acc[n][2 * i + 1] *= corr;
          }
        }
      }
    }
    // p = 2^(logit - safe), 0 off the masks; K5 normalises it in pass 2.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        const float e0 = mma::exp2_approx(sc[j][2 * i] - safe[i]);
        const float e1 = mma::exp2_approx(sc[j][2 * i + 1] - safe[i]);
        part += e0 + e1;
        sc[j][2 * i] = kFlash ? e0 : e0 * inv[i];
        sc[j][2 * i + 1] = kFlash ? e1 : e1 * inv[i];
      }
      if (kFlash || pass1) lsum[i] += part;
    }
    if (pass1) continue;

    // acc += round(p)·V, one k16 step per two n8 tiles of the logits.
#pragma unroll
    for (int c = 0; c < kSN / 2; ++c) {
      const uint32_t pa[4] = {mma::pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                              mma::pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                              mma::pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                              mma::pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        mma::ldmatrix_x4_trans(vf, vt + (c * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * RS +
                                       dp * 16 + 8 * (lane / 16));
        mma::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  mma::cp_async_wait<0>();  // no copy may outlive the block

  // Store rows in range; a row off the query mask gives 0.
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float total = kFlash ? fmaxf(quad_sum(lsum[i]), 1e-30f) : 1.f;
    const int r = r0 + 8 * i;
    if (r >= L) continue;
    const bool ok = qmask == nullptr || qmask[(long long)b * L + r];
    bf16* orow = out + ((long long)b * L + r) * HD + (long long)h * D;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      float a0 = acc[n][2 * i];
      float a1 = acc[n][2 * i + 1];
      if (kFlash) {
        a0 = __fdiv_rn(a0, total);
        a1 = __fdiv_rn(a1, total);
      }
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          ok ? mma::pack_bf16(a0, a1) : 0u;
    }
  }
}

// Launch one kernel on `stream`; returns the cudaError_t of the launch.
template <int D, bool kFlash>
int launch(const void* q, const void* k, const void* v, const void* qmask,
           const void* kmask, void* out, int B, int L, int S, int H,
           float temp, cudaStream_t stream) {
  auto kernel = mma_attention_kernel<D, kFlash>;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check reports it
      return (int)err;
    }
  }
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)qmask,
      (const uint8_t*)kmask, (bf16*)out, L, S, H, temp);
  return (int)cudaGetLastError();
}

// Dispatch on the head width (16, 32 or 64).
template <bool kFlash>
int launch_d(const void* q, const void* k, const void* v, const void* qmask,
             const void* kmask, void* out, int B, int L, int S, int H, int D,
             float temp, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16, kFlash>(q, k, v, qmask, kmask, out, B, L, S, H, temp, st);
    case 32:
      return launch<32, kFlash>(q, k, v, qmask, kmask, out, B, L, S, H, temp, st);
    case 64:
      return launch<64, kFlash>(q, k, v, qmask, kmask, out, B, L, S, H, temp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace softmax_mma
}  // namespace oetr
