// The products of K2 (linear_encoder.cu), one tile policy per I/O type.
//
// A block owns kRows token rows (the A tile, LayerNormed and rounded to T in
// shared memory). Each policy keeps the projections of its rows in
// registers, adds one ring chunk of kChunk input columns of the weights at
// a time (NW weight matrices: 2 on the source side, k and v; 1 on the
// query side, q), and runs the epilogues:
//   source side: K, V into shared memory, then the tile's partial
//     KV' = Kᵀ [V | 1] ([DP, DP + 8] f32: KV in columns < DP, ΣK in column
//     DP, zeros after), written to the workspace;
//   query side: Q, then out = Q·KV' / max(Q·ΣK, eps) · S, rounded, stored.
// DP is the head width D rounded up to 16; columns at or past D are zero.
//
// bf16, MmaTile: mma.sync m16n8k16 with f32 accumulators, as the Pallas
// kernel's jnp.dot(..., preferred_element_type=f32) on bf16 operands; 8
// warps over a 64-row tile. Warp w owns rows 16(w % 4)..+15; its role w / 4
// picks its share of the work: on the source side the weight (k or v), on
// the query side half of each chunk's k16 steps (at the head's end both
// roles leave their partial q in shared memory, and role 0 adds them). Weights are B
// operands through ldmatrix (W's [out, in] rows are x·Wᵀ's columns); Kᵀ
// and [V | 1] come from shared memory through ldmatrix.trans; Q goes from
// its C fragments straight into A fragments.
// f32, SimtTile: the FP32 pipes (the tensor cores would round f32 to TF32);
// 4 warps over a 32-row tile. Thread (rg, cg) = (tid / 16, tid % 16) owns
// rows rg + 8i (i < 4) and columns cg + 16j (j < DP / 16), reading A and W
// as float4 along the input columns.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace oetr {
namespace encoder {

using bf16 = __nv_bfloat16;

template <typename T>
struct Shape;
template <>
struct Shape<bf16> {
  static constexpr int kRows = 64;    // 4 row groups x 16 rows of mma tiles
  static constexpr int kWarps = 8;    // x 2 roles
  static constexpr int kThreads = kWarps * 32;
};
template <>
struct Shape<float> {
  static constexpr int kRows = 32;    // 8 row groups x 4 rows
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;
};

// Elements of T in 16 bytes (one cp.async, one vector load), and input
// columns per ring chunk: 128 bytes of each weight row.
template <typename T>
constexpr int kVec = 16 / sizeof(T);
template <typename T>
constexpr int kChunk = 128 / sizeof(T);

// The row stride of the K, V, KV' and Q tiles: DP columns and 8 more (the
// ones column of [V | 1] and its zeros; for bf16 also the 16-byte pad that
// spreads ldmatrix's rows over the banks).
template <int DP>
constexpr int kKvs = DP + 8;

// Q and K from a projection: round(elu(round(x)) + 1)·m, 0 past D.
template <typename T>
__device__ __forceinline__ float feature(float x, float m, bool in) {
  return in ? round_t<T>(elu_p1(round_t<T>(x))) * m : 0.f;
}

// ----------------------------------------------------------------- bf16 --

template <int DP, int NW>
struct MmaTile {
  static constexpr int kN = DP / 8;     // n8 tiles of a projection
  static constexpr int kK = DP / 16;    // k16 steps over a head's columns
  // Floats of the two roles' partial q: [2][4 warps][32 lanes][kN][4].
  static constexpr int kStash = 2 * 4 * 32 * kN * 4;
  float acc[kN][4];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  // acc += A[the warp's 16 rows][col0 + its k16 steps] · W_m[0, DP)[same]ᵀ;
  // W holds the NW chunks one after the other, DP rows each.
  __device__ void chunk(const bf16* A, int rsa, int col0, const bf16* W,
                        int rsw) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = warp % 4 * 16;
    const int role = warp / 4;
    constexpr int kSteps = NW == 2 ? kChunk<bf16> / 16 : kChunk<bf16> / 32;
    const bf16* w = W + (NW == 2 ? role * DP * rsw : 0);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int kk = NW == 2 ? s : role * kSteps + s;
      uint32_t a[4];
      mma::ldmatrix_x4(a, A + (row0 + lane % 8 + 8 * ((lane / 8) % 2)) * rsa +
                              col0 + kk * 16 + 8 * (lane / 16));
#pragma unroll
      for (int jp = 0; jp < DP / 16; ++jp) {
        uint32_t b[4];
        mma::ldmatrix_x4(b, w + (jp * 16 + lane % 8 + 8 * (lane / 16)) * rsw +
                                kk * 16 + 8 * ((lane / 8) % 2));
        mma::mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma::mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }

  // Source side: role 0 writes K = feature(k)·m, role 1 V = round(round(v)
  // ·m·inv_s), for the warp's rows (row stride kKvs<DP>).
  __device__ void store_kv(bf16* Ks, bf16* Vs, const float* rowm, int D,
                           float inv_s) const {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bool is_k = warp / 4 == 0;
    bf16* dst = is_k ? Ks : Vs;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp % 4 * 16 + g + 8 * i;
      const float m = rowm[r];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int c = 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = c + e < D;
          const float x = acc[j][2 * i + e];
          v[e] = is_k ? feature<bf16>(x, m, in)
                      : in ? round_t<bf16>(round_t<bf16>(x) * m * inv_s) : 0.f;
        }
        *reinterpret_cast<uint32_t*>(dst + r * kKvs<DP> + c) = mma::pack_bf16(v[0], v[1]);
      }
    }
  }

  // Query side, before a barrier: each warp leaves its partial q in stash
  // (its registers are then free for the sum of the KV' partials).
  __device__ void stash_q(float* stash) const {
    float* s = stash + (threadIdx.x / 32 * 32 + threadIdx.x % 32) * kN * 4;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      *reinterpret_cast<float4*>(s + 4 * j) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }

  // Query side, after it: role 0 adds the two partials, forms Q (packed
  // into A fragments) and out = Q·KV' with KV' ([DP][DP + 8], rounded) in
  // shared memory, den in its column DP. Stores the warp's rows below L to
  // out_b (row stride C) at columns hD + c, c < D.
  __device__ void q_out(const bf16* KVs, const float* stash, const float* rowm,
                        int D, float eps, float s_len, bf16* out_b, int C,
                        int hD, int l0, int L) {
    const int warp = threadIdx.x / 32;
    if (warp / 4 != 0) return;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const float* s0 = stash + (warp * 32 + lane) * kN * 4;
    const float* s1 = s0 + 4 * 32 * kN * 4;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float4 a = load4(s0 + 4 * j), b = load4(s1 + 4 * j);
      acc[j][0] = a.x + b.x, acc[j][1] = a.y + b.y;
      acc[j][2] = a.z + b.z, acc[j][3] = a.w + b.w;
    }
    uint32_t qa[kK][4];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m = rowm[warp * 16 + g + 8 * i];
          qa[kk][2 * half + i] = mma::pack_bf16(
              feature<bf16>(acc[j][2 * i], m, c < D),
              feature<bf16>(acc[j][2 * i + 1], m, c + 1 < D));
        }
      }
    }
    float o[kN + 1][4];
#pragma unroll
    for (int n = 0; n <= kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int n = 0; n <= kN; ++n) {
        uint32_t b[2];
        mma::ldmatrix_x2_trans(b, KVs + (kk * 16 + lane % 16) * kKvs<DP> + n * 8);
        mma::mma_bf16(o[n], qa[kk], b[0], b[1]);
      }
    }
    // den of rows g and g + 8 sits in lane 4g's first column of tile kN.
    const float den[2] = {__shfl_sync(kFullMask, o[kN][0], lane & ~3),
                          __shfl_sync(kFullMask, o[kN][2], lane & ~3)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int l = l0 + warp * 16 + g + 8 * i;
      if (l >= L) continue;
      const float z = 1.f / fmaxf(den[i], eps);
      bf16* row = out_b + (long long)l * C + hD;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < D) store_t(row + c, o[j][2 * i] * z * s_len);
        if (c + 1 < D) store_t(row + c + 1, o[j][2 * i + 1] * z * s_len);
      }
    }
  }
};

// Source side, bf16: the 64-row tile's KV' = Kᵀ [V | 1] on the tensor
// cores into ws ([DP][DP + 8] f32). Warps take the (m16, n8) output tiles
// in turn; Kᵀ's A fragments and [V | 1]'s B fragments come through
// ldmatrix.trans from the row-major K and V tiles, all four k16 steps'
// before the first product.
template <int DP>
__device__ void kv_partial(const bf16* Ks, const bf16* Vs, float* ws) {
  constexpr int kM = DP / 16, kNN = DP / 8 + 1;
  constexpr int kSteps = Shape<bf16>::kRows / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  for (int item = warp; item < kM * kNN; item += Shape<bf16>::kWarps) {
    const int mt = item / kNN, nt = item % kNN;
    uint32_t a[kSteps][4], b[kSteps][2];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      mma::ldmatrix_x4_trans(a[kk], Ks + (kk * 16 + lane % 8 + 8 * (lane / 16)) * kKvs<DP> +
                                        mt * 16 + 8 * ((lane / 8) % 2));
      mma::ldmatrix_x2_trans(b[kk], Vs + (kk * 16 + lane % 16) * kKvs<DP> + nt * 8);
    }
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) mma::mma_bf16(c, a[kk], b[kk][0], b[kk][1]);
    float* o = ws + (mt * 16 + g) * kKvs<DP> + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(c[0], c[1]);
    *reinterpret_cast<float2*>(o + 8 * kKvs<DP>) = make_float2(c[2], c[3]);
  }
}

// ------------------------------------------------------------------ f32 --

template <int DP, int NW>
struct SimtTile {
  static constexpr int kI = 4;          // rows per thread
  static constexpr int kJ = DP / 16;    // columns per thread
  float acc[NW][kI][kJ];

  __device__ void zero() {
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[m][i][j] = 0.f;
  }

  __device__ void chunk(const float* A, int rsa, int col0, const float* W,
                        int rsw) {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int k = 0; k < kChunk<float>; k += 4) {
      float4 a[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) a[i] = load4(A + (rg + 8 * i) * rsa + col0 + k);
#pragma unroll
      for (int m = 0; m < NW; ++m) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const float4 w = load4(W + (m * DP + cg + 16 * j) * rsw + k);
#pragma unroll
          for (int i = 0; i < kI; ++i) {
            float s = acc[m][i][j];
            s = fmaf(a[i].x, w.x, s);
            s = fmaf(a[i].y, w.y, s);
            s = fmaf(a[i].z, w.z, s);
            acc[m][i][j] = fmaf(a[i].w, w.w, s);
          }
        }
      }
    }
  }

  __device__ void store_kv(float* Ks, float* Vs, const float* rowm, int D,
                           float inv_s) const {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int r = rg + 8 * i;
      const float m = rowm[r];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = cg + 16 * j;
        const bool in = c < D;
        Ks[r * kKvs<DP> + c] = feature<float>(acc[0][i][j], m, in);
        Vs[r * kKvs<DP> + c] = in ? acc[1][i][j] * m * inv_s : 0.f;
      }
    }
  }

  // Query side, part 1: Q into Qs (row stride kKvs<DP>).
  __device__ void store_q(float* Qs, const float* rowm, int D) const {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int r = rg + 8 * i;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = cg + 16 * j;
        Qs[r * kKvs<DP> + c] = feature<float>(acc[0][i][j], rowm[r], c < D);
      }
    }
  }

  // Query side, part 2, after a barrier: out = Q·KV' / max(Q·ΣK, eps) · S
  // for this thread's rows and columns.
  __device__ void q_out(const float* Qs, const float* KVs, int D, float eps,
                        float s_len, float* out_b, int C, int hD, int l0,
                        int L) const {
    const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int r = rg + 8 * i;
      const float* q = Qs + r * kKvs<DP>;
      float den = 0.f, o[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) o[j] = 0.f;
      for (int d = 0; d < DP; ++d) {
        const float* kv = KVs + d * kKvs<DP>;
        den = fmaf(q[d], kv[DP], den);
#pragma unroll
        for (int j = 0; j < kJ; ++j) o[j] = fmaf(q[d], kv[cg + 16 * j], o[j]);
      }
      if (l0 + r >= L) continue;
      const float z = 1.f / fmaxf(den, eps);
      float* row = out_b + (long long)(l0 + r) * C + hD;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = cg + 16 * j;
        if (c < D) row[c] = o[j] * z * s_len;
      }
    }
  }
};

// Source side, f32: KV' = Kᵀ [V | 1] over the 32-row tile, one output
// entry per thread in turn.
template <int DP>
__device__ void kv_partial(const float* Ks, const float* Vs, float* ws) {
  for (int idx = threadIdx.x; idx < DP * kKvs<DP>; idx += Shape<float>::kThreads) {
    const int d = idx / kKvs<DP>, e = idx % kKvs<DP>;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < Shape<float>::kRows; ++r) {
      s = fmaf(Ks[r * kKvs<DP> + d], Vs[r * kKvs<DP> + e], s);
    }
    ws[idx] = s;
  }
}

}  // namespace encoder
}  // namespace oetr
