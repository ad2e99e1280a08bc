// The two passes of masked linear attention of K1 (linear_attention.cu).
//
// A block owns one (batch row, head) and kWarps warps. Lane j of a warp owns
// the head's columns j and j + 32 (NC = 1 column per lane when D <= 32, 2
// when D <= 64); lanes past D compute on a clamped column and discard it.
//   Pass 1: each warp makes one source row's K and V (kWarps rows a step,
//     staged in kt/vt), then the block adds the step's KᵀV and ΣK into f32
//     registers, thread by thread over the D·D entries.
//   Pass 2: each warp takes query rows on its own and writes
//     round((Q·KV) / max(Q·ΣK, eps) · S), with KV and ΣK rounded to T.
#pragma once

#include "common.cuh"

namespace oetr {
namespace linear {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 64;
constexpr int kKvPerThread = kMaxD * kMaxD / kThreads;

// Shared-memory floats the passes use: kt, vt [kWarps][kMaxD], KV
// [kMaxD][kMaxD], ΣK [kMaxD].
constexpr int kPassFloats = 2 * kWarps * kMaxD + kMaxD * kMaxD + kMaxD;

struct Pass {
  float* kt;
  float* vt;
  float* kv_s;
  float* ks_s;
  float acc_kv[kKvPerThread];
  float acc_ks;

  __device__ explicit Pass(float* base)
      : kt(base), vt(base + kWarps * kMaxD),
        kv_s(base + 2 * kWarps * kMaxD),
        ks_s(base + 2 * kWarps * kMaxD + kMaxD * kMaxD), acc_ks(0.f) {
    for (int e = 0; e < kKvPerThread; ++e) acc_kv[e] = 0.f;
  }

  // Pass 1, after every warp has written its row's K and V (zeros for a
  // row past S) to kt/vt and the block has synchronised: add the step.
  __device__ void accumulate(int D) {
    for (int e = 0; e < kKvPerThread; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      if (idx < D * D) {
        const int d = idx / D;
        const int c = idx % D;
        float a = acc_kv[e];
        for (int r = 0; r < kWarps; ++r) {
          a = fmaf(kt[r * kMaxD + d], vt[r * kMaxD + c], a);
        }
        acc_kv[e] = a;
      }
    }
    if (threadIdx.x < D) {
      for (int r = 0; r < kWarps; ++r) acc_ks += kt[r * kMaxD + threadIdx.x];
    }
  }

  // End of pass 1: KV and ΣK to shared memory, rounded to T.
  template <typename T>
  __device__ void finish(int D) {
    for (int e = 0; e < kKvPerThread; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      if (idx < D * D) kv_s[(idx / D) * kMaxD + idx % D] = round_t<T>(acc_kv[e]);
    }
    if (threadIdx.x < D) ks_s[threadIdx.x] = round_t<T>(acc_ks);
  }

  // Pass 2 for one query row: q[c] is Q at column lane + 32c (0 past D).
  // Returns the unrounded output at the same columns in o.
  template <int NC>
  __device__ void output_row(const float (&q)[NC], int D, int lane, float eps,
                             float s_len, float (&o)[NC]) const {
    float part = 0.f;
    int jj[NC];
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c;
      jj[c] = j < D ? j : 0;
      part += q[c] * ks_s[jj[c]];
      o[c] = 0.f;
    }
    const float den = warp_sum(part);
    const int d0 = D < 32 ? D : 32;
    for (int d = 0; d < d0; ++d) {
      const float qd = __shfl_sync(kFullMask, q[0], d);
      for (int c = 0; c < NC; ++c) o[c] = fmaf(qd, kv_s[d * kMaxD + jj[c]], o[c]);
    }
    if (NC > 1) {
      for (int d = 32; d < D; ++d) {
        const float qd = __shfl_sync(kFullMask, q[NC - 1], d - 32);
        for (int c = 0; c < NC; ++c) o[c] = fmaf(qd, kv_s[d * kMaxD + jj[c]], o[c]);
      }
    }
    const float z = 1.f / fmaxf(den, eps);
    for (int c = 0; c < NC; ++c) o[c] = o[c] * z * s_len;
  }
};

}  // namespace linear
}  // namespace oetr
