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
// Why the TPU design does not carry over: the Pallas kernel holds a batch
// row's whole token blocks and all three [C, C] weights in VMEM, one grid
// step per batch row. Eight batch rows are 8 blocks here, on a card of 132
// SMs. So a call is two launches over row tiles, and the only thing that
// crosses from one tile to another, each head's KV and ΣK, goes through a
// small f32 workspace in L2:
//   source side, grid (tile of kRows source rows, head group, batch row):
//     the block LayerNorms its rows once, then for each head of its group
//     projects k and v, forms K and V, and writes the tile's partial
//     KV' = Kᵀ [V | 1] ([DP, DP + 8]: KV, then ΣK in column DP) to
//     ws[b, h, tile];
//   query side, grid (tile of kRows query rows, head group, batch row):
//     LayerNorms its rows once, sums each head's partials in tile order
//     (deterministic, no atomics), rounds KV' to T once, projects q, forms
//     Q and writes round(Q·KV / max(Q·ΣK, eps) · S) for its rows.
// The head groups are as many as still fit the grid in one wave of
// resident blocks (4 groups of 2 heads at the flagship's [8, 400, 256]:
// 224 blocks a side, two an SM).
//
// Inside a block (linear_encoder_tiles.cuh): the rows, their positional
// encodings and the LayerNorm weights land by cp.async; each row's two-pass
// LN statistics are taken by 8 lanes from shared memory and the LN'd,
// rounded rows overwrite the raw ones (the A tile). The head's weight rows
// stream through a 3-stage cp.async ring in chunks of 128 bytes of each
// row, every head of the group one after the other, so the ring does not
// drain between heads. bf16: 8 warps over 64 rows, the products on the
// tensor cores (mma.sync m16n8k16, f32 accumulators), weights rounded to
// bf16 once by the wrapper; f32: 4 warps over 32 rows on the FP32 pipes
// from float4 shared-memory reads, 4 x DP/16 outputs a thread. Where C is
// too wide for the whole A tile to fit in shared memory (C > 640 at D =
// 64), the tile holds a slab of its columns at a time, normalised from
// statistics taken from device memory, and is restaged for each head.
//
// Contract: any C that is a multiple of 32, any D = C/H up to 64 (DP, D
// rounded up to 16, is the template width; columns past D are zero), L and
// S from 1, pos with a batch of 1 or B, masks or null, f32 or bf16.
//
// Bound on the H100 at the flagship's [8, 400, 256], H = 8, bf16: 3.0 MB of
// inputs and 1.6 MB out (1.4 us at 3.35 TB/s); the projections are 1.26
// GFLOP (1.3 us on the tensor cores). The grid fills the card at the price
// of reuse: each of 224 blocks a side fetches its rows (once per head
// group) and 32-64 KB of weights from L2 and LayerNorms its rows. Each
// block is then one chain of short latency-bound phases (the row tile's
// arrival, the LayerNorm, the ring steps, the epilogues), none of them
// dominant, which keeps the kernel well above that bound.
#include <type_traits>

#include "linear_encoder_tiles.cuh"

namespace {

using namespace oetr;
using namespace oetr::encoder;

constexpr int kStages = 3;
constexpr int kMaxD = 64;

struct Params {
  const void* rows;        // x (query side) or src (source side), [B, N, C]
  const void* pos;         // [1 or B, N, C]
  long long pos_bstride;   // 0 or N·C
  const float* ln;         // [2, C]: LayerNorm weight, bias
  const void* w0;          // query side: Wq; source side: Wk   ([C, C] in T)
  const void* w1;          // source side: Wv
  const uint8_t* mask;     // [B, N] or null
  float* ws;               // [B, H, s_tiles, DP, DP + 8]
  void* out;               // query side: [B, L, C]
  int N, s_tiles, C, H, D;
  int hpb;                 // heads per block
  int slab;                // A-tile columns held at once (a multiple of kChunk)
  float eps, inv_s, s_len;
};

__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(kFullMask, v, 4);
  v += __shfl_xor_sync(kFullMask, v, 2);
  return v + __shfl_xor_sync(kFullMask, v, 1);
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 u = load4(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = mma::pack_bf16(v[0], v[1]);
  u.y = mma::pack_bf16(v[2], v[3]);
  u.z = mma::pack_bf16(v[4], v[5]);
  u.w = mma::pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Two-pass LayerNorm statistics of one row of C values, by the 8 lanes of
// a group (sub = lane % 8), four 16-byte reads in flight; every lane of the
// group gets them.
template <typename T>
__device__ void row_stats(const T* row, int C, int sub, float& mean,
                          float& rstd) {
  constexpr int V = kVec<T>;
  float s = 0.f;
  for (int cb = sub * V; cb < C; cb += 32 * V) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = cb + 8 * V * u;
      if (c < C) {
        float v[V];
        load_vec(row + c, v);
#pragma unroll
        for (int e = 0; e < V; ++e) s += v[e];
      }
    }
  }
  mean = sum8(s) / C;
  float ss = 0.f;
  for (int cb = sub * V; cb < C; cb += 32 * V) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = cb + 8 * V * u;
      if (c < C) {
        float v[V];
        load_vec(row + c, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v[e] - mean;
          ss += d * d;
        }
      }
    }
  }
  rstd = rsqrtf(sum8(ss) / C + 1e-5f);
}

// Bytes of the epilogue's tiles: K and V (source side); KV' and the two
// roles' partial q (bf16 query side); KV' and Q (f32 query side).
template <typename T, int DP, bool kKV>
__host__ __device__ constexpr int aux_bytes() {
  constexpr int br = Shape<T>::kRows;
  if (kKV) return 2 * br * kKvs<DP> * (int)sizeof(T);
  if (sizeof(T) == 2) return DP * kKvs<DP> * 2 + MmaTile<DP, 1>::kStash * 4;
  return (DP + br) * kKvs<DP> * 4;
}

// Shared memory: the A tile [kRows][slab + kVec] in T; the slab's
// positional encodings in the same layout, whose room the epilogue's tiles
// take once they are consumed; the weight ring [kStages][NW][DP][kChunk +
// kVec] in T; the slab's LayerNorm weight and bias [2][slab] f32; and mean,
// rstd and the row mask [3][kRows] f32.
template <typename T, int DP, bool kKV>
__host__ __device__ constexpr size_t pos_bytes(int slab) {
  const size_t tile = sizeof(T) * (size_t)Shape<T>::kRows * (slab + kVec<T>);
  return tile > (size_t)aux_bytes<T, DP, kKV>() ? tile : aux_bytes<T, DP, kKV>();
}

template <typename T, int DP, bool kKV>
size_t smem_bytes(int slab) {
  constexpr int br = Shape<T>::kRows, nw = kKV ? 2 : 1;
  return sizeof(T) * (size_t)br * (slab + kVec<T>) + pos_bytes<T, DP, kKV>(slab) +
         sizeof(T) * (size_t)kStages * nw * DP * (kChunk<T> + kVec<T>) +
         sizeof(float) * (2 * (size_t)slab + 3 * br);
}

// Blocks per SM that ptxas must leave room for: two of the bf16 kernels up
// to DP = 32 (the flagship's, at most 128 registers a thread); one
// elsewhere, so that the wider tiles keep their accumulators in registers.
template <typename T, int DP>
constexpr int kMinBlocks = std::is_same_v<T, bf16> && DP <= 32 ? 2 : 1;

template <typename T, int DP, bool kKV>
__global__ void __launch_bounds__(Shape<T>::kThreads, (kMinBlocks<T, DP>))
    linear_encoder_kernel(const Params p) {
  constexpr int BR = Shape<T>::kRows;
  constexpr int NT = Shape<T>::kThreads;
  constexpr int NWARP = Shape<T>::kWarps;
  constexpr int KC = kChunk<T>;
  constexpr int V = kVec<T>;
  constexpr int NW = kKV ? 2 : 1;
  constexpr int RSW = KC + V;
  using Tile = std::conditional_t<std::is_same_v<T, bf16>, MmaTile<DP, NW>,
                                  SimtTile<DP, NW>>;
  const int tile = blockIdx.x;
  const int h0 = blockIdx.y * p.hpb;
  const int b = blockIdx.z;
  const int n0 = tile * BR;
  const int N = p.N, C = p.C, D = p.D;
  const int rsa = p.slab + V;
  const int nk = (C + KC - 1) / KC;       // ring chunks per head
  const int ck = p.slab / KC;             // ring chunks per slab
  const bool one_slab = ck >= nk;
  const int steps = p.hpb * nk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);                        // [BR][rsa]
  unsigned char* aux = smem_raw + sizeof(T) * BR * rsa;
  T* P = reinterpret_cast<T*>(aux);                             // [BR][rsa]
  T* ring = reinterpret_cast<T*>(aux + pos_bytes<T, DP, kKV>(p.slab));
  float* gb = reinterpret_cast<float*>(ring + kStages * NW * DP * RSW);
  float* mu = gb + 2 * p.slab;
  float* rstd = mu + BR;
  float* rowm = rstd + BR;    // 1 for a row below N on the mask, else 0

  const T* rows_b = static_cast<const T*>(p.rows) + (long long)b * N * C;
  const T* pos_b = static_cast<const T*>(p.pos) + b * p.pos_bstride;

  // Ring step i: chunk i % nk of head h0 + i / nk, each weight's DP rows
  // (zeros past D and past C).
  auto fetch_weights = [&](int step) {
    const int h = h0 + step / nk;
    const int k0 = (step % nk) * KC;
    T* dst = ring + (step % kStages) * NW * DP * RSW;
    for (int idx = tid; idx < NW * DP * (KC / V); idx += NT) {
      const int m = NW == 1 ? 0 : idx / (DP * (KC / V));
      const int j = idx / (KC / V) % DP;
      const int cv = idx % (KC / V) * V;
      const bool in = j < D && k0 + cv < C;
      const long long off = in ? (long long)(h * D + j) * C + k0 + cv : 0;
      const T* w = static_cast<const T*>(m == 0 ? p.w0 : p.w1);
      mma::cp_async16(dst + (m * DP + j) * RSW + cv, w + off, in);
    }
  };
  // The rows' columns [sl·slab, (sl+1)·slab), their positional encodings
  // and the LayerNorm weight and bias there (zeros past N and past C).
  auto fetch_slab = [&](int sl) {
    const int c0 = sl * p.slab;
    const int per_row = p.slab / V;
    for (int idx = tid; idx < BR * per_row; idx += NT) {
      const int r = idx / per_row;
      const int cv = idx % per_row * V;
      const bool in = n0 + r < N && c0 + cv < C;
      const long long off = in ? (long long)(n0 + r) * C + c0 + cv : 0;
      mma::cp_async16(A + r * rsa + cv, rows_b + off, in);
      mma::cp_async16(P + r * rsa + cv, pos_b + off, in);
    }
    for (int idx = tid; idx < 2 * p.slab / 4; idx += NT) {
      const int half = idx / (p.slab / 4);
      const int c = idx % (p.slab / 4) * 4;
      const bool in = c0 + c < C;
      mma::cp_async16(gb + half * p.slab + c,
                      p.ln + (in ? half * C + c0 + c : 0), in);
    }
  };
  // A = round(LN(A)·w + b + P) over the slab's columns, 4 rows a warp at
  // a time, 8 lanes a row, two 16-byte reads in flight. With one slab, the
  // statistics come from the raw row in A.
  auto normalize = [&](int sl) {
    const int cols = C - sl * p.slab < p.slab ? C - sl * p.slab : p.slab;
    const int sub = lane % 8;
    for (int r = warp * 4 + lane / 8; r < BR; r += NWARP * 4) {
      T* a = A + r * rsa;
      const T* pr = P + r * rsa;
      float mean, rs;
      if (one_slab) {
        row_stats(a, C, sub, mean, rs);
      } else {
        mean = mu[r];
        rs = rstd[r];
      }
      for (int cb = sub * V; cb < cols; cb += 16 * V) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = cb + 8 * V * u;
          if (c < cols) {
            float x[V], ps[V];
            load_vec(a + c, x);
            load_vec(pr + c, ps);
#pragma unroll
            for (int e = 0; e < V; e += 4) {
              const float4 g = load4(gb + c + e);
              const float4 bb = load4(gb + p.slab + c + e);
              x[e] = (x[e] - mean) * rs * g.x + bb.x + ps[e];
              x[e + 1] = (x[e + 1] - mean) * rs * g.y + bb.y + ps[e + 1];
              x[e + 2] = (x[e + 2] - mean) * rs * g.z + bb.z + ps[e + 2];
              x[e + 3] = (x[e + 3] - mean) * rs * g.w + bb.w + ps[e + 3];
            }
            store_vec(a + c, x);
          }
        }
      }
    }
  };

  fetch_slab(0);
  mma::cp_async_commit();
  for (int r = tid; r < BR; r += NT) {
    const int n = n0 + r;
    rowm[r] = n < N && (p.mask == nullptr || p.mask[(long long)b * N + n])
                  ? 1.f : 0.f;
  }
  if (!one_slab) {
    // Statistics over all C columns, from device memory (the row of a
    // position past N is clamped and its result unused).
    for (int r = warp * 4 + lane / 8; r < BR; r += NWARP * 4) {
      const int n = n0 + r < N ? n0 + r : N - 1;
      float mean, rs;
      row_stats(rows_b + (long long)n * C, C, lane % 8, mean, rs);
      if (lane % 8 == 0) {
        mu[r] = mean;
        rstd[r] = rs;
      }
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) fetch_weights(st);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<kStages - 1>();   // the slab is in
  __syncthreads();
  normalize(0);

  Tile acc;
  acc.zero();
  for (int step = 0; step < steps; ++step) {
    const int chunk = step % nk;
    if (!one_slab && step > 0 && chunk % ck == 0) {
      __syncthreads();                 // every warp is done with the slab
      fetch_slab(chunk / ck);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      normalize(chunk / ck);
    }
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk `step` is in; the stage refilled below is free
    if (step + kStages - 1 < steps) fetch_weights(step + kStages - 1);
    mma::cp_async_commit();
    acc.chunk(A, rsa, chunk % ck * KC, ring + step % kStages * NW * DP * RSW,
              RSW);
    if (chunk != nk - 1) continue;

    // The head's epilogue.
    const int h = h0 + step / nk;
    float* ws_h = p.ws + (long long)(b * p.H + h) * p.s_tiles * DP * kKvs<DP>;
    if constexpr (kKV) {
      T* Ks = P;
      T* Vs = Ks + BR * kKvs<DP>;
      acc.store_kv(Ks, Vs, rowm, D, p.inv_s);
      for (int i = tid; i < BR * 8; i += NT) {
        store_t(Vs + i / 8 * kKvs<DP> + DP + i % 8, i % 8 == 0 ? 1.f : 0.f);
      }
      __syncthreads();
      kv_partial<DP>(Ks, Vs, ws_h + (long long)tile * DP * kKvs<DP>);
    } else {
      float* stash = reinterpret_cast<float*>(aux + DP * kKvs<DP> * 2);
      if constexpr (std::is_same_v<T, bf16>) acc.stash_q(stash);
      // KV' of head h: the source tiles' partials summed in tile order,
      // rounded. A thread owns kPer float4 entries and reads kU tiles of
      // all of them at a time, so that its loads are in flight together.
      constexpr int kF4 = DP * kKvs<DP> / 4;
      constexpr int kPer = (kF4 + NT - 1) / NT;
      constexpr int kU = kPer <= 2 ? 4 : kPer <= 4 ? 2 : 1;
      const float4* part = reinterpret_cast<const float4*>(ws_h);
      float4 s[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) s[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int st = 0; st < p.s_tiles; st += kU) {
        float4 v[kU][kPer];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int i = tid + k * NT;
            v[u][k] = st + u < p.s_tiles && i < kF4
                          ? part[(long long)(st + u) * kF4 + i]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            s[k].x += v[u][k].x, s[k].y += v[u][k].y;
            s[k].z += v[u][k].z, s[k].w += v[u][k].w;
          }
        }
      }
      T* KVs = reinterpret_cast<T*>(aux);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * NT;
        if (i < kF4) {
          store_t(KVs + 4 * i, s[k].x);
          store_t(KVs + 4 * i + 1, s[k].y);
          store_t(KVs + 4 * i + 2, s[k].z);
          store_t(KVs + 4 * i + 3, s[k].w);
        }
      }
      T* out_b = static_cast<T*>(p.out) + (long long)b * N * C;
      if constexpr (std::is_same_v<T, bf16>) {
        __syncthreads();
        acc.q_out(KVs, stash, rowm, D, p.eps, p.s_len, out_b, C, h * D, n0,
                  N);
      } else {
        T* Qs = KVs + DP * kKvs<DP>;
        acc.store_q(Qs, rowm, D);
        __syncthreads();
        acc.q_out(Qs, KVs, D, p.eps, p.s_len, out_b, C, h * D, n0, N);
      }
    }
    acc.zero();
  }
}

// The widest slab (a multiple of kChunk) whose kernel fits max_smem; 0 if
// none does.
template <typename T, int DP, bool kKV>
int pick_slab(int C, int max_smem) {
  int slab = (C + kChunk<T> - 1) / kChunk<T> * kChunk<T>;
  while (slab > 0 && smem_bytes<T, DP, kKV>(slab) > (size_t)max_smem) {
    slab -= kChunk<T>;
  }
  return slab;
}

// The most head groups (a divisor of H) whose grid still runs in one wave
// of `slots` resident blocks: each group more shortens every block's chain
// of heads, a second wave repeats the rows' load and LayerNorm. 1 where
// even one group takes more than a wave.
int head_groups(int H, int blocks, int slots) {
  int best = 1;
  for (int g = 2; g <= H; ++g) {
    if (H % g == 0 && blocks * g <= slots) best = g;
  }
  return best;
}

template <typename T, int DP, bool kKV>
int launch_side(Params p, int B, int tiles, int max_smem, int sms,
                cudaStream_t stream) {
  p.slab = pick_slab<T, DP, kKV>(p.C, max_smem);
  if (p.slab == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, DP, kKV>(p.slab);
  auto kernel = linear_encoder_kernel<T, DP, kKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, Shape<T>::kThreads, smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check reports it
    return (int)err;
  }
  const int groups =
      head_groups(p.H, B * tiles, sms * (per_sm > 0 ? per_sm : 1));
  p.hpb = p.H / groups;
  kernel<<<dim3(tiles, groups, B), Shape<T>::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Floats of the workspace: one [DP, DP + 8] partial per (batch row, head,
// tile of source rows).
template <typename T>
long long workspace_floats(int B, int S, int C, int H) {
  const int dp = (C / H + 15) / 16 * 16;
  const int tiles = (S + Shape<T>::kRows - 1) / Shape<T>::kRows;
  return (long long)B * H * tiles * dp * (dp + 8);
}

template <typename T, int DP>
int launch_dp(const void* x, const void* src, const void* xpos,
              long long xpos_bstride, const void* spos, long long spos_bstride,
              const float* lnq, const float* lnkv, const void* wq,
              const void* wk, const void* wv, const uint8_t* qmask,
              const uint8_t* kmask, void* out, float* ws, long long ws_floats,
              int B, int L, int S, int C, int H, float eps, float inv_s,
              cudaStream_t stream) {
  constexpr int BR = Shape<T>::kRows;
  const int s_tiles = (S + BR - 1) / BR;
  const int l_tiles = (L + BR - 1) / BR;
  if (ws_floats < workspace_floats<T>(B, S, C, H)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, max_smem = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Params p{};
  p.ws = ws;
  p.s_tiles = s_tiles;
  p.C = C;
  p.H = H;
  p.D = C / H;
  p.eps = eps;
  p.inv_s = inv_s;
  p.s_len = (float)S;

  Params kv = p;
  kv.rows = src;
  kv.pos = spos;
  kv.pos_bstride = spos_bstride;
  kv.ln = lnkv;
  kv.w0 = wk;
  kv.w1 = wv;
  kv.mask = kmask;
  kv.N = S;
  const int rc = launch_side<T, DP, true>(kv, B, s_tiles, max_smem, sms,
                                          stream);
  if (rc != 0) return rc;

  Params q = p;
  q.rows = x;
  q.pos = xpos;
  q.pos_bstride = xpos_bstride;
  q.ln = lnq;
  q.w0 = wq;
  q.mask = qmask;
  q.out = out;
  q.N = L;
  return launch_side<T, DP, false>(q, B, l_tiles, max_smem, sms, stream);
}

template <typename T>
int launch(const void* x, const void* src, const void* xpos,
           long long xpos_bstride, const void* spos, long long spos_bstride,
           const void* lnq, const void* lnkv, const void* wq, const void* wk,
           const void* wv, const void* qmask, const void* kmask, void* out,
           void* ws, long long ws_floats, int B, int L, int S, int C, int H,
           float eps, float inv_s, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0 || C % H != 0 || C % 32 != 0 ||
      C / H > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
#define OETR_K2_LAUNCH(DP)                                                    \
  return launch_dp<T, DP>(x, src, xpos, xpos_bstride, spos, spos_bstride,     \
                          (const float*)lnq, (const float*)lnkv, wq, wk, wv,  \
                          (const uint8_t*)qmask, (const uint8_t*)kmask, out,  \
                          (float*)ws, ws_floats, B, L, S, C, H, eps, inv_s,   \
                          (cudaStream_t)stream)
  const int D = C / H;
  if (D <= 16) OETR_K2_LAUNCH(16);
  if (D <= 32) OETR_K2_LAUNCH(32);
  if (D <= 48) OETR_K2_LAUNCH(48);
  OETR_K2_LAUNCH(64);
#undef OETR_K2_LAUNCH
}

}  // namespace

// ws: the f32 workspace, ws_floats long, at least what
// oetr_linear_encoder_workspace gives. The weights are in the I/O type
// (bf16 rounded once by the caller).
#define OETR_LINEAR_ENCODER_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void* x, const void* src, const void* xpos,        \
                      long long xpos_bstride, const void* spos,                \
                      long long spos_bstride, const void* lnq,                 \
                      const void* lnkv, const void* wq, const void* wk,        \
                      const void* wv, const void* qmask, const void* kmask,    \
                      void* out, void* ws, long long ws_floats, int B, int L,  \
                      int S, int C, int H, float eps, float inv_s,             \
                      void* stream) {                                          \
    return launch<T>(x, src, xpos, xpos_bstride, spos, spos_bstride, lnq,      \
                     lnkv, wq, wk, wv, qmask, kmask, out, ws, ws_floats, B, L, \
                     S, C, H, eps, inv_s, stream);                             \
  }

OETR_LINEAR_ENCODER_ENTRY(oetr_linear_encoder_f32, float)
OETR_LINEAR_ENCODER_ENTRY(oetr_linear_encoder_bf16, __nv_bfloat16)

// *floats = the workspace the entry points above need for these sizes.
extern "C" int oetr_linear_encoder_workspace(int bf16, int B, int S, int C,
                                             int H, long long* floats) {
  if (B <= 0 || S <= 0 || H <= 0 || C % H != 0) {
    return (int)cudaErrorInvalidValue;
  }
  *floats = bf16 ? workspace_floats<__nv_bfloat16>(B, S, C, H)
                 : workspace_floats<float>(B, S, C, H);
  return 0;
}
