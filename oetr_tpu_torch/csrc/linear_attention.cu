// K1: masked linear attention, by hand for Hopper, on thread-block clusters.
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
// Why the TPU design does not carry over: the Pallas kernel runs one grid
// step per batch row and walks the heads in VMEM. A block per (b, h) gives
// B·H blocks (64 at [8, 400, 8, 32]) on a card of 132 SMs, and each walks
// all S key rows before its first output. So one launch runs a cluster of
// NC blocks per (b, h), grid (NC, H, B); the host picks the largest NC of
// 1, 2, 4, 8 whose clusters all fit the card at once
// (cudaOccupancyMaxActiveClusters), since a second wave of clusters costs
// a whole block's time again:
//   * each block takes S/NC key rows and L/NC query rows, in tiles that
//     stream through a ring of kStages shared-memory slots by 16-byte
//     cp.async copies (element by element where a row is not a multiple of
//     16 bytes), the first key and query tiles in flight together;
//   * it forms K and V in place and sums its partial KV' = Kᵀ [V | 1]
//     ([DP, DP + 8] in f32: KV, then ΣK in column DP), and forms its first
//     query tile before the cluster's barrier;
//   * after a cluster barrier, each block sums its 1/NC share of the
//     entries over the NC partials in rank order (distributed shared
//     memory), rounds them to T once and writes them into every block's
//     KV'; a second barrier, and every block holds the same bits, so
//     repeated calls give the same bits (no atomics);
//   * then Q · KV' gives the numerators and, in column DP, the
//     denominator of each query row, staged and written back with 16-byte
//     stores.
// bf16: both products on the tensor cores (mma.sync m16n8k16, f32
// accumulators; K, V, Q and KV' are already rounded to bf16, so the
// operands are exact and only the order of the f32 sums changes; ΣK is the
// product with a constant column of ones). f32: on the FP32 pipes (tensor
// cores would round to TF32), each thread a float4 of output columns over
// several rows. elu's exp runs on the special-function unit (a few f32
// ulps from expf before the rounding to T).
//
// Contract: any D up to 64 (DP, D rounded up to 16, is the template width;
// columns past D are zero), L and S from 1, masks or null, f32 or bf16.
//
// Bound on the H100 at [8, 400, 8, 32] bf16: 6.6 MB moved (2.0 us at
// 3.35 TB/s) against 2·B·H·(S + L)·D² = 52 MFLOP, so bytes bind. What is
// left above it (clock64 stamps, PERF.md §6): the rows' arrival, forming
// them, two cluster barriers and the exchange of partials.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace oetr;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;       // tiles in flight
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr uint32_t kOnes = 0x3F803F80u;   // two bf16 1.0

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// Shared memory for head width DP: kStages slots of two [kRows, W] arrays
// (K and V of a key tile; Q and the staged output of a query tile), then
// this block's partial KV' P [DP, W] in f32, then the cluster's sum KV'
// [DP, W] rounded to T. A row is W = DP + 8 elements: an odd number of
// 16-byte units in bf16, so ldmatrix's eight rows fall in distinct banks.
// Rows a tile: 128 in bf16 (a warp's 16 query rows each), 64 in f32,
// halved above DP = 32, so that two blocks fit an SM.
template <typename T, int DP>
struct Smem {
  static constexpr int kRows = (sizeof(T) == 2 ? 128 : 64) / (DP > 32 ? 2 : 1);
  static constexpr int W = DP + 8;
  static constexpr int kTile = kRows * W;
  static constexpr size_t kSlotBytes = 2 * kTile * sizeof(T);
  static constexpr size_t kP = kStages * kSlotBytes;
  static constexpr size_t kKV = kP + DP * W * sizeof(float);
  static constexpr size_t kBytes = kKV + DP * W * sizeof(T);
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* qmask;   // [B, L] or null
  const uint8_t* kmask;   // [B, S] or null
  T* out;
  int L, S, H, D;
  float eps, inv_s;
};

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

__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]));
}

// Every thread of the cluster arrives (release), then waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// elu(x) + 1 with exp on the special-function unit (ex2.approx: a few f32
// ulps from expf, well inside a bf16 step; denormal results flushed to 0).
__device__ __forceinline__ float elu_p1_fast(float x) {
  return x > 0.f ? x + 1.f : __expf(x);
}

// Rows [0, kRows) of a tile from x, whose row 0 starts at element `base`,
// rows `stride` elements apart: the first `rows` real, the rest and the
// columns past D zero. vec: 16-byte cp.async copies (D a multiple of
// kVec<T> and x 16-byte aligned), else element by element.
template <typename T, int DP>
__device__ void load_tile(T* dst, const T* x, long long base,
                          long long stride, int rows, int D, bool vec) {
  constexpr int V = kVec<T>;
  constexpr int kChunks = DP / V;   // 16-byte chunks a row
  constexpr int W = Smem<T, DP>::W, kRows = Smem<T, DP>::kRows;
  for (int job = threadIdx.x; job < kRows * kChunks; job += kThreads) {
    const int r = job / kChunks, c = (job % kChunks) * V;
    T* d = dst + r * W + c;
    const T* s = x + base + r * stride + c;
    if (vec) {
      const bool full = r < rows && c < D;
      mma::cp_async16(d, full ? s : x, full);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        store_t(d + e, r < rows && c + e < D ? load_f(s + e) : 0.f);
      }
    }
  }
}

// In place, on the chunks this thread loaded (load_tile's jobs): a =
// round(elu(a)+1)·mask (K or Q) and, for a key tile, b = round(b·mask·inv_s)
// (V); zero on rows past `rows` and columns past D. mask: the tile's row
// 0 or null.
template <typename T, int DP>
__device__ void form_tile(T* a, T* b, const uint8_t* mask, int rows, int D,
                          float inv_s) {
  constexpr int V = kVec<T>;
  constexpr int kChunks = DP / V;
  constexpr int W = Smem<T, DP>::W, kRows = Smem<T, DP>::kRows;
  for (int job = threadIdx.x; job < kRows * kChunks; job += kThreads) {
    const int r = job / kChunks, c = (job % kChunks) * V;
    const bool live = r < rows && (mask == nullptr || mask[r]);
    float x[V];
    load_vec(a + r * W + c, x);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = live && c + e < D ? round_t<T>(elu_p1_fast(x[e])) : 0.f;
    }
    store_vec(a + r * W + c, x);
    if (b != nullptr) {
      load_vec(b + r * W + c, x);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        x[e] = live && c + e < D ? round_t<T>(x[e] * inv_s) : 0.f;
      }
      store_vec(b + r * W + c, x);
    }
  }
}

// Rows [0, rows) of a staged output tile to out (row 0 at element base).
template <typename T, int DP>
__device__ void store_tile(T* out, long long base, long long stride,
                           const T* src, int rows, int D, bool vec) {
  constexpr int V = kVec<T>;
  constexpr int kChunks = DP / V;
  constexpr int W = Smem<T, DP>::W, kRows = Smem<T, DP>::kRows;
  for (int job = threadIdx.x; job < kRows * kChunks; job += kThreads) {
    const int r = job / kChunks, c = (job % kChunks) * V;
    if (r >= rows || c >= D) continue;
    T* d = out + base + r * stride + c;
    const T* s = src + r * W + c;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < V && c + e < D; ++e) d[e] = s[e];
    }
  }
}

// ------------------------------------------------ bf16: tensor cores --

// The partial KV' = Kᵀ [V | 1]: M = DP rows (d), N = DP + 8 columns (e;
// the last n-tile is ΣK and zeros), K = the tile's rows (s). Warp w owns
// the output tiles w, w + 4, ...
template <int DP>
struct KeyTiles {
  static constexpr int MT = DP / 16, NT = DP / 8 + 1, kTiles = MT * NT;
  static constexpr int kPerWarp = (kTiles + kWarps - 1) / kWarps;
  float c[kPerWarp][4];
};

template <int DP>
__device__ void key_product(KeyTiles<DP>& acc, const bf16* K, const bf16* V,
                            int rows, int warp, int lane) {
  using KT = KeyTiles<DP>;
  constexpr int W = Smem<bf16, DP>::W;
  const int j = lane / 8, r = lane % 8;
  for (int ks = 0; ks < (rows + 15) / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < KT::kPerWarp; ++i) {
      const int t = warp + kWarps * i;
      if (t >= KT::kTiles) break;
      const int mt = t / KT::NT, nt = t % KT::NT;
      // A = Kᵀ (rows d, columns s): ldmatrix.trans of K stored [s][d].
      uint32_t a[4];
      mma::ldmatrix_x4_trans(
          a, K + (16 * ks + r + 8 * (j / 2)) * W + 16 * mt + 8 * (j % 2));
      uint32_t b[2];
      if (nt < KT::NT - 1) {
        mma::ldmatrix_x2_trans(b, V + (16 * ks + r + 8 * (j % 2)) * W + 8 * nt);
      } else {  // [1, 0, ..., 0]: column DP sums K over the rows
        b[0] = b[1] = lane < 4 ? kOnes : 0u;
      }
      mma::mma_bf16(acc.c[i], a, b[0], b[1]);
    }
  }
}

template <int DP>
__device__ void key_store(const KeyTiles<DP>& acc, float* P, int warp,
                          int lane) {
  using KT = KeyTiles<DP>;
  constexpr int W = Smem<bf16, DP>::W;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < KT::kPerWarp; ++i) {
    const int t = warp + kWarps * i;
    if (t >= KT::kTiles) break;
    float* p = P + (16 * (t / KT::NT) + g) * W + 8 * (t % KT::NT) + 2 * t4;
    p[0] = acc.c[i][0], p[1] = acc.c[i][1];
    p[8 * W] = acc.c[i][2], p[8 * W + 1] = acc.c[i][3];
  }
}

// Warp w's 16 query rows of the tile: Q · KV' on the tensor cores, then
// out = round(num · 1/max(den, eps) · S) into the staging tile O.
template <int DP>
__device__ void query_product(const bf16* Q, const bf16* KV, bf16* O,
                              int rows, int warp, int lane, float eps,
                              float s_len) {
  constexpr int W = Smem<bf16, DP>::W;
  constexpr int KS = DP / 16, NT = DP / 8 + 1;
  if (16 * warp >= rows) return;
  const int j = lane / 8, r = lane % 8, g = lane / 4, t4 = lane % 4;
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    mma::ldmatrix_x4(a[ks], Q + (16 * warp + r + 8 * (j % 2)) * W + 16 * ks +
                                8 * (j / 2));
  }
  float c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[2];
      mma::ldmatrix_x2_trans(b, KV + (16 * ks + r + 8 * (j % 2)) * W + 8 * nt);
      mma::mma_bf16(c[nt], a[ks], b[0], b[1]);
    }
  }
  // Column DP (lane t4 = 0 of the last tile) holds each row's Q·ΣK.
  const float z_lo = 1.f / fmaxf(__shfl_sync(kFullMask, c[NT - 1][0], lane & ~3), eps);
  const float z_hi = 1.f / fmaxf(__shfl_sync(kFullMask, c[NT - 1][2], lane & ~3), eps);
  bf16* o = O + (16 * warp + g) * W + 2 * t4;
#pragma unroll
  for (int nt = 0; nt < NT - 1; ++nt) {
    *reinterpret_cast<uint32_t*>(o + 8 * nt) =
        mma::pack_bf16(c[nt][0] * z_lo * s_len, c[nt][1] * z_lo * s_len);
    *reinterpret_cast<uint32_t*>(o + 8 * W + 8 * nt) =
        mma::pack_bf16(c[nt][2] * z_hi * s_len, c[nt][3] * z_hi * s_len);
  }
}

// --------------------------------------------------- f32: FP32 pipes --

// Thread t owns output columns 4·(t % E4) .. +3 over the rows (or d)
// t / E4 + NG·i.
template <int DP>
struct F32Map {
  static constexpr int E4 = DP / 4, NG = kThreads / E4;
  static constexpr int ND = (DP + NG - 1) / NG;       // d's a thread (KV)
  static constexpr int NR = (Smem<float, DP>::kRows + NG - 1) / NG;  // rows
};

template <int DP>
struct KeySums {
  float c[F32Map<DP>::ND][4];
  float ks;
};

template <int DP>
__device__ void key_product(KeySums<DP>& acc, const float* K, const float* V,
                            int rows, int, int) {
  using M = F32Map<DP>;
  constexpr int W = Smem<float, DP>::W;
  const int e4 = threadIdx.x % M::E4, dg = threadIdx.x / M::E4;
  const bool live = threadIdx.x < M::NG * M::E4;
  for (int s = 0; s < rows; ++s) {
    const float4 v = load4(V + s * W + 4 * e4);
#pragma unroll
    for (int i = 0; i < M::ND; ++i) {
      const int d = dg + M::NG * i;
      if (live && d < DP) {
        const float kd = K[s * W + d];
        acc.c[i][0] = fmaf(kd, v.x, acc.c[i][0]);
        acc.c[i][1] = fmaf(kd, v.y, acc.c[i][1]);
        acc.c[i][2] = fmaf(kd, v.z, acc.c[i][2]);
        acc.c[i][3] = fmaf(kd, v.w, acc.c[i][3]);
      }
    }
    if (threadIdx.x < DP) acc.ks += K[s * W + threadIdx.x];
  }
}

template <int DP>
__device__ void key_store(const KeySums<DP>& acc, float* P, int, int) {
  using M = F32Map<DP>;
  constexpr int W = Smem<float, DP>::W;
  const int e4 = threadIdx.x % M::E4, dg = threadIdx.x / M::E4;
  if (threadIdx.x < M::NG * M::E4) {
#pragma unroll
    for (int i = 0; i < M::ND; ++i) {
      const int d = dg + M::NG * i;
      if (d < DP) store_vec(P + d * W + 4 * e4, acc.c[i]);
    }
  }
  if (threadIdx.x < DP) {   // column DP: ΣK, then zeros
    P[threadIdx.x * W + DP] = acc.ks;
    for (int e = DP + 1; e < W; ++e) P[threadIdx.x * W + e] = 0.f;
  }
}

template <int DP>
__device__ void query_product(const float* Q, const float* KV, float* O,
                              int rows, int, int, float eps, float s_len) {
  using M = F32Map<DP>;
  constexpr int W = Smem<float, DP>::W;
  const int e4 = threadIdx.x % M::E4, lg = threadIdx.x / M::E4;
  if (threadIdx.x >= M::NG * M::E4) return;
  float c[M::NR][4], den[M::NR];
#pragma unroll
  for (int i = 0; i < M::NR; ++i) {
    c[i][0] = c[i][1] = c[i][2] = c[i][3] = den[i] = 0.f;
  }
  for (int d = 0; d < DP; ++d) {
    const float4 kv = load4(KV + d * W + 4 * e4);
    const float ks = KV[d * W + DP];
#pragma unroll
    for (int i = 0; i < M::NR; ++i) {
      const int l = lg + M::NG * i;
      if (l < rows) {
        const float qd = Q[l * W + d];
        c[i][0] = fmaf(qd, kv.x, c[i][0]);
        c[i][1] = fmaf(qd, kv.y, c[i][1]);
        c[i][2] = fmaf(qd, kv.z, c[i][2]);
        c[i][3] = fmaf(qd, kv.w, c[i][3]);
        den[i] = fmaf(qd, ks, den[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M::NR; ++i) {
    const int l = lg + M::NG * i;
    if (l < rows) {
      const float z = 1.f / fmaxf(den[i], eps);
      float o[4];
      for (int e = 0; e < 4; ++e) o[e] = c[i][e] * z * s_len;
      store_vec(O + l * W + 4 * e4, o);
    }
  }
}

template <typename T, int DP>
using KeyAcc = typename std::conditional<std::is_same<T, bf16>::value,
                                         KeyTiles<DP>, KeySums<DP>>::type;

template <typename Acc>
__device__ void zero(Acc& acc) {
  float* f = reinterpret_cast<float*>(&acc);
  for (int i = 0; i < (int)(sizeof(Acc) / sizeof(float)); ++i) f[i] = 0.f;
}

// ------------------------------------------------------------- kernel --

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    linear_attention_kernel(Args<T> a) {
  using SM = Smem<T, DP>;
  constexpr int W = SM::W, kRows = SM::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = gridDim.x, rank = blockIdx.x;   // the cluster spans x
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long HD = (long long)a.H * a.D;
  const bool vec = a.D % kVec<T> == 0;

  // This block's key rows [k0, k1) and query rows [q0, q1).
  const int ks_per = (a.S + nc - 1) / nc, ls_per = (a.L + nc - 1) / nc;
  const int k0 = min(a.S, rank * ks_per), k1 = min(a.S, k0 + ks_per);
  const int q0 = min(a.L, rank * ls_per), q1 = min(a.L, q0 + ls_per);
  const int nk = (k1 - k0 + kRows - 1) / kRows;
  const int nq = (q1 - q0 + kRows - 1) / kRows;

  auto tile_a = [&](int u) {
    return reinterpret_cast<T*>(smem + (u % kStages) * SM::kSlotBytes);
  };
  auto tile_b = [&](int u) { return tile_a(u) + SM::kTile; };
  // Tile u: the key tiles first, then the query tiles. Returns its count
  // of real rows and sets n0 to its first row.
  auto rows_of = [&](int u, int& n0) {
    if (u < nk) {
      n0 = k0 + u * kRows;
      return min(kRows, k1 - n0);
    }
    n0 = q0 + (u - nk) * kRows;
    return min(kRows, q1 - n0);
  };
  auto fetch = [&](int u) {
    if (u < nk + nq) {
      int n0;
      const int rows = rows_of(u, n0);
      if (u < nk) {
        const long long base = ((long long)b * a.S + n0) * HD + h * a.D;
        load_tile<T, DP>(tile_a(u), a.k, base, HD, rows, a.D, vec);
        load_tile<T, DP>(tile_b(u), a.v, base, HD, rows, a.D, vec);
      } else {
        const long long base = ((long long)b * a.L + n0) * HD + h * a.D;
        load_tile<T, DP>(tile_a(u), a.q, base, HD, rows, a.D, vec);
      }
    }
    mma::cp_async_commit();
  };
  auto form_query = [&](int u) {
    int n0;
    const int rows = rows_of(u, n0);
    form_tile<T, DP>(tile_a(u), nullptr,
                     a.qmask ? a.qmask + (long long)b * a.L + n0 : nullptr,
                     rows, a.D, a.inv_s);
  };

  // Key pass: this block's partial KV'.
  KeyAcc<T, DP> acc;
  zero(acc);
  fetch(0);
  fetch(1);
  for (int u = 0; u < nk; ++u) {
    fetch(u + 2);   // into the slot that tile u - 1 left
    mma::cp_async_wait<kStages - 1>();
    int n0;
    const int rows = rows_of(u, n0);
    form_tile<T, DP>(tile_a(u), tile_b(u),
                     a.kmask ? a.kmask + (long long)b * a.S + n0 : nullptr,
                     rows, a.D, a.inv_s);
    __syncthreads();
    key_product<DP>(acc, tile_a(u), tile_b(u), rows, warp, lane);
    __syncthreads();
  }
  float* P = reinterpret_cast<float*>(smem + SM::kP);
  T* KV = reinterpret_cast<T*>(smem + SM::kKV);
  key_store<DP>(acc, P, warp, lane);
  // The first query tile landed during the key pass: form it now.
  if (nq > 0) {
    mma::cp_async_wait<1>();
    form_query(nk);
  }

  // The cluster's KV' = Σ over ranks, in rank order: this block sums its
  // share of the entries, rounds them to T once and writes them into
  // every block's KV. Every block thus holds the same bits.
  cluster_sync();
  constexpr int kF4 = DP * W / 4;   // float4s of KV'
  const int share = (kF4 + nc - 1) / nc;
  const int i1 = min(kF4, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < i1; i += kThreads) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r0 = 0; r0 < nc; r0 += 4) {   // four remote reads in flight
      float4 p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < nc) p[j] = load4(cluster.map_shared_rank(P, r0 + j) + 4 * i);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < nc) {
          sum[0] += p[j].x, sum[1] += p[j].y, sum[2] += p[j].z,
              sum[3] += p[j].w;
        }
      }
    }
    for (int r = 0; r < nc; ++r) {
      store_vec(cluster.map_shared_rank(KV, r) + 4 * i, sum);
    }
  }
  cluster_sync();   // every KV complete; no block reads another after this

  // Query pass.
  const float s_len = (float)a.S;
  for (int u = nk; u < nk + nq; ++u) {
    fetch(u + 2);
    if (u > nk) {
      mma::cp_async_wait<kStages - 1>();
      form_query(u);
      __syncthreads();
    }
    int n0;
    const int rows = rows_of(u, n0);
    query_product<DP>(tile_a(u), KV, tile_b(u), rows, warp, lane, a.eps,
                      s_len);
    __syncthreads();
    store_tile<T, DP>(a.out, ((long long)b * a.L + n0) * HD + h * a.D, HD,
                      tile_b(u), rows, a.D, vec);
    __syncthreads();
  }
  mma::cp_async_wait<0>();
}

// The launch configuration of a grid of nc x H x B blocks in clusters of
// nc along x. attr must outlive the configuration.
template <typename T, int DP>
cudaLaunchConfig_t cluster_config(int nc, int H, int B, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem<T, DP>::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int DP>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(linear_attention_kernel<T, DP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Smem<T, DP>::kBytes);
}

template <typename T, int DP>
int launch_dp(const Args<T>& a, int B, int nc, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<T, DP>(nc, a.H, B, stream, &attr);
  cudaError_t err = allow_smem<T, DP>();
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, linear_attention_kernel<T, DP>, a);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Clusters of nc blocks that the card holds at once.
template <typename T, int DP>
int capacity_dp(int nc, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<T, DP>(nc, 1, 1, 0, &attr);
  cudaError_t err = allow_smem<T, DP>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(clusters,
                                         linear_attention_kernel<T, DP>, &cfg);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qmask,
           const void* kmask, void* out, int B, int L, int S, int H, int D,
           float eps, float inv_s, int nc, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 64 || nc < 1 ||
      nc > kMaxCluster || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Args<T> a{(const T*)q, (const T*)k, (const T*)v,
                  (const uint8_t*)qmask, (const uint8_t*)kmask, (T*)out,
                  L, S, H, D, eps, inv_s};
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 16) return launch_dp<T, 16>(a, B, nc, st);
  if (D <= 32) return launch_dp<T, 32>(a, B, nc, st);
  if (D <= 48) return launch_dp<T, 48>(a, B, nc, st);
  return launch_dp<T, 64>(a, B, nc, st);
}

template <typename T>
int capacity(int D, int nc, int* clusters) {
  if (D <= 0 || D > 64 || nc < 1 || nc > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  if (D <= 16) return capacity_dp<T, 16>(nc, clusters);
  if (D <= 32) return capacity_dp<T, 32>(nc, clusters);
  if (D <= 48) return capacity_dp<T, 48>(nc, clusters);
  return capacity_dp<T, 64>(nc, clusters);
}

}  // namespace

// q [B, L, H, D], k, v [B, S, H, D], out like q: contiguous, 16-byte
// aligned; masks [B, L] / [B, S] bool or null; nc: blocks a cluster (1-8).
#define OETR_LINEAR_ATTENTION_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v,             \
                      const void* qmask, const void* kmask, void* out, int B,  \
                      int L, int S, int H, int D, float eps, float inv_s,      \
                      int nc, void* stream) {                                  \
    return launch<T>(q, k, v, qmask, kmask, out, B, L, S, H, D, eps, inv_s,    \
                     nc, stream);                                              \
  }

OETR_LINEAR_ATTENTION_ENTRY(oetr_linear_attention_f32, float)
OETR_LINEAR_ATTENTION_ENTRY(oetr_linear_attention_bf16, __nv_bfloat16)

// Clusters of nc blocks (1-8) of the kernel for head width D that the
// current device holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int oetr_linear_attention_capacity(int bf16, int D, int nc,
                                              int* clusters) {
  return bf16 ? capacity<__nv_bfloat16>(D, nc, clusters)
              : capacity<float>(D, nc, clusters);
}
