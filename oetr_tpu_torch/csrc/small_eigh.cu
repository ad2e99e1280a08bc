// Batched eigendecomposition of small symmetric matrices for the pose
// estimator (ops/small_eigh.py): its 9x9 normal matrices (the 8-point and DLT
// null vectors) and its 3x3 Gram matrices (the 3x3 SVDs).
//
// It replaces no pallas_call. JAX's estimator calls jnp.linalg.eigh
// (oetr_tpu/geometry/ransac.py:52, homography.py:52) and jnp.linalg.svd; on
// the card torch.linalg.eigh and svd read a status code back on every call,
// and the estimator calls them some twenty times. This kernel reads nothing
// back.
//
// What bounds it: latency, not bytes. The pose path's largest call, 4,096
// matrices of 9x9, moves 2.8 MB (under a microsecond at 3.35 TB/s) and does
// ~27 kflop a matrix, but Jacobi is a chain of dependent rotations: each
// round needs the one before it, and a round is shuffles between the lanes
// that hold one matrix, a rotation (a reciprocal and two reciprocal square
// roots in a row) and a few dependent updates. Tensor cores do not help
// (9x9 f32, and TF32 would break the 1e-5 bound against LAPACK). So the
// design shortens the chain and keeps it in registers:
//
// - n is a template parameter (1..16, a switch in the entry point). Every
//   loop over n unrolls, so A, V and the rotations live in registers (no
//   stack frame; ptxas -v shows it) and every register index is a constant.
// - For n >= 4 a group of m = n + (n & 1) lanes holds one matrix, 32 / m
//   groups a warp: lane j holds column j of A and row j of V. The pairs are
//   visited in a round-robin (Brent-Luk, circle-method) order: a sweep is
//   m - 1 rounds of m / 2 disjoint pairs (p, q), fixed at compile time, so
//   each lane knows its partner in a round before the data. A round: each
//   lane takes its diagonal entry and its entry in its partner's row (each
//   pair's term or 0, OR-ed: no chain of selects), and in one stage of
//   independent shuffles fetches the partner's two and the partner's whole
//   column; both lanes of a pair compute its rotation from the same three
//   numbers; lane p broadcasts (c, s); every lane applies all the round's
//   rotations to its own column and to its partner's (Jᵀ A) and to its row
//   of V (V J), with constant register indices, and forms its new column
//   from the two (A J); a_pq is set to 0 and the diagonal to a_pp - t a_pq,
//   a_qq + t a_pq, as in Rutishauser's scheme. A sweep is m - 1 such
//   rounds, where one thread a matrix took n (n - 1) / 2 serial rotations
//   of ~4n dependent local-memory updates each. (Every lane computing every
//   rotation of the round itself, with no broadcast, measured slower on the
//   card: m / 2 times the special-function work a round; PERF.md §6.)
// - For n <= 3 one thread holds a matrix in registers, 32 a warp, in the
//   same order: with m = 4 each round has one real pair, so a lane group
//   would add shuffles and gain nothing.
// - The rule of Numerical Recipes' `jacobi`: a pair whose a_pq is
//   negligible beside both diagonal entries (100 |a_pq| rounds away against
//   each) takes c = 1, s = 0 and a_pq = 0, without a branch. A warp stops
//   after a sweep in which no pair of any of its matrices rotated
//   (__any_sync), at most kMaxSweeps. A matrix whose sweeps have ended
//   meets identity rotations only, which leave it bit for bit as it was, so
//   its result does not depend on its warp-mates. Nothing inside a round
//   depends on the data but the values.
// - The warp loads its matrices coalesced into shared memory and each lane
//   takes its column (the lower triangle, mirrored); the eigenvalues are
//   ranked inside the group (ties by index) and w and V leave through
//   shared memory, coalesced. One warp a block: a call of a few hundred
//   warps spreads over every SM, one of a few warps gives each its own SM.
//
// The output is LAPACK's: eigenvalues ascending, eigenvectors as the columns
// of V (row-major [n, n]), each up to sign. A zero matrix gives w = 0 and
// V = I exactly; a matrix with a non-finite entry in its lower triangle
// gives NaN in w and V.
#include <cuda_runtime.h>
#include <math.h>

#include <utility>

namespace {

constexpr int kMaxN = 16;
constexpr int kMaxSweeps = 50;
constexpr unsigned kFull = 0xffffffffu;

// f(std::integral_constant<int, 0>{}), ..., f(...<Count - 1>{}): a loop
// whose index is a constant expression in the body.
template <class F, int... K>
__device__ __forceinline__ void unrolled(F&& f, std::integer_sequence<int, K...>) {
  (f(std::integral_constant<int, K>{}), ...);
}
template <int Count, class F>
__device__ __forceinline__ void unroll(F&& f) {
  unrolled(f, std::make_integer_sequence<int, Count>{});
}

// The circle method on m (even) indices: slot k of round r pairs m - 1 with
// r (k = 0), or (r + k) and (r - k) mod (m - 1). p < q.
__host__ __device__ constexpr int slot_a(int m, int r, int k) {
  return k == 0 ? m - 1 : (r + k) % (m - 1);
}
__host__ __device__ constexpr int slot_b(int m, int r, int k) {
  return k == 0 ? r : (r - k + m - 1) % (m - 1);
}
__host__ __device__ constexpr int pair_p(int m, int r, int k) {
  return slot_a(m, r, k) < slot_b(m, r, k) ? slot_a(m, r, k) : slot_b(m, r, k);
}
__host__ __device__ constexpr int pair_q(int m, int r, int k) {
  return slot_a(m, r, k) < slot_b(m, r, k) ? slot_b(m, r, k) : slot_a(m, r, k);
}

struct Rotation {
  float c, s, t;
  bool rotates;
};

// The rotation that zeroes a_pq of [[a_pp, a_pq], [a_pq, a_qq]]: t = tan φ,
// c = cos φ, s = sin φ. Where |h| = |a_qq - a_pp| dwarfs a_pq (Numerical
// Recipes' guard against overflow of θ²), t = a_pq / h and c = 1 to float
// precision. Otherwise, with θ = h / (2 a_pq) and d = |θ| + sqrt(θ² + 1),
// t = sgn θ / d, c = d e and s = sgn θ e for e = 1 / sqrt(d² + 1): two
// reciprocal square roots in a row (e refined by a Newton step, so that V
// stays orthogonal), the reciprocal of d beside them. Where a_pq is
// negligible, the identity. Every candidate is computed and one selected:
// no branch on the data.
__device__ __forceinline__ Rotation rotation(float app, float aqq, float apq) {
  const float g = 100.f * fabsf(apq);
  const bool negligible =
      fabsf(app) + g == fabsf(app) && fabsf(aqq) + g == fabsf(aqq);
  const float h = aqq - app;
  const bool small = fabsf(h) + g == fabsf(h);
  const float t_small = __fdividef(apq, h);
  const float theta = __fdividef(0.5f * h, apq);
  const float r2 = fmaf(theta, theta, 1.f);
  const float d = fabsf(theta) + r2 * rsqrtf(r2);
  const float x = fmaf(d, d, 1.f);
  float e = rsqrtf(x);
  e = fmaf(0.5f * e, fmaf(-x * e, e, 1.f), e);
  const float sgn = theta < 0.f ? -1.f : 1.f;
  const float t_big = __fdividef(sgn, d);
  if (negligible) return {1.f, 0.f, 0.f, false};
  if (small) return {1.f, t_small, t_small, true};
  return {d * e, sgn * e, t_big, true};
}

// Ascending order of floats as signed ints, -0 as +0. A NaN with its sign
// bit clear sorts above +inf, one with it set below -inf; a matrix with a
// non-finite entry writes NaN everywhere, so its order does not matter.
__device__ __forceinline__ int sort_key(float x) {
  const int b = __float_as_int(x + 0.f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

// One round of a lane group (lane j of the group starting at lane `base`):
// returns whether this lane's pair rotated.
template <int N, int R>
__device__ __forceinline__ bool lanes_round(float (&a)[N], float (&v)[N], int j,
                                            int base) {
  constexpr int M = N + (N & 1);
  constexpr int K = M / 2;
  // This lane's partner (itself where its pair holds the padding index),
  // its diagonal entry x and its entry y in its partner's row: each pair
  // gives its term or 0 independently, and the terms are OR-ed.
  int partner = j;
  unsigned xb = 0u, yb = 0u;
  unroll<K>([&](auto kc) {
    constexpr int p = pair_p(M, R, decltype(kc)::value);
    constexpr int q = pair_q(M, R, decltype(kc)::value);
    if constexpr (q < N) {
      const bool isp = j == p, isq = j == q;
      partner = isp ? q : isq ? p : partner;
      xb |= isp ? __float_as_uint(a[p]) : isq ? __float_as_uint(a[q]) : 0u;
      yb |= isp ? __float_as_uint(a[q]) : isq ? __float_as_uint(a[p]) : 0u;
    }
  });
  const float x = __uint_as_float(xb), y = __uint_as_float(yb);
  // One stage of independent shuffles: the partner's diagonal entry, its
  // copy of a_pq, and its whole column (known before the rotation).
  const int src = base + partner;
  const float xo = __shfl_sync(kFull, x, src);
  const float yo = __shfl_sync(kFull, y, src);
  float o[N];
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = __shfl_sync(kFull, a[i], src);
  // Both lanes of a pair compute from the same three numbers: a_pq is lane
  // q's copy (row p of column q).
  const bool side_p = j < partner;
  const float app = side_p ? x : xo, aqq = side_p ? xo : x;
  const float apq = side_p ? yo : y;
  Rotation rot = rotation(app, aqq, apq);
  if (partner == j) rot = {1.f, 0.f, 0.f, false};
  const float diag = side_p ? app - rot.t * apq : aqq + rot.t * apq;
  // Jᵀ on this lane's column and on its partner's, and J on its row of V,
  // with the round's rotations broadcast from their p lanes.
  unroll<K>([&](auto kc) {
    constexpr int p = pair_p(M, R, decltype(kc)::value);
    constexpr int q = pair_q(M, R, decltype(kc)::value);
    if constexpr (q < N) {
      const float c = __shfl_sync(kFull, rot.c, base + p);
      const float s = __shfl_sync(kFull, rot.s, base + p);
      const float ap = a[p], aq = a[q];
      a[p] = c * ap - s * aq;
      a[q] = s * ap + c * aq;
      const float op = o[p], oq = o[q];
      o[p] = c * op - s * oq;
      o[q] = s * op + c * oq;
      const float vp = v[p], vq = v[q];
      v[p] = c * vp - s * vq;
      v[q] = s * vp + c * vq;
    }
  });
  // (Jᵀ A) J: column p <- c col_p - s col_q, column q <- s col_p + c col_q.
  const float sx = side_p ? -rot.s : rot.s;
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = rot.c * a[i] + sx * o[i];
  // a_pq = 0 and the new diagonal entry, in each pair's two columns.
  unroll<K>([&](auto kc) {
    constexpr int p = pair_p(M, R, decltype(kc)::value);
    constexpr int q = pair_q(M, R, decltype(kc)::value);
    if constexpr (q < N) {
      const bool isp = j == p, isq = j == q;
      a[p] = isp ? diag : isq ? 0.f : a[p];
      a[q] = isq ? diag : isp ? 0.f : a[q];
    }
  });
  return rot.rotates;
}

// n >= 4: a group of M lanes a matrix, 32 / M matrices a warp, one warp a
// block. Where 32 % M != 0 (M = 6, 10, 12, 14) the lanes past G * M hold no
// matrix (never live, no vote): their shuffles read lanes past 31, which
// wrap modulo 32, harmlessly.
template <int N>
__global__ void __launch_bounds__(32)
    sym_eigh_kernel_lanes(const float* __restrict__ A, float* __restrict__ w,
                          float* __restrict__ V, long long batch) {
  constexpr int M = N + (N & 1);
  constexpr int G = 32 / M;
  constexpr int NN = N * N;
  __shared__ float stage[G * NN];
  __shared__ float stage_w[G * N];
  const int lane = threadIdx.x;
  const long long first = (long long)blockIdx.x * G;
  const int count = batch - first < G ? (int)(batch - first) : G;
  const int g = lane / M, j = lane % M, base = g * M;
  const bool live = g < count;  // a lane of one of this call's matrices
  for (int e = lane; e < count * NN; e += 32) stage[e] = A[first * NN + e];
  __syncwarp();
  float a[N], v[N];
  bool bad = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = 0.f;
    if (live && j < N) a[i] = stage[g * NN + (i >= j ? i * N + j : j * N + i)];
    v[i] = i == j ? 1.f : 0.f;
    bad |= !isfinite(a[i]);
  }
  const unsigned group = ((1u << M) - 1u) << base;
  const bool group_bad = (__ballot_sync(kFull, bad) & group) != 0u;
  const bool votes = live && !group_bad;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    unroll<M - 1>([&](auto rc) {
      rotated |= lanes_round<N, decltype(rc)::value>(a, v, j, base);
    });
    if (!__any_sync(kFull, rotated && votes)) break;
  }
  // Lane j's eigenvalue, its rank in the group, and each column's rank.
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) d = j == i ? a[i] : d;
  const int key = sort_key(d);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int other = __shfl_sync(kFull, key, base + i);
    rank += other < key || (other == key && i < j);
  }
  const bool writes = live && j < N;
  __syncwarp();  // every lane has read its column of the stage
  if (writes) stage_w[g * N + rank] = group_bad ? quiet_nan() : d;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int to = __shfl_sync(kFull, rank, base + k);
    if (writes) stage[g * NN + j * N + to] = group_bad ? quiet_nan() : v[k];
  }
  __syncwarp();
  for (int e = lane; e < count * NN; e += 32) V[first * NN + e] = stage[e];
  for (int e = lane; e < count * N; e += 32) w[first * N + e] = stage_w[e];
}

// n <= 3: one thread a matrix, 32 a warp (block).
template <int N>
__global__ void __launch_bounds__(32)
    sym_eigh_kernel_thread(const float* __restrict__ A, float* __restrict__ w,
                           float* __restrict__ V, long long batch) {
  constexpr int M = N + (N & 1);
  constexpr int K = M / 2;
  constexpr int NN = N * N;
  __shared__ float stage[32 * NN];
  __shared__ float stage_w[32 * N];
  const int lane = threadIdx.x;
  const long long first = (long long)blockIdx.x * 32;
  const int count = batch - first < 32 ? (int)(batch - first) : 32;
  const bool live = lane < count;
  for (int e = lane; e < count * NN; e += 32) stage[e] = A[first * NN + e];
  __syncwarp();
  float a[N][N], v[N][N];
  bool bad = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      a[i][k] = 0.f;
      if (live) a[i][k] = stage[lane * NN + (i >= k ? i * N + k : k * N + i)];
      v[i][k] = i == k ? 1.f : 0.f;
      bad |= !isfinite(a[i][k]);
    }
  }
  const bool votes = live && !bad;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    unroll<M - 1>([&](auto rc) {
      constexpr int R = decltype(rc)::value;
      Rotation rot[K];
      float diag_p[K], diag_q[K];
      unroll<K>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        if constexpr (q < N) {
          rot[k] = rotation(a[p][p], a[q][q], a[p][q]);
          diag_p[k] = a[p][p] - rot[k].t * a[p][q];
          diag_q[k] = a[q][q] + rot[k].t * a[p][q];
          rotated |= rot[k].rotates;
        }
      });
      // Jᵀ A, then (Jᵀ A) J and V J, then a_pq = 0 and the diagonal.
      unroll<K>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        if constexpr (q < N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float ap = a[p][i], aq = a[q][i];
            a[p][i] = rot[k].c * ap - rot[k].s * aq;
            a[q][i] = rot[k].s * ap + rot[k].c * aq;
          }
        }
      });
      unroll<K>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        if constexpr (q < N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float ap = a[i][p], aq = a[i][q];
            a[i][p] = rot[k].c * ap - rot[k].s * aq;
            a[i][q] = rot[k].s * ap + rot[k].c * aq;
            const float vp = v[i][p], vq = v[i][q];
            v[i][p] = rot[k].c * vp - rot[k].s * vq;
            v[i][q] = rot[k].s * vp + rot[k].c * vq;
          }
          a[p][q] = a[q][p] = 0.f;
          a[p][p] = diag_p[k];
          a[q][q] = diag_q[k];
        }
      });
    });
    if (!__any_sync(kFull, rotated && votes)) break;
  }
  float d[N];
  int key[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    d[k] = a[k][k];
    key[k] = sort_key(d[k]);
  }
  __syncwarp();  // every lane has read its matrix from the stage
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int rank = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      rank += key[i] < key[k] || (key[i] == key[k] && i < k);
    if (live) {
      stage_w[lane * N + rank] = bad ? quiet_nan() : d[k];
#pragma unroll
      for (int i = 0; i < N; ++i)
        stage[lane * NN + i * N + rank] = bad ? quiet_nan() : v[i][k];
    }
  }
  __syncwarp();
  for (int e = lane; e < count * NN; e += 32) V[first * NN + e] = stage[e];
  for (int e = lane; e < count * N; e += 32) w[first * N + e] = stage_w[e];
}

template <int N>
int launch(const float* A, float* w, float* V, long long batch,
           cudaStream_t stream) {
  constexpr int per_block = N <= 3 ? 32 : 32 / (N + (N & 1));
  const long long blocks = (batch + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if constexpr (N <= 3)
    sym_eigh_kernel_thread<N><<<(unsigned)blocks, 32, 0, stream>>>(A, w, V, batch);
  else
    sym_eigh_kernel_lanes<N><<<(unsigned)blocks, 32, 0, stream>>>(A, w, V, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// A [batch, n, n] f32 (the lower triangle is read), w [batch, n], V
// [batch, n, n]. 1 <= n <= 16.
extern "C" int oetr_sym_eigh_f32(const void* A, void* w, void* V,
                                 long long batch, int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const float* a = (const float*)A;
  float* wo = (float*)w;
  float* vo = (float*)V;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1: return launch<1>(a, wo, vo, batch, s);
    case 2: return launch<2>(a, wo, vo, batch, s);
    case 3: return launch<3>(a, wo, vo, batch, s);
    case 4: return launch<4>(a, wo, vo, batch, s);
    case 5: return launch<5>(a, wo, vo, batch, s);
    case 6: return launch<6>(a, wo, vo, batch, s);
    case 7: return launch<7>(a, wo, vo, batch, s);
    case 8: return launch<8>(a, wo, vo, batch, s);
    case 9: return launch<9>(a, wo, vo, batch, s);
    case 10: return launch<10>(a, wo, vo, batch, s);
    case 11: return launch<11>(a, wo, vo, batch, s);
    case 12: return launch<12>(a, wo, vo, batch, s);
    case 13: return launch<13>(a, wo, vo, batch, s);
    case 14: return launch<14>(a, wo, vo, batch, s);
    case 15: return launch<15>(a, wo, vo, batch, s);
    default: return launch<16>(a, wo, vo, batch, s);
  }
}
