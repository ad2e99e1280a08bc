// K4: log-domain Sinkhorn iterations, by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_sinkhorn.py::log_sinkhorn_pallas (kernel
// _sinkhorn_kernel). For each pair b, with u = v = 0 to start, `iters` times:
//   u[i] = mu[i] - LSE_j (C[i, j] + v[j])      (row pass)
//   v[j] = nu[j] - LSE_i (C[i, j] + u[i])      (column pass)
// then out[i, j] = (C[i, j] + u[i]) + v[j]. Everything is f32. Masked
// entries carry the finite -1e9 sentinel of ops/sinkhorn.py, so no row or
// column is ever empty and no special case is needed: a row whose entries
// are all the sentinel gets the same finite u as torch.logsumexp gives it.
//
// The Pallas kernel holds one pair's matrix in VMEM through all iterations.
// At SuperGlue's k = 2048 a pair is 2049^2 x 4 B = 16.8 MB: no SM holds it,
// but the card's 132 SMs x 227 KB of shared memory do. So the pairs of a
// launch are spread over one persistent cooperative grid, one block per SM:
// each pair gets `blocks_per_pair` = SMs / pairs blocks, and each block
// keeps a contiguous slab of `rows` rows of its pair in shared memory,
// loaded once from HBM (16 rows, 131 KB at k = 2048). One iteration:
//   1. row pass, local: u for the block's rows from the shared v;
//   2. each column's partial log-sum-exp over the block's rows, to a
//      workspace [blocks, N] in L2;
//   3. each block merges, in block order, the partials of its share of the
//      pair's columns and writes v (16 columns a block at k = 2048);
//   4. every block reads its pair's whole v into shared memory.
// After the last iteration the block writes out = (C + u) + v from shared
// memory. So HBM sees one read and one write of the matrix, and a call
// makes one launch per group of pairs (8 at k = 2048).
//
// Steps 3 and 4 wait on the data itself, not on grid barriers: every
// partial and every v is one 8-byte word that carries the iteration it
// belongs to (v: the iteration number beside the value; a partial: the
// iteration's parity in the sign of its sum), written and polled with
// volatile 8-byte accesses, so a reader takes a word as soon as it has
// landed and needs no fence. A block cannot run a step ahead of a reader:
// its next partials need every block's v, which each block writes only after
// reading all the partials of its columns, and its next v needs every
// block's next partials. So no word is overwritten before it is read. One
// grid barrier a launch orders the words' initial marks before the first
// read. (Two grid barriers an iteration took 2.5 us of its 11.5 in a
// stamped build on the H100; waiting on the words saves them and one L2
// round trip.)
//
// A pair too large for the grid's shared memory keeps the first `resident`
// rows of each slab in shared memory and reads the others from global
// memory on every pass. The host plan (ops/sinkhorn.py::sinkhorn_plan)
// picks pairs, rows and resident rows; the launch refuses a plan that does
// not fit or cannot be co-resident.
//
// No atomics in any sum: the partials are merged in block order and the
// slices of a block in a fixed shuffle tree, so the result does not depend
// on which block ran first. The log-sum-exps run in base 2: a running max
// mL = max·log2(e) and sum s of 2^(t·log2(e) - mL), one FFMA and one
// ex2.approx a value. The row pass is a warp per row, each lane with two
// runs of values in flight; the column pass is a thread per two columns.
// A run's exponentials take mL as it stands, seeded by the row's or the
// column's mL of the last iteration, so they need not wait for the run's
// own max (see lse_run).
//
// Bound on the H100 at B = 8, M = N = 2049, iters = 30: exponentials
// 2·B·iters·M·N = 2.0e9 (0.48 ms at 16 a clock per SM x 132 SMs x 1.98
// GHz); bytes 2·B·M·N·4 = 269 MB (0.080 ms at 3.35 TB/s). The exponentials
// bind.
// Rounding: ex2.approx and the online rescaling round differently from
// torch.logsumexp; outputs agree with the plain version to ~1e-5.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowRun = 8;                 // columns a lane takes per run
constexpr int kColRun = 8;                 // rows a thread takes per run
constexpr int kMergeCols = 16;             // columns merged side by side
constexpr int kMergeSlices = kThreads / kMergeCols;
constexpr int kMergeLoads = 8;             // partials a thread loads at once
constexpr int kVLoads = 8;                 // v words a thread loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory a block needs beyond its resident rows: v [N], u [rows],
// the seeds of the block's columns [N] and rows [rows], 16 bytes to align
// the slab with its global rows, and the merge's scratch (static). ops/sinkhorn.py::sinkhorn_smem_bytes is the same sum.
constexpr int kStaticSmem = 2 * kMergeSlices * (kMergeCols + 1) * 4;

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

long long dynamic_smem(int N, int rows, int resident) {
  return 2 * (align16(4LL * N) + align16(4LL * rows)) + 16 +
         4LL * resident * N;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tagged words. A partial: (mL, s) with s's sign the iteration's parity
// (s >= 1 once a row is in it). A v: (value, iteration).
typedef unsigned long long word_t;

__device__ __forceinline__ word_t pack(float lo, float hi) {
  return (word_t)__float_as_uint(hi) << 32 | __float_as_uint(lo);
}
__device__ __forceinline__ float lo_of(word_t w) {
  return __uint_as_float((unsigned)w);
}
__device__ __forceinline__ float hi_of(word_t w) {
  return __uint_as_float((unsigned)(w >> 32));
}
__device__ __forceinline__ word_t load_word(const word_t* p) {
  return *reinterpret_cast<const volatile word_t*>(p);
}
__device__ __forceinline__ void store_word(word_t* p, word_t w) {
  *reinterpret_cast<volatile word_t*>(p) = w;
}

template <int kR>
__device__ __forceinline__ float tree_max(const float (&t)[kR]) {
  float a[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) a[k] = t[k];
#pragma unroll
  for (int w = kR / 2; w > 0; w /= 2) {
#pragma unroll
    for (int k = 0; k < w; ++k) a[k] = fmaxf(a[k], a[k + w]);
  }
  return a[0];
}

// Folds kR values t[] (kR a power of 2; -FLT_MAX for none) into the base-2
// log-sum-exp (mL, s), mL a value already seen. The exponentials take the
// running max as it stands, beside the run's own max, so they need not
// wait for it: terms up to 2^kSlack are kept, and only a run whose max is
// further above (rare once a row's or a column's first value is in) takes
// them again from its own max. The test is on the FFMA that the terms use,
// so no term passes 2^kSlack whatever the rounding of mL.
constexpr float kSlack = 64.f;
// A sum below this was taken against a seed far above every value. A
// seed that is one of the values gives a sum of at least 2^-64 (the FFMA's
// offset from mL's rounding, at values near the -1e9 sentinel); one up to
// 80 above keeps every term within 2^-46 of the largest.
constexpr float kTiny = 0x1p-80f;

template <int kR>
__device__ __forceinline__ void lse_run(float& mL, float& s,
                                        const float (&t)[kR]) {
  float e[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) e[k] = ex2(fmaf(t[k], kLog2e, -mL));
  const float rm = tree_max(t);
  if (fmaf(rm, kLog2e, -mL) > kSlack) {
    const float rmL = rm * kLog2e;
    s *= ex2(mL - rmL);
    mL = rmL;
#pragma unroll
    for (int k = 0; k < kR; ++k) e[k] = ex2(fmaf(t[k], kLog2e, -mL));
  }
#pragma unroll
  for (int w = kR / 2; w > 0; w /= 2) {
#pragma unroll
    for (int k = 0; k < w; ++k) e[k] += e[k + w];
  }
  s += e[0];
}

// One value into (mL, s).
__device__ __forceinline__ void lse_push(float& mL, float& s, float t) {
  const float tL = t * kLog2e;
  if (tL > mL) {
    s *= ex2(mL - tL);
    mL = tL;
  }
  s += ex2(fmaf(t, kLog2e, -mL));
}

// Two base-2 log-sum-exps as one.
__device__ __forceinline__ void lse_merge(float& mL, float& s, float mL2,
                                          float s2) {
  const float mm = fmaxf(mL, mL2);
  s = s * ex2(mL - mm) + s2 * ex2(mL2 - mm);
  mL = mm;
}

// (mL, s) of c[j] + v[j] over j = lane, lane + 32, ... < N: one warp. Two
// runs of kRowRun values a lane at a time, each
// with its own (mL, s) seeded by mL as given or, where that is -FLT_MAX, by
// the lane's first value; the last values past whole runs go one by one.
// A lane with no column leaves (mL, s) as they were.
__device__ __forceinline__ void row_lse(const float* c, const float* v, int N,
                                        int lane, float& mL, float& s) {
  constexpr int kSpan = 32 * kRowRun;
  if (lane >= N) return;
  if (mL == -FLT_MAX) mL = (c[lane] + v[lane]) * kLog2e;
  float mL2 = mL, s2 = 0.f;
  int j = lane;
  for (; j + kSpan + 32 * (kRowRun - 1) < N; j += 2 * kSpan) {
    float t[kRowRun], t2[kRowRun];
#pragma unroll
    for (int k = 0; k < kRowRun; ++k) {
      t[k] = c[j + 32 * k] + v[j + 32 * k];
      t2[k] = c[j + kSpan + 32 * k] + v[j + kSpan + 32 * k];
    }
    lse_run(mL, s, t);
    lse_run(mL2, s2, t2);
  }
  for (; j + 32 * (kRowRun - 1) < N; j += kSpan) {
    float t[kRowRun];
#pragma unroll
    for (int k = 0; k < kRowRun; ++k) t[k] = c[j + 32 * k] + v[j + 32 * k];
    lse_run(mL, s, t);
  }
  for (; j < N; j += 32) lse_push(mL, s, c[j] + v[j]);
  lse_merge(mL, s, mL2, s2);
}

// The row's (max, sum) over the warp from row_lse, each lane seeded by
// `seed` (or its own first value where that is -FLT_MAX).
__device__ __forceinline__ void row_reduce(const float* c, const float* v,
                                           int N, int lane, float seed,
                                           float& mx, float& s) {
  float mL = seed;
  s = 0.f;
  row_lse(c, v, N, lane, mL, s);
  mx = mL;
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  s *= ex2(mL - mx);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
}

// (mL, s) of columns j and j2 over rows [r0, r1): c[r * N] + u[r], in runs
// of kColRun rows (the last run's rows past r1 count as -FLT_MAX), seeded
// by mL as given or, where that is -FLT_MAX, by the first row.
__device__ __forceinline__ void col_lse2(const float* c, int j, int j2,
                                         const float* u, int N, int r0,
                                         int r1, float& mL, float& s,
                                         float& mL2, float& s2) {
  if (r0 >= r1) return;
  const float* p = c + r0 * N;
  if (mL == -FLT_MAX) mL = (p[j] + u[r0]) * kLog2e;
  if (mL2 == -FLT_MAX) mL2 = (p[j2] + u[r0]) * kLog2e;
  int r = r0;
  for (; r + kColRun <= r1; r += kColRun, p += kColRun * N) {
    float t[kColRun], t2[kColRun];
#pragma unroll
    for (int k = 0; k < kColRun; ++k) {
      t[k] = p[k * N + j] + u[r + k];
      t2[k] = p[k * N + j2] + u[r + k];
    }
    lse_run(mL, s, t);
    lse_run(mL2, s2, t2);
  }
  if (r < r1) {
    float t[kColRun], t2[kColRun];
#pragma unroll
    for (int k = 0; k < kColRun; ++k) {
      const bool in = r + k < r1;
      t[k] = in ? p[k * N + j] + u[r + k] : -FLT_MAX;
      t2[k] = in ? p[k * N + j2] + u[r + k] : -FLT_MAX;
    }
    lse_run(mL, s, t);
    lse_run(mL2, s2, t2);
  }
}

// Copies count floats from global src to shared dst, where dst mirrors
// src's address modulo 16 bytes, so that the body moves 16 bytes a load.
__device__ void load_slab(float* dst, const float* __restrict__ src,
                          int count) {
  const int head =
      min(count, (int)(((16 - ((uintptr_t)src & 15)) & 15) / 4));
  for (int k = threadIdx.x; k < head; k += kThreads) dst[k] = src[k];
  const int body = (count - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
#pragma unroll 4
  for (int k = threadIdx.x; k < body; k += kThreads) d4[k] = s4[k];
  for (int k = head + 4 * body + threadIdx.x; k < count; k += kThreads) {
    dst[k] = src[k];
  }
}

// One launch: `npairs` pairs from `cost` on, blocks_per_pair blocks each.
// ws [gridDim.x, N] and vg [npairs, N] are tagged words in L2.
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_kernel(
    const float* __restrict__ cost, const float* __restrict__ mu,
    const float* __restrict__ nu, float* __restrict__ out, word_t* ws,
    word_t* vg, int npairs, int M, int N, int iters, int blocks_per_pair,
    int rows, int resident) {
  extern __shared__ float4 smem4[];
  __shared__ float red_m[kMergeSlices][kMergeCols + 1];
  __shared__ float red_s[kMergeSlices][kMergeCols + 1];
  float* v_s = reinterpret_cast<float*>(smem4);
  float* u_s = v_s + align16(4LL * N) / 4;
  float* seed_c = u_s + align16(4LL * rows) / 4;  // each column's last mL
  float* seed_r = seed_c + align16(4LL * N) / 4;   // each row's last mL
  float* slab_base = seed_r + align16(4LL * rows) / 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = blockIdx.x / blocks_per_pair;
  const int lb = blockIdx.x % blocks_per_pair;
  const bool active = pair < npairs;
  const int r0 = lb * rows;
  const int nrows = active ? max(0, min(rows, M - r0)) : 0;
  const int nres = min(resident, nrows);
  const int row_blocks = (M + rows - 1) / rows;   // blocks of a pair with rows
  const int cols = (N + blocks_per_pair - 1) / blocks_per_pair;
  const int j_lo = min(N, lb * cols), j_hi = min(N, j_lo + cols);
  const long long pair_off = (long long)pair * M * N;
  const float* crow = cost + pair_off + (long long)r0 * N;  // the slab's rows
  float* slab = slab_base + (((uintptr_t)crow >> 2) & 3);
  const int first_block = pair * blocks_per_pair;
  word_t* my_ws = ws + (long long)blockIdx.x * N;
  word_t* my_vg = vg + (long long)pair * N;

  // Marks that no reader takes: partials of parity 1 (iteration -1), v of
  // iteration -1.
  if (nrows > 0) {
    for (int j = tid; j < N; j += kThreads) my_ws[j] = pack(-FLT_MAX, -1.f);
  }
  if (active) {
    for (int j = j_lo + tid; j < j_hi; j += kThreads) {
      my_vg[j] = pack(0.f, __int_as_float(-1));
    }
  }
  if (nres > 0) load_slab(slab, crow, nres * N);
  for (int j = tid; j < N; j += kThreads) v_s[j] = 0.f;
  for (int r = tid; r < nrows; r += kThreads) u_s[r] = 0.f;
  cg::this_grid().sync();

  for (int it = 0; it < iters; ++it) {
    const float sign = it & 1 ? -1.f : 1.f;
    // 1. Row pass: one warp per row, seeded by the row's mL of the last
    // iteration; the warp's max, then its sum rescaled to it. Where the
    // seed stood so far above every value that the sum came out below
    // kTiny, the row is taken again from the lanes' own values.
    for (int r = warp; r < nrows; r += kWarps) {
      const float* c = r < nres ? slab + r * N : crow + r * N;
      float seed = it > 0 ? seed_r[r] : -FLT_MAX, mx, s;
      row_reduce(c, v_s, N, lane, seed, mx, s);
      if (s < kTiny) row_reduce(c, v_s, N, lane, -FLT_MAX, mx, s);
      if (lane == 0) {
        u_s[r] = mu[(long long)pair * M + r0 + r] - (mx + log2f(s)) * kLn2;
        seed_r[r] = mx;
      }
    }
    __syncthreads();
    // 2. The block's partial of every column, two columns a thread at a
    // time, as words of this iteration's parity.
    if (nrows > 0) {
      for (int j = tid; j < N; j += 2 * kThreads) {
        // A second column; past N the thread takes its own column twice,
        // so that it reads no seed that another thread writes.
        const int j2 = j + kThreads < N ? j + kThreads : j;
        // Seeded by the columns' mL of the last iteration; a column whose
        // sum came out below kTiny is taken again from its own values.
        float mL = it > 0 ? seed_c[j] : -FLT_MAX, s = 0.f;
        float mL2 = it > 0 ? seed_c[j2] : -FLT_MAX, s2 = 0.f;
        col_lse2(slab, j, j2, u_s, N, 0, nres, mL, s, mL2, s2);
        col_lse2(crow, j, j2, u_s, N, nres, nrows, mL, s, mL2, s2);
        if (s < kTiny || s2 < kTiny) {
          mL = mL2 = -FLT_MAX;
          s = s2 = 0.f;
          col_lse2(slab, j, j2, u_s, N, 0, nres, mL, s, mL2, s2);
          col_lse2(crow, j, j2, u_s, N, nres, nrows, mL, s, mL2, s2);
        }
        seed_c[j] = mL;
        store_word(my_ws + j, pack(mL, sign * s));
        if (j + kThreads < N) {
          seed_c[j2] = mL2;
          store_word(my_ws + j2, pack(mL2, sign * s2));
        }
      }
    }
    // 3. v of the block's share of columns: kMergeCols columns side by
    // side, the partials of kMergeSlices slices of the pair's blocks each,
    // every word waited for until it has this iteration's parity; loaded
    // together, then their max, then the sum rescaled to it. Then a warp a
    // column merges the slices in a fixed shuffle tree.
    if (active) {
      const int c = tid % kMergeCols, slice = tid / kMergeCols;
      for (int j0 = j_lo; j0 < j_hi; j0 += kMergeCols) {
        const int j = j0 + c;
        float mL = -FLT_MAX, s = 0.f;
        for (int q0 = slice; q0 < row_blocks;
             q0 += kMergeSlices * kMergeLoads) {
          word_t w[kMergeLoads];
#pragma unroll
          for (int k = 0; k < kMergeLoads; ++k) {   // all in flight at once
            const int q = q0 + k * kMergeSlices;
            w[k] = j < j_hi && q < row_blocks
                       ? load_word(ws + (long long)(first_block + q) * N + j)
                       : pack(-FLT_MAX, sign * 0.f);
          }
#pragma unroll
          for (int k = 0; k < kMergeLoads; ++k) {
            const int q = q0 + k * kMergeSlices;
            while (hi_of(w[k]) * sign < 0.f) {
              __nanosleep(32);
              w[k] = load_word(ws + (long long)(first_block + q) * N + j);
            }
          }
          float mm = mL;
#pragma unroll
          for (int k = 0; k < kMergeLoads; ++k) mm = fmaxf(mm, lo_of(w[k]));
          float acc = s * ex2(mL - mm);
#pragma unroll
          for (int k = 0; k < kMergeLoads; ++k) {
            acc = fmaf(fabsf(hi_of(w[k])), ex2(lo_of(w[k]) - mm), acc);
          }
          mL = mm;
          s = acc;
        }
        red_m[slice][c] = mL;
        red_s[slice][c] = s;
        __syncthreads();
        if (warp < kMergeCols && j0 + warp < j_hi) {
          float m1 = red_m[lane][warp], s1 = red_s[lane][warp];
          for (int k = lane + 32; k < kMergeSlices; k += 32) {
            lse_merge(m1, s1, red_m[k][warp], red_s[k][warp]);
          }
          float mx = m1;
          for (int o = 16; o > 0; o >>= 1) {
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
          }
          float ss = s1 * ex2(m1 - mx);
          for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
          if (lane == 0) {
            const int jj = j0 + warp;
            const float v = nu[(long long)pair * N + jj] -
                            (mx + log2f(ss)) * kLn2;
            store_word(my_vg + jj, pack(v, __int_as_float(it)));
          }
        }
        __syncthreads();
      }
    }
    // 4. The pair's whole v, each word waited for until it is this
    // iteration's, for the next row pass and the epilogue.
    if (nrows > 0) {
      for (int j0 = tid; j0 < N; j0 += kThreads * kVLoads) {
        word_t w[kVLoads];
#pragma unroll
        for (int k = 0; k < kVLoads; ++k) {   // all in flight at once
          const int j = j0 + k * kThreads;
          w[k] = j < N ? load_word(my_vg + j) : pack(0.f, __int_as_float(it));
        }
#pragma unroll
        for (int k = 0; k < kVLoads; ++k) {
          const int j = j0 + k * kThreads;
          while (__float_as_int(hi_of(w[k])) != it) {
            __nanosleep(32);
            w[k] = load_word(my_vg + j);
          }
          if (j < N) v_s[j] = lo_of(w[k]);
        }
      }
    }
    __syncthreads();
  }

  // out = (C + u) + v, the plain version's order of addition.
  float* orow = out + pair_off + (long long)r0 * N;
  for (int r = 0; r < nrows; ++r) {
    const float* c = r < nres ? slab + r * N : crow + r * N;
    const float ur = u_s[r];
    for (int j = tid; j < N; j += kThreads) {
      __stcs(orow + r * N + j, (c[j] + ur) + v_s[j]);
    }
  }
}

int launch(const float* cost, const float* mu, const float* nu, float* out,
           void* work, int B, int M, int N, int iters, int pairs, int rows,
           int resident, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || iters < 0 || pairs <= 0 || pairs > B ||
      rows <= 0 || resident < 0 || resident > rows ||
      (long long)rows * N >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks_per_pair = sms / pairs;
  const long long smem = dynamic_smem(N, rows, resident);
  if (blocks_per_pair < 1 || (long long)blocks_per_pair * rows < M ||
      smem + kStaticSmem > optin) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(sinkhorn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_kernel,
                                                      kThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // work: the partials [sms, N], then v [pairs, N], 8-byte words.
  word_t* ws = reinterpret_cast<word_t*>(work);
  word_t* vg = ws + (long long)sms * N;
  for (int p0 = 0; p0 < B; p0 += pairs) {
    const float* c = cost + (long long)p0 * M * N;
    const float* mu_p = mu + (long long)p0 * M;
    const float* nu_p = nu + (long long)p0 * N;
    float* o = out + (long long)p0 * M * N;
    int np = B - p0 < pairs ? B - p0 : pairs;
    void* args[] = {(void*)&c,    (void*)&mu_p, (void*)&nu_p, (void*)&o,
                    (void*)&ws,   (void*)&vg,   (void*)&np,   (void*)&M,
                    (void*)&N,    (void*)&iters, (void*)&blocks_per_pair,
                    (void*)&rows, (void*)&resident};
    err = cudaLaunchCooperativeKernel(sinkhorn_kernel, dim3(sms),
                                      dim3(kThreads), args, (size_t)smem,
                                      stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// The current device's SM count and opt-in shared memory a block, the
// inputs of the host plan.
extern "C" int oetr_device_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_per_block,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return (int)err;
}

// cost [B, M, N], mu [B, M], nu [B, N], out [B, M, N]: f32, contiguous.
// work: 8-byte aligned scratch of (SMs + pairs)·N 8-byte words. pairs, rows
// and resident are the host plan: pairs per launch, rows a block, rows of a
// block kept in shared memory.
extern "C" int oetr_log_sinkhorn_f32(const void* cost, const void* mu,
                                     const void* nu, void* out, void* work,
                                     int B, int M, int N, int iters,
                                     int pairs, int rows, int resident,
                                     void* stream) {
  return launch((const float*)cost, (const float*)mu, (const float*)nu,
                (float*)out, work, B, M, N, iters, pairs, rows, resident,
                (cudaStream_t)stream);
}
