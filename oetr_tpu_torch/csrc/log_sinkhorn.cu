// K4: log-domain Sinkhorn iterations, by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_sinkhorn.py::log_sinkhorn_pallas (kernel
// _sinkhorn_kernel). For each pair b, with u = v = 0 to start, `iters` times:
//   u[i] = mu[i] - LSE_j (C[i, j] + v[j])      (row pass)
//   v[j] = nu[j] - LSE_i (C[i, j] + u[i])      (column pass)
// then out[i, j] = C[i, j] + u[i] + v[j]. Everything is f32. Masked entries
// carry the finite -1e9 sentinel of ops/sinkhorn.py, so no row or column is
// ever empty and no special case is needed: a row whose entries are all the
// sentinel gets the same finite u as torch.logsumexp gives it.
//
// Why the TPU design does not carry over: the Pallas kernel holds one pair's
// whole matrix in VMEM and loops inside one grid step. At SuperGlue's
// k = 2048 one pair is 2049^2 x 4 B = 16.8 MB, far over the 227 KB of shared
// memory an SM has, but inside the H100's 50 MB L2.
//
// Design (simple, correct first): the host loop below runs the pairs in
// chunks whose matrices fit an L2 budget (`chunk` pairs, 2 at k = 2048), and
// for each chunk launches `iters` x (row pass, column pass), then the
// epilogue. So after the first pass the 60 passes read the chunk from L2,
// not from HBM.
//   - Row pass: one warp per row. Each lane keeps an online log-sum-exp
//     (running max m and sum s, rescaled only when the max grows: one
//     exponential per element) over its columns j = lane + 32k; the warp
//     merges the 32 (m, s) pairs with shuffles.
//   - Column pass: one block per strip of 32 adjacent columns of one pair,
//     so a warp's loads of a row are coalesced; the block's 32 warps split
//     the rows, and their partial (m, s) pairs are merged in shared memory.
//   - Epilogue: out = (C + u) + v, the plain version's order of addition.
// Each lane's log-sum-exp is one dependent chain of loads and exponentials,
// so the passes are bound by latency, not by L2 bandwidth: both unroll 8
// deep to keep loads in flight, and the column pass uses 32 warps a block
// because at 2 pairs it has only 130 blocks.
//
// Bound on the H100 at B = 8, M = N = 2049, iters = 30: bytes 2·B·M·N·4 =
// 269 MB (0.080 ms at 3.35 TB/s); f32 operations 4·B·iters·M·N = 4.0 GFLOP
// (0.060 ms at 67 TFLOP/s); exponentials 2·B·iters·M·N = 2.0e9 (0.48 ms at
// 16 a clock per SM x 132 SMs x 1.98 GHz). The exponentials bind.
// Rounding: __expf and the online rescaling round differently from
// torch.logsumexp; outputs agree with the plain version to ~1e-5.
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kRowWarps = 8;    // rows (one per warp) per block, row pass
constexpr int kColWarps = 32;   // warps sharing a 32-column strip
constexpr int kUnroll = 8;      // loads in flight per lane per pass
constexpr int kOutThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Online log-sum-exp state: the sum of exp(t - m) over the values t seen.
// It starts at (m, s) = (-FLT_MAX, 0), which merges as an empty set.
__device__ __forceinline__ void lse_push(float& m, float& s, float t) {
  if (t > m) {
    s = fmaf(s, __expf(m - t), 1.f);
    m = t;
  } else {
    s += __expf(t - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mm = fmaxf(m, m2);
  s = s * __expf(m - mm) + s2 * __expf(m2 - mm);
  m = mm;
}

// u[r] = mu[r] - LSE_j(C[r, j] + v[pair(r), j]) for rows r of the chunk.
__global__ void __launch_bounds__(kRowWarps * 32) sinkhorn_row_kernel(
    const float* __restrict__ cost, const float* __restrict__ mu,
    const float* __restrict__ v, float* __restrict__ u, long long rows, int M,
    int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kRowWarps + warp;
  if (r >= rows) return;
  const float* c = cost + r * N;
  const float* vb = v + (r / M) * N;
  float m = -FLT_MAX, s = 0.f;
#pragma unroll kUnroll
  for (int j = lane; j < N; j += 32) lse_push(m, s, c[j] + vb[j]);
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    lse_merge(m, s, m2, s2);
  }
  if (lane == 0) u[r] = mu[r] - (m + logf(s));
}

// v[pair, j] = nu[pair, j] - LSE_i(C[pair, i, j] + u[pair, i]); one block
// per (pair, strip of 32 columns).
__global__ void __launch_bounds__(kColWarps * 32) sinkhorn_col_kernel(
    const float* __restrict__ cost, const float* __restrict__ nu,
    const float* __restrict__ u, float* __restrict__ v, int M, int N,
    int strips) {
  __shared__ float part_m[kColWarps][32];
  __shared__ float part_s[kColWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = blockIdx.x / strips;
  const int j = (blockIdx.x % strips) * 32 + lane;
  const float* c = cost + pair * M * (long long)N;
  const float* ub = u + pair * M;
  float m = -FLT_MAX, s = 0.f;
  if (j < N) {
#pragma unroll kUnroll
    for (int i = warp; i < M; i += kColWarps) {
      lse_push(m, s, c[(long long)i * N + j] + ub[i]);
    }
  }
  part_m[warp][lane] = m;
  part_s[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || j >= N) return;
  for (int w = 1; w < kColWarps; ++w) {
    lse_merge(m, s, part_m[w][lane], part_s[w][lane]);
  }
  v[pair * N + j] = nu[pair * N + j] - (m + logf(s));
}

// out = (C + u) + v over the chunk's elements.
__global__ void __launch_bounds__(kOutThreads) sinkhorn_out_kernel(
    const float* __restrict__ cost, const float* __restrict__ u,
    const float* __restrict__ v, float* __restrict__ out, int M, int N,
    long long total) {
  for (long long idx = (long long)blockIdx.x * kOutThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kOutThreads) {
    const long long row = idx / N;
    const int col = (int)(idx - row * N);
    out[idx] = (cost[idx] + u[row]) + v[(row / M) * N + col];
  }
}

int launch(const float* cost, const float* mu, const float* nu, float* u,
           float* v, float* out, int B, int M, int N, int iters, int chunk,
           cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || iters < 0 || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long pair_elems = (long long)M * N;
  const int strips = (N + 31) / 32;
  for (int p0 = 0; p0 < B; p0 += chunk) {
    const int np = B - p0 < chunk ? B - p0 : chunk;
    const float* c = cost + p0 * pair_elems;
    const float* mu_c = mu + (long long)p0 * M;
    const float* nu_c = nu + (long long)p0 * N;
    float* u_c = u + (long long)p0 * M;
    float* v_c = v + (long long)p0 * N;
    const long long rows = (long long)np * M;
    const unsigned row_blocks = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
    for (int it = 0; it < iters; ++it) {
      sinkhorn_row_kernel<<<row_blocks, kRowWarps * 32, 0, stream>>>(
          c, mu_c, v_c, u_c, rows, M, N);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      sinkhorn_col_kernel<<<(unsigned)(np * strips), kColWarps * 32, 0,
                            stream>>>(c, nu_c, u_c, v_c, M, N, strips);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const long long total = np * pair_elems;
    long long blocks = (total + kOutThreads - 1) / kOutThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    sinkhorn_out_kernel<<<(unsigned)blocks, kOutThreads, 0, stream>>>(
        c, u_c, v_c, out + p0 * pair_elems, M, N, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// cost [B, M, N], mu [B, M], nu [B, N], out [B, M, N]: f32, contiguous.
// u [B, M] and v [B, N] are f32 scratch that the caller zeroes. `chunk` is
// the number of pairs whose passes run together (the L2 budget).
extern "C" int oetr_log_sinkhorn_f32(const void* cost, const void* mu,
                                     const void* nu, void* u, void* v,
                                     void* out, int B, int M, int N,
                                     int iters, int chunk, void* stream) {
  return launch((const float*)cost, (const float*)mu, (const float*)nu,
                (float*)u, (float*)v, (float*)out, B, M, N, iters, chunk,
                (cudaStream_t)stream);
}
