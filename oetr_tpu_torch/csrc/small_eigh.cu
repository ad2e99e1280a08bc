// Batched eigendecomposition of small symmetric matrices for the pose
// estimator (ops/small_eigh.py): its 9x9 normal matrices (the 8-point and DLT
// null vectors, jnp.linalg.eigh in oetr_tpu/geometry/ransac.py:52 and
// homography.py:52) and its 3x3 Gram matrices (the 3x3 SVDs).
//
// One thread a matrix, f32, cyclic Jacobi with the rotation scheme of
// Numerical Recipes' `jacobi`: the upper triangle is rotated in place,
// the diagonal accumulates its updates separately, small off-diagonal
// entries are skipped in the first three sweeps and flushed to zero from
// the fifth, and the sweeps end when the off-diagonal sum is exactly 0 (at
// most kMaxSweeps). The input's lower triangle is read, as LAPACK's
// default ('L') reads it. The output is LAPACK's: eigenvalues ascending,
// eigenvectors as the columns of V (row-major [n, n]); an eigenvector's
// sign is not fixed.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kMaxSweeps = 50;
constexpr int kThreads = 128;

// The rotation of two entries of m (row stride n) by (s, tau).
__device__ __forceinline__ void rotate(float* m, int n, int i, int j, int k,
                                       int l, float s, float tau) {
  const float g = m[i * n + j];
  const float h = m[k * n + l];
  m[i * n + j] = g - s * (h + g * tau);
  m[k * n + l] = h + s * (g - h * tau);
}

__global__ void __launch_bounds__(kThreads)
    sym_eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
                    float* __restrict__ V, long long batch, int n) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= batch) return;
  const float* src = A + m * n * n;
  float a[kMaxN * kMaxN], v[kMaxN * kMaxN];
  float d[kMaxN], b[kMaxN], z[kMaxN];
  for (int i = 0; i < n; ++i) {
    for (int j = i; j < n; ++j) a[i * n + j] = src[j * n + i];
    for (int j = 0; j < n; ++j) v[i * n + j] = i == j ? 1.f : 0.f;
    d[i] = b[i] = a[i * n + i];
    z[i] = 0.f;
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    float sm = 0.f;
    for (int p = 0; p < n - 1; ++p)
      for (int q = p + 1; q < n; ++q) sm += fabsf(a[p * n + q]);
    if (sm == 0.f) break;
    const float tresh = sweep < 3 ? 0.2f * sm / (float)(n * n) : 0.f;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const float apq = a[p * n + q];
        const float g = 100.f * fabsf(apq);
        if (sweep > 3 && fabsf(d[p]) + g == fabsf(d[p]) &&
            fabsf(d[q]) + g == fabsf(d[q])) {
          a[p * n + q] = 0.f;
        } else if (fabsf(apq) > tresh) {
          float h = d[q] - d[p];
          float t;
          if (fabsf(h) + g == fabsf(h)) {
            t = apq / h;
          } else {
            const float theta = 0.5f * h / apq;
            t = 1.f / (fabsf(theta) + sqrtf(1.f + theta * theta));
            if (theta < 0.f) t = -t;
          }
          const float c = 1.f / sqrtf(1.f + t * t);
          const float s = t * c;
          const float tau = s / (1.f + c);
          h = t * apq;
          z[p] -= h;
          z[q] += h;
          d[p] -= h;
          d[q] += h;
          a[p * n + q] = 0.f;
          for (int j = 0; j < p; ++j) rotate(a, n, j, p, j, q, s, tau);
          for (int j = p + 1; j < q; ++j) rotate(a, n, p, j, j, q, s, tau);
          for (int j = q + 1; j < n; ++j) rotate(a, n, p, j, q, j, s, tau);
          for (int j = 0; j < n; ++j) rotate(v, n, j, p, j, q, s, tau);
        }
      }
    }
    for (int p = 0; p < n; ++p) {
      b[p] += z[p];
      d[p] = b[p];
      z[p] = 0.f;
    }
  }
  // Ascending: a selection sort that moves V's columns with the values.
  for (int i = 0; i < n - 1; ++i) {
    int k = i;
    for (int j = i + 1; j < n; ++j)
      if (d[j] < d[k]) k = j;
    if (k != i) {
      const float t = d[i];
      d[i] = d[k];
      d[k] = t;
      for (int r = 0; r < n; ++r) {
        const float u = v[r * n + i];
        v[r * n + i] = v[r * n + k];
        v[r * n + k] = u;
      }
    }
  }
  for (int i = 0; i < n; ++i) w[m * n + i] = d[i];
  float* dst = V + m * n * n;
  for (int i = 0; i < n * n; ++i) dst[i] = v[i];
}

}  // namespace

// A [batch, n, n] f32 (the lower triangle is read), w [batch, n], V
// [batch, n, n]. n <= 16.
extern "C" int oetr_sym_eigh_f32(const void* A, void* w, void* V,
                                 long long batch, int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const long long blocks = (batch + kThreads - 1) / kThreads;
  sym_eigh_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)w, (float*)V, batch, n);
  return (int)cudaGetLastError();
}
