// Warp-level tensor-core, asynchronous-copy and exponential primitives
// (inline PTX, sm_80 and later; built here for sm_90a), used by the bf16
// softmax-attention kernels (softmax_attention_mma.cuh) and the bf16
// encoder sublayer (linear_encoder.cu).
//
// Fragment layouts of mma.sync m16n8k16 (bf16 in, f32 out), for lane
// = 4·g + t of a warp:
//   A (16x16, row-major), 4 registers of 2 bf16 each, the lower column in
//     the low half: a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same),
//     a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, same).
//   B (16x8, k x n), 2 registers: b0 = (k 2t, 2t+1; col g), b1 = (k 2t+8,
//     2t+9; col g).
//   C, D (16x8, f32), 4 registers: (row g, cols 2t, 2t+1), then (row g+8,
//     cols 2t, 2t+1).
// ldmatrix .x4 loads four 8x8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane 4·g + t receives register i = (row g,
// cols 2t, 2t+1) of matrix i, or with .trans (rows 2t, 2t+1; col g).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace oetr {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zero-filled (and
// nothing read from src) when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices, transposed: lanes 0..7 give the row addresses of
// matrix 0, lanes 8..15 those of matrix 1 (the other lanes' are ignored).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a·b on the tensor cores: a 16x16 bf16, b 16x8 bf16, d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx, denormal results flushed
// to 0; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
}  // namespace oetr
