// K6: streaming (KV-blocked) masked softmax attention, by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_attention.py::flash_attention_pallas (kernel
// _flash_attn_kernel). Per batch row, head and query row, over the keys in
// blocks of block_k = 64, with a running max m (-inf to start), sum and f32
// accumulator:
//   logit = (q · k in f32) · 1/sqrt(D), -inf off qmask ∧ kmask
//   new = max(m, max over the block);  safe = new if finite, else 0
//   corr = exp(m - safe) if m is finite, else 0
//   p = exp(logit - safe), 0 off the masks
//   acc = acc·corr + Σ round(p)·v;  sum = sum·corr + Σ p;  m = new
// and at the end out = round(acc / max(sum, 1e-30)). "round" is a cast to
// the I/O type T (a no-op in f32). p is rounded relative to the max of the
// blocks seen so far, so in bf16 the result depends on block_k: the plain
// version (ops/attention_kernels.py) walks the same 64-key blocks. Keys past
// S and rows past L are masked, which is what the Pallas kernel's zero
// padding gives.
//
// Two designs, one per dtype, chosen by the entry point; both keep the
// logits in registers and write nothing but the output:
// - bf16 (softmax_attention_mma.cuh): one block per (64-row query tile,
//   head, batch row), 4 warps of 16 rows; Q·Kᵀ and round(p)·V on the tensor
//   cores (mma.sync m16n8k16, f32 accumulators), p packed from the logits'
//   C registers into the A fragments of P·V; keys and values streamed
//   through a cp.async ring of 64-key tiles.
// - f32 (softmax_attention.cuh): the products on the FP32 pipes, since the
//   tensor cores would round f32 inputs to TF32; each query row keeps its
//   max, sum and accumulator in the registers of four threads.
//
// Bound on the H100: at [8, 400, 8, 32] bf16 as K5 (exponentials 2.4 us);
// at [2, 4096, 8, 32], exponentials 268 M (64 us) against 34 GFLOP (35 us
// on the tensor cores).
#include "softmax_attention.cuh"
#include "softmax_attention_mma.cuh"

extern "C" int oetr_flash_attention_f32(const void* q, const void* k,
                                        const void* v, const void* qmask,
                                        const void* kmask, void* out, int B,
                                        int L, int S, int H, int D, float temp,
                                        void* stream) {
  return oetr::softmax::launch_d<true>(q, k, v, qmask, kmask, out, B, L, S, H,
                                       D, temp, oetr::softmax::kBK, stream);
}

extern "C" int oetr_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, const void* qmask,
                                         const void* kmask, void* out, int B,
                                         int L, int S, int H, int D,
                                         float temp, void* stream) {
  return oetr::softmax_mma::launch_d<true>(q, k, v, qmask, kmask, out, B, L,
                                           S, H, D, temp, stream);
}
