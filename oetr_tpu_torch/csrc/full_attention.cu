// K5: whole-row masked softmax attention, by hand for Hopper.
//
// Replaces oetr_tpu/ops/pallas_attention.py::full_attention_pallas (kernel
// _full_attn_kernel). Per batch row, head and query row l, over the keys s:
//   logit = (q_l · k_s in f32) · 1/sqrt(D), -inf off qmask ∧ kmask
//   m = max_s logit (0 if no key is visible);  p = exp(logit - m), 0 off the masks
//   attn = round(p / max(Σ_s p, 1e-30))         (normalised, then rounded)
//   out = round(Σ_s attn · v_s)                 (f32 sums)
// "round" is a cast to the I/O type T (a no-op in f32). A missing mask is
// all true, so with only q_mask the masked query rows give 0, as the Pallas
// kernel gives them.
//
// Why the TPU design does not carry over: the Pallas kernel holds a batch
// row's whole [N, H·D] blocks in VMEM and the [L, S] logits of one head at
// a time. Here a block owns 64 query rows of one head, and the logits never
// leave registers. Because attn is normalised before it is rounded, the sum
// must be known before the first product with V: the kernel walks the key
// tiles twice, first for each row's max and sum, then for attn · V. An
// online rescale of the accumulator would round p relative to a running
// max instead, which is K6's arithmetic, not K5's.
//
// Two designs, one per dtype, chosen by the entry point:
// - bf16 (softmax_attention_mma.cuh): Q·Kᵀ and attn·V on the tensor cores
//   (mma.sync m16n8k16, f32 accumulators), keys and values streamed through
//   a cp.async ring of 64-key tiles in both passes.
// - f32 (softmax_attention.cuh): the products on the FP32 pipes, since the
//   tensor cores would round f32 inputs to TF32. The key and value rows of
//   the head are staged in shared memory once for both passes when they
//   fit a 96 KB budget (S rounded up to a 64-row tile, times (D+4)·2·4
//   bytes), else each pass stages them chunk by chunk.
//
// Bound on the H100 at [8, 400, 8, 32] bf16: exponentials B·H·L·S = 10.2 M
// (2.4 us at 16 a clock per SM), operations 4·B·H·L·S·D = 1.31 GFLOP (1.3 us
// on the tensor cores), bytes 6.6 MB (2.0 us). The bf16 kernel computes each
// logit twice on the tensor cores and takes two exponentials a logit (one a
// pass), so it stays a few times above that bound.
#include "softmax_attention.cuh"
#include "softmax_attention_mma.cuh"

namespace {

constexpr size_t kStageBudget = 96 * 1024;

// Rows of keys the f32 kernel stages at once: all of them (rounded up to a
// tile) when they fit the budget, else the most whole tiles that do.
int auto_chunk(int S, int D) {
  using namespace oetr::softmax;
  const size_t per_row = 2 * (size_t)(D + kPad) * sizeof(float) + 1;
  const int all = (S + kBK - 1) / kBK * kBK;
  const int fit = (int)(kStageBudget / per_row) / kBK * kBK;
  return all <= fit ? all : (fit > kBK ? fit : kBK);
}

}  // namespace

extern "C" int oetr_full_attention_f32(const void* q, const void* k,
                                       const void* v, const void* qmask,
                                       const void* kmask, void* out, int B,
                                       int L, int S, int H, int D, float temp,
                                       void* stream) {
  return oetr::softmax::launch_d<false>(q, k, v, qmask, kmask, out, B, L, S,
                                        H, D, temp, auto_chunk(S, D), stream);
}

extern "C" int oetr_full_attention_bf16(const void* q, const void* k,
                                        const void* v, const void* qmask,
                                        const void* kmask, void* out, int B,
                                        int L, int S, int H, int D, float temp,
                                        void* stream) {
  return oetr::softmax_mma::launch_d<false>(q, k, v, qmask, kmask, out, B, L,
                                            S, H, D, temp, stream);
}
