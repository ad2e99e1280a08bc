"""Where K1's time goes inside a launch, on the card, by cluster size.

    python -m oetr_tpu_torch.k1_phases

Builds a copy of ``csrc/linear_attention.cu`` with stamps at the kernel's
phase boundaries (thread 0 of each block reads the SM's ``clock64`` after
the barrier that closes a phase, and ``%globaltimer`` at the block's start
and end), runs it at OETR's [8, 400, 8, 32] in bf16 and f32, at D = 64 and
at [2, 2500, 8, 32] (1600x1600) with 1, 2, 4 and 8 blocks per (batch row,
head), and prints one JSON line per case: the device time of the stamped
call (torch.profiler), the cycles of each phase averaged over the blocks,
each block's time from start to end, the kernel's span from the first
block's start to the last block's end and the spread of the blocks'
starts (a second wave of clusters shows there), beside the cluster size
that ``linear_attention_cluster`` picks and the clusters the card holds at
once. The stamps add no barrier. The copy is built into the package's
git-ignored ``_build/`` directory.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .ops import _build
from .ops.attention_kernels import (MAX_CLUSTER, _rounded_inv,
                                    cluster_capacity,
                                    linear_attention_cluster,
                                    linear_attention_reference)

PHASES = ("first key tile arrives and is formed", "rest of the key pass",
          "first query tile formed, cluster barrier",
          "KV' exchange and second barrier", "query pass")
_DEFS = r'''
__device__ long long g_stamps[kMaxStampBlocks * 8];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k, value) do { if (threadIdx.x == 0) { \
  const long long blk = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * \
                        gridDim.x + blockIdx.x; \
  if (blk < kMaxStampBlocks) g_stamps[blk * 8 + (k)] = (value); } } while (0)
'''
MAX_STAMP_BLOCKS = 4096
# (text of the kernel, the same text with a stamp): slots 0-5 hold clock64
# at the phase boundaries, 6 and 7 %globaltimer at the start and the end.
STAMPS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     f"constexpr long long kMaxStampBlocks = {MAX_STAMP_BLOCKS};\n" + _DEFS),
    ("  const bool vec = a.D % kVec<T> == 0;\n",
     "  const bool vec = a.D % kVec<T> == 0;\n"
     "  STAMP(0, clock64());\n  STAMP(6, global_ns());\n"),
    ("    __syncthreads();\n    key_product<DP>(",
     "    __syncthreads();\n    if (u == 0) STAMP(1, clock64());\n"
     "    key_product<DP>("),
    ("  float* P = reinterpret_cast<float*>(smem + SM::kP);\n",
     "  STAMP(2, clock64());\n"
     "  float* P = reinterpret_cast<float*>(smem + SM::kP);\n"),
    ("  cluster_sync();\n  constexpr int kF4",
     "  cluster_sync();\n  STAMP(3, clock64());\n  constexpr int kF4"),
    ("another after this\n", "another after this\n  STAMP(4, clock64());\n"),
    ("  mma::cp_async_wait<0>();\n}\n",
     "  mma::cp_async_wait<0>();\n  STAMP(5, clock64());\n"
     "  STAMP(7, global_ns());\n}\n"),
)
_COPY_OUT = '''
extern "C" int oetr_k1_stamps(long long* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(long long) * n);
}
'''


def stamped_source() -> str:
    """``csrc/linear_attention.cu`` with every stamp of ``STAMPS`` in;
    raises if the kernel no longer holds one of the texts, once."""
    src = (_build.SRC_DIR / "linear_attention.cu").read_text()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"k1_phases: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    return src + _COPY_OUT


def stamped_library() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "k1_phases.cu"
    so = _build.BUILD_DIR / "k1_phases.so"
    cu.write_text(stamped_source())
    subprocess.run([_build.nvcc_path(), *_build.COMPILE_FLAGS, "-I",
                    str(_build.SRC_DIR), "-shared", str(cu), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name in ("oetr_linear_attention_f32", "oetr_linear_attention_bf16"):
        getattr(lib, name).argtypes = _build.ENTRY_POINTS[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.oetr_k1_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn()`` in a torch.profiler trace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def run(lib, dtype, b: int, n: int, h: int, d: int, nc: int) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    out = torch.empty_like(q)
    entry = getattr(lib, "oetr_linear_attention_"
                    + ("bf16" if dtype == torch.bfloat16 else "f32"))

    def call():
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                   out.data_ptr(), b, n, n, h, d, 1e-6,
                   _rounded_inv(n, dtype), nc,
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"k1_phases: launch failed, cudaError {rc}")

    ms = device_ms(call)
    call()
    torch.cuda.synchronize()
    err = (out.float() - linear_attention_reference(q, k, v).float()
           ).abs().max().item()
    blocks = min(nc * h * b, MAX_STAMP_BLOCKS)
    buf = (ctypes.c_longlong * (blocks * 8))()
    if lib.oetr_k1_stamps(buf, blocks * 8):
        raise RuntimeError("k1_phases: could not read the stamps")
    st = torch.tensor(list(buf), dtype=torch.float64).view(blocks, 8)
    cycles = {name: (st[:, i + 1] - st[:, i]).mean().item()
              for i, name in enumerate(PHASES)}
    return {"dtype": str(dtype).split(".")[-1], "shape": [b, n, h, d],
            "cluster": nc, "device_ms": ms, "max_abs_err": err,
            "cycles": cycles, "block_us": (st[:, 7] - st[:, 6]).mean().item()
            / 1e3, "span_us": (st[:, 7].max() - st[:, 6].min()).item() / 1e3,
            "start_spread_us": (st[:, 6].max() - st[:, 6].min()).item() / 1e3}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = stamped_library()
    for dtype, (b, n, h, d) in ((torch.bfloat16, (8, 400, 8, 32)),
                                (torch.float32, (8, 400, 8, 32)),
                                (torch.bfloat16, (8, 400, 8, 64)),
                                (torch.bfloat16, (2, 2500, 8, 32))):
        capacity = cluster_capacity(0, dtype, d)
        pick = linear_attention_cluster(b * h, n, capacity)
        for nc in (1, 2, 4, MAX_CLUSTER):
            print(json.dumps({"device": smi, "picked": pick,
                              "clusters_at_once": capacity,
                              **run(lib, dtype, b, n, h, d, nc)}),
                  flush=True)


if __name__ == "__main__":
    main()
