"""Profiling: torch.profiler traces, roofline accounting against the card's
peaks, steady-state timing, device memory, and the trainer's scalar log
(port of ``oetr_tpu/utils/profiling.py``).

The peaks are an H100 SXM's (NVIDIA's data sheet): every roofline bound of
the port (``chip_smoke.py``'s ``bound()`` among them) reads them here.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32

# A torch.profiler trace on the H100 can miss the first device events of
# the calls it traces: the first 2 of a trace (LoFTR's first convolution
# and copy, in chip_smoke.py's runs), and late in a long run the first
# kernel after 4 pads (the first of 3 pose calls, in every trace; the
# host launched it, 4,062 launches against 4,061 events). The count, not
# the time, is what it misses: pads of 1 ms in all did not help, and a
# trace of 3 train steps missed all of 16 pads. So a trace starts with
# PADS sleep kernels, which absorb what it misses, and ends with them
# too; their events are left out by name (chip_smoke.traced_stats
# reports how many it missed).
PADS, PAD_KERNEL = 64, "spin_kernel"


def pad_trace() -> None:
    """Launch the PADS sleep kernels that open (and close) a trace."""
    for _ in range(PADS):
        torch.cuda._sleep(1000)


def device_events(prof) -> tuple[list, list]:
    """The device events of a trace opened by ``pad_trace``, the pads left
    out: (kernels, copies and sets; the device-side spans of the
    record_function ranges, which the profiler marks as user annotations
    and which are not device work)."""
    work, spans = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or PAD_KERNEL in evt.name:
            continue
        (spans if evt.is_user_annotation else work).append(evt)
    return work, spans


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block with torch.profiler (the host's ops, and the card's
    kernels and copies where CUDA is there, the trace opened and closed by
    ``pad_trace``) and write it to ``{logdir}/trace.json`` as a Chrome
    trace (Perfetto, chrome://tracing) when the block ends, also on an
    error. Yields the profile (``device_events`` reads its device work
    after the block)."""
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        if cuda:
            pad_trace()
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
            pad_trace()
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def speed_of_light(flops: float, bytes_accessed: float,
                   peak_flops: float = PEAK_OPS_PER_S["bfloat16"],
                   peak_bw: float = HBM_BYTES_PER_S) -> dict:
    """Roofline least time of one kernel and what bounds it: the larger of
    ``flops`` over ``peak_flops`` and ``bytes_accessed`` over ``peak_bw``
    (seconds)."""
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / peak_bw
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_sol_s": max(t_compute, t_memory),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "arithmetic_intensity": flops / max(bytes_accessed, 1.0),
    }


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _wait_for(out) -> None:
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


def benchmark(fn, *args, iters: int = 20, warmup: int = 2) -> dict:
    """Steady-state wall time of ``fn(*args)``: ``warmup`` calls, then
    ``iters`` timed calls, each run waiting for the devices of the tensors
    in the last call's output (nested in lists, tuples and dicts)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait_for(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait_for(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_s": 1.0 / dt}


def device_memory_stats(device=None) -> dict:
    """Memory of one card: torch's allocator (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved``) against the card's memory
    (``bytes_limit``, ``bytes_free`` from ``cudaMemGetInfo``) and
    ``utilization``, bytes_in_use over bytes_limit. ``device``: a CUDA
    device (the current one by default); {} for a device without such
    statistics (the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    out = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
           "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
           "bytes_limit": int(total), "bytes_free": int(free)}
    out["utilization"] = out["bytes_in_use"] / max(out["bytes_limit"], 1)
    return out


class ScalarWriter:
    """Scalars per step to TensorBoard through
    ``torch.utils.tensorboard`` where it imports, else as one JSON line a
    step to ``{logdir}/scalars.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
            self._fh = None
        except Exception:
            self._tb = None
            self._fh = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def write(self, step: int, scalars: dict) -> None:
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        else:
            self._fh.write(json.dumps(
                {"step": int(step),
                 **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._fh.close()
