"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc -c`` (all started
together; the ``csrc/*.cuh`` headers they share are part of the key below),
then linked into one shared library with a plain C interface.
No source includes PyTorch's headers, so a build takes seconds. The
library is keyed by a hash of the sources and flags and lands in
``oetr_tpu_torch/_build/`` (git-ignored), with the compiler's resource
report beside it in a ``.json`` of the same name; a later call in the same
checkout reuses both. Nothing here runs at import: the first call of
``load_library`` builds.

``build_once`` is the one build path of the port's native code (these
kernels and the data service, ``data/native.py``): under a file lock, into
a fresh directory, then ``os.replace`` into place, so processes that start
at once build a library once and never load a half-written one.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import json
import os
import re
import shlex
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes. Every pointer, and the stream, is a
# c_void_p; each returns the cudaError_t of its launch.
_LINEAR_ENCODER_ARGS = [_P, _P, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _LL, _I, _I, _I, _I, _I, _F, _F, _P]
# x, gamma, beta, work, out, B, H, W, C, groups, eps, stream
_GN_POOL_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
_GN_STATS_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
_GN_APPLY_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
_SINKHORN_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# q, k, v, q_mask, kv_mask, out, B, L, S, H, D, then each kernel's own.
_ATTENTION_ARGS = [_P] * 6 + [_I] * 5
ENTRY_POINTS = {
    "oetr_linear_encoder_f32": _LINEAR_ENCODER_ARGS,
    "oetr_linear_encoder_bf16": _LINEAR_ENCODER_ARGS,
    "oetr_linear_encoder_workspace": [_I, _I, _I, _I, _I, _P],
    "oetr_gn_relu_maxpool_f32": _GN_POOL_ARGS,
    "oetr_gn_relu_maxpool_bf16": _GN_POOL_ARGS,
    "oetr_gn_stats_f32": _GN_STATS_ARGS,
    "oetr_gn_stats_bf16": _GN_STATS_ARGS,
    "oetr_gn_apply_pool_f32": _GN_APPLY_ARGS,
    "oetr_gn_apply_pool_bf16": _GN_APPLY_ARGS,
    "oetr_log_sinkhorn_f32": _SINKHORN_ARGS,
    "oetr_device_limits": [_P, _P],
    "oetr_linear_attention_capacity": [_I, _I, _I, _P],
    "oetr_linear_attention_f32": _ATTENTION_ARGS + [_F, _F, _I, _P],
    "oetr_linear_attention_bf16": _ATTENTION_ARGS + [_F, _F, _I, _P],
    "oetr_full_attention_f32": _ATTENTION_ARGS + [_F, _P],
    "oetr_full_attention_bf16": _ATTENTION_ARGS + [_F, _P],
    "oetr_flash_attention_f32": _ATTENTION_ARGS + [_F, _P],
    "oetr_flash_attention_bf16": _ATTENTION_ARGS + [_F, _P],
    # A, w, V, batch, n, stream
    "oetr_sym_eigh_f32": [_P, _P, _P, _LL, _I, _P],
}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_key(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    for flags in (COMPILE_FLAGS, LINK_FLAGS):
        h.update(" ".join(flags).encode())
    for src in srcs + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_commands(nvcc: str, out_dir: Path, lib: Path, srcs: list[Path]):
    """(compile commands, one per source; link command)."""
    objs = [out_dir / (s.stem + ".o") for s in srcs]
    compiles = [[nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)]
                for s, o in zip(srcs, objs)]
    link = [nvcc, *LINK_FLAGS, *map(str, objs), "-o", str(lib)]
    return compiles, link


def ptxas_resources(logs: list[str]) -> dict:
    """Registers and spill bytes per kernel (mangled name) from the
    ``ptxas -v`` reports in the compile logs."""
    res, name = {}, None
    for line in (ln for log in logs for ln in log.splitlines()):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            res[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            res[name]["spill_stores"] = int(m.group(1))
            res[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res[name]["registers"] = int(m.group(1))
    return res


def ptxas_stack_frames(logs: list[str]) -> dict:
    """Stack frame bytes per kernel (mangled name) from the ``ptxas -v``
    reports: each stack line belongs to the function of the "Function
    properties for" line before it, and is left out where that is not a
    kernel (a subroutine such as IEEE division's slow path)."""
    kernels, frames, props = set(), {}, None
    for line in (ln for log in logs for ln in log.splitlines()):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernels.add(m.group(1))
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and props in kernels:
            frames[props] = int(m.group(1))
    return frames


@contextlib.contextmanager
def dir_lock(path: Path):
    """An exclusive ``flock`` on the directory ``path`` (created if
    missing), held for the ``with`` block; other processes that ask for it
    wait. Locking the directory leaves no lock file behind."""
    path.mkdir(parents=True, exist_ok=True)
    fd = os.open(path, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def build_once(products: list[Path], build: Callable[[Path], object]):
    """Make ``products`` (files of one directory) unless all exist.

    Under a lock on their directory, ``build(work)`` writes files of
    the products' names into ``work``, a fresh directory beside them; each
    is then moved into place with ``os.replace``, in the order given (so
    a reader that checks for the last one sees the others). Returns what
    ``build`` returned, or None where the products were already there (a
    process that waited on the lock finds them built)."""
    if all(p.exists() for p in products):
        return None
    out_dir = products[-1].parent
    with dir_lock(out_dir):
        if all(p.exists() for p in products):
            return None
        work = Path(tempfile.mkdtemp(prefix="tmp_", dir=out_dir))
        try:
            result = build(work)
            for p in products:
                os.replace(work / p.name, p)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return result


def host_library_path(src: Path, stem: str, flags: list[str]) -> Path:
    """Where g++ puts the library of ``src`` built with ``flags``: named by
    a hash of both, in ``BUILD_DIR``."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_host_library(src: Path, stem: str, flags: list[str]) -> Path:
    """Compile a host C++ source into a shared library with g++ (``$CXX``)
    through ``build_once``. Returns its path; raises RuntimeError with the
    compiler's message where it cannot be built."""
    lib = host_library_path(src, stem, flags)
    cxx = shlex.split(os.environ.get("CXX", "g++"))

    def build(work: Path) -> None:
        cmd = [*cxx, *flags, str(src), "-o", str(work / lib.name)]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cmd[0]}: {e}") from e
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{p.stderr}")

    build_once([lib], build)
    return lib


def _run_parallel(cmds: list[list[str]]) -> tuple[list[str], list[float]]:
    """Run the commands at once. Returns each one's output and the seconds
    until it was seen to end; raises if any failed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, seconds, failed = [], [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        seconds.append(time.perf_counter() - t0)
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs, seconds


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library.

    Returns ``(lib, record)``: the ``ctypes.CDLL`` with argtypes set, and a
    dict with the library path, whether it was built in this call, the
    seconds of each build step, the compiler's resource report and, parsed
    from it, each kernel's registers, spill bytes and stack frame. The
    report is kept beside the library, so a reused library carries the one
    of its build.
    """
    srcs = sources()
    key = build_key(srcs)
    lib_path = BUILD_DIR / f"oetr_kernels_{key}.so"
    report_path = lib_path.with_suffix(".json")
    record = {"so": str(lib_path), "built": False, "steps_s": {}}

    def build(work: Path) -> dict:
        compiles, link = build_commands(nvcc_path(), work,
                                        work / lib_path.name, srcs)
        logs, compile_s = _run_parallel(compiles)
        _, link_s = _run_parallel([link])
        report = {"ptxas": [line.strip() for log in logs
                            for line in log.splitlines()
                            if "registers" in line or "spill" in line],
                  "resources": ptxas_resources(logs),
                  "stack_frames": ptxas_stack_frames(logs)}
        (work / report_path.name).write_text(json.dumps(report))
        steps = {f"nvcc -c {s.name}": t for s, t in zip(srcs, compile_s)}
        steps["nvcc -shared (link)"] = link_s[0]
        return dict(report, built=True, steps_s=steps)

    # The report lands first: a library is never seen without its own.
    built = build_once([report_path, lib_path], build)
    record.update(built or json.loads(report_path.read_text()))
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.oetr_cuda_error_string.argtypes = [_I]
    lib.oetr_cuda_error_string.restype = ctypes.c_char_p
    lib.oetr_gn_workspace_floats.argtypes = [_I, _I, _I, _I]
    lib.oetr_gn_workspace_floats.restype = _LL
    return lib, record


def check_launch(lib, rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.oetr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError {rc} ({msg})")
