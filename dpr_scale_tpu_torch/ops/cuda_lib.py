"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library links the shared CUDA
runtime (``libcudart.so``), the one PyTorch loads, so its launches go through
the runtime that ``torch.profiler`` traces; nvcc's default, a private static
copy of the runtime, hid the kernels' device time from the profiler. The build happens at first use,
never at import: this module imports on machines with no CUDA toolkit, where
only the kernels' plain PyTorch versions run.

The library lands in ``build/dpr_scale_tpu_torch/`` at the root of the
checkout, named by a hash of the sources, the headers they include and the
flags, so an edited source
rebuilds and an unchanged one is reused. Concurrent first uses (several
processes on one checkout) are serialised by a file lock.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = (
    "attention_fwd.cu", "attention_bwd.cu", "count_groups.cu", "ffn_fwd.cu", "gather_score.cu",
    "int_scan.cu", "mips_scan.cu", "topk_sweep.cu",
)
HEADERS = (
    "attention_ptx.cuh", "attention_tiles.cuh", "dropout_bits.cuh", "gmax_sweep.cuh",
    "hopper_ptx.cuh", "int_tile.cuh", "score_tile.cuh",
)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "dpr_scale_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared", "-cudart", "shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from dpr_scale_tpu_torch/csrc at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path. Raises with nvcc's output when the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libdst_kernels_{_source_hash()}.so")
    if os.path.exists(path):
        return path
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # built by another process meanwhile
            return path
        tmp = f"{path}.tmp.{os.getpid()}"
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        cmds = [
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(SRC_DIR, src)]
            for src, obj in zip(SOURCES, objs)
        ]
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        outs = [p.communicate()[0] for p in procs]
        # the toolkit's runtime where the loader finds none already loaded
        lib64 = os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(_nvcc()))), "lib64")
        link = [_nvcc(), *LINK_FLAGS, "-Xlinker", f"-rpath,{lib64}", "-o", tmp, *objs]
        log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = [link]
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(path[: -len(".so")] + ".log", "w") as f:
            f.write(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{log}")
        os.replace(tmp, path)
    return path


def build_log() -> str:
    """nvcc's output (ptxas register / shared-memory lines) of the build."""
    log = (_lib_path or build())[: -len(".so")] + ".log"
    with open(log) as f:
        return f.read()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(path)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            u, f = ctypes.c_uint, ctypes.c_float
            lib.dst_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, u, u, f, p]
            lib.dst_attention_fwd.restype = i
            lib.dst_attention_bwd.argtypes = [p] * 9 + [i, i, i, i, u, u, f, p]
            lib.dst_attention_bwd.restype = i
            lib.dst_attention_fwd_smem.argtypes = [i, i]
            lib.dst_attention_fwd_smem.restype = ll
            lib.dst_attention_bwd_smem.argtypes = [i, i, i]
            lib.dst_attention_bwd_smem.restype = ll
            lib.dst_count_above_groups.argtypes = [p, p, p, p, i, ll, i, ll, i, p]
            lib.dst_count_above_groups.restype = i
            lib.dst_count_above_groups_route.argtypes = [p, p, ll, i, ll, i]
            lib.dst_count_above_groups_route.restype = i
            lib.dst_count_above.argtypes = [p, p, p, p, i, ll, i, i, p]
            lib.dst_count_above.restype = i
            lib.dst_count_above_route.argtypes = [p, p, ll, i, i]
            lib.dst_count_above_route.restype = i
            lib.dst_groupmax.argtypes = [p, p, p, p, i, ll, i, i, p]
            lib.dst_groupmax.restype = i
            lib.dst_groupmax_route.argtypes = [p, p, ll, i, i]
            lib.dst_groupmax_route.restype = i
            lib.dst_bf16_sweep_smem.argtypes = [i]
            lib.dst_bf16_sweep_smem.restype = ll
            lib.dst_bf16_sweep_span.argtypes = [ll, i, i]
            lib.dst_bf16_sweep_span.restype = ll
            lib.dst_tile_max.argtypes = [p, p, p, i, ll, i, ll, i, p]
            lib.dst_tile_max.restype = i
            lib.dst_tile_max_route.argtypes = [p, p, ll, i, ll, i]
            lib.dst_tile_max_route.restype = i
            lib.dst_tile_max_smem.argtypes = [i]
            lib.dst_tile_max_smem.restype = ll
            lib.dst_topk_emit.argtypes = [p] * 5 + [i, ll, ll, i, i, i, i, p]
            lib.dst_topk_emit.restype = i
            lib.dst_topk_route.argtypes = [p, p, ll, i, i]
            lib.dst_topk_route.restype = i
            lib.dst_int_groupmax.argtypes = [p] * 6 + [i, ll, i, i, i, f, p]
            lib.dst_int_groupmax.restype = i
            lib.dst_int_groupmax_route.argtypes = [p, p, i, i]
            lib.dst_int_groupmax_route.restype = i
            lib.dst_int_groupmax_smem.argtypes = [i, i, i]
            lib.dst_int_groupmax_smem.restype = ll
            lib.dst_int8_tile_max.argtypes = [p, p, p, i, ll, i, ll, p]
            lib.dst_int8_tile_max.restype = i
            lib.dst_int8_tile_max_route.argtypes = [p, p, ll, i, ll]
            lib.dst_int8_tile_max_route.restype = i
            lib.dst_int8_tile_max_smem.argtypes = [i]
            lib.dst_int8_tile_max_smem.restype = ll
            lib.dst_ffn_fwd.argtypes = [p] * 8 + [i, i, i, u, u, f, p]
            lib.dst_ffn_fwd.restype = i
            lib.dst_ffn_ln_fwd.argtypes = [p] * 14 + [i, i, i, f, u, u, f, p]
            lib.dst_ffn_ln_fwd.restype = i
            lib.dst_ffn_gemm.argtypes = [p] * 5 + [i, i, i, i, u, u, f, p]
            lib.dst_ffn_gemm.restype = i
            lib.dst_ffn_ln_rows.argtypes = [p] * 5 + [i, i, f, p]
            lib.dst_ffn_ln_rows.restype = i
            lib.dst_ffn_gemm_smem.argtypes = [i]
            lib.dst_ffn_gemm_smem.restype = ll
            lib.dst_gather_serial.argtypes = [p] * 4 + [i, ll, i, i, i, i, p]
            lib.dst_gather_serial.restype = i
            lib.dst_gather_pipelined.argtypes = [p] * 4 + [i, ll, i, i, i, i, i, p]
            lib.dst_gather_pipelined.restype = i
            lib.dst_gather_pipelined_route.argtypes = [p, p, i, i]
            lib.dst_gather_pipelined_route.restype = i
            lib.dst_gather_pipelined_smem.argtypes = [i, i, i]
            lib.dst_gather_pipelined_smem.restype = ll
            lib.dst_gather_streamed.argtypes = [p] * 5 + [i, ll, i, i, i, i, p]
            lib.dst_gather_streamed.restype = i
            lib.dst_gather_run_max.argtypes = [p, p, i, p, i, i, i, p, p, p, i, i, p]
            lib.dst_gather_run_max.restype = i
            lib.dst_gather_run_max_route.argtypes = [p, i, i, i]
            lib.dst_gather_run_max_route.restype = i
            _lib, _lib_path = lib, path
        return _lib


class _TimedLibrary:
    """The loaded library with each launching entry point's call bracketed
    by CUDA events on the caller's current stream; ``calls`` collects
    (entry point, start event, end event)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self.calls = []

    def __getattr__(self, name):
        import torch

        fn = getattr(self._lib, name)
        if name.endswith(("_route", "_smem")):  # queries of the host side: no launch
            return fn

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.calls.append((name, start, end))
            return rc

        return timed


@contextlib.contextmanager
def timed_launches():
    """Within the block every kernel launch through :func:`library` is timed
    by CUDA events; yields the list of (entry point, start, end) events, to
    be read after a synchronize. The profiler's own record of the port's
    kernels is incomplete (ROADMAP C4), so reports take their time from
    here. Not thread-safe: the block swaps the library for every caller."""
    global _lib
    timed = _TimedLibrary(library())
    with _lock:
        _lib = timed
    try:
        yield timed.calls
    finally:
        with _lock:
            _lib = timed._lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")
