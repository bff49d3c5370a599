"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with `ctypes`: no PyTorch headers, so a build
takes seconds.  All sources compile in parallel, once per process, at the
first launch of any kernel, into ``build/repro_torch/`` under the checkout;
a library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  Each build's compiler
output (ptxas registers and spills) is kept beside its library as ``.log``,
so a process that reuses a library still reads it.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` and no ``--use_fast_math``: every
float operation rounds once, as written, and the only fused multiply-adds are
the explicit ``__fmaf_rn`` calls that mirror the JAX reference.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fleet_step.cu", "rollout.cu", "shared_step.cu",
           "rollout_shared.cu", "lif_forward.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "ssd.cu", "ssd_bwd.cu", "silu.cu",
           "recorder.cu", "adamw.cu")
HEADERS = ("plasticity.cuh", "hopper.cuh", "fleet.cuh", "slab.cuh",
           "forward.cuh", "ssd.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}      # this process's build: seconds, sources, logs


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "that builds the repro_torch kernels")


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all at once; returns
    ``{"seconds": ..., "built": [sources compiled now], "log": {source:
    compiler output}}``, the output of a reused library read from its
    ``.log``."""
    with _lock:
        if build_info:
            return build_info
        build_dir().mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in SOURCES:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        log, failed = {}, []
        for src, (p, tmp, out) in procs.items():
            log[src] = p.communicate()[0]
            if p.returncode == 0:
                out.with_suffix(".log").write_text(log[src])
                os.replace(tmp, out)
            else:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(log[s] for s in failed))
        for src in SOURCES:
            saved = _target(src).with_suffix(".log")
            if src not in log and saved.exists():
                log[src] = saved.read_text()
        build_info.update(seconds=time.perf_counter() - t0,
                          built=sorted(procs), log=log)
        return build_info


# Called with ``"library:<source>"`` on a library's first load in the
# process; the recompile watchdog registers one when it is installed.
load_listeners: List[Callable[[str], None]] = []


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (building all of them first).  A
    library's first load in the process is reported to `load_listeners`."""
    build_all()
    with _lock:
        lib = _libs.get(source)
        first = lib is None
        if first:
            lib = _libs[source] = ctypes.CDLL(str(_target(source)))
    if first:
        for listener in load_listeners:
            listener(f"library:{source}")
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (see cudaError_t)")
