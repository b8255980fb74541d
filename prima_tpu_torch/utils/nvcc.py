"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source (a `.cu` file with a plain C interface) compiles into
its own shared library under `build/prima_tpu_torch/` at the repository
root, named by the hash of the source, on first CUDA use. Nothing here
runs at import time, so the CPU tests never need nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "prima_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts a kernel wrapper's launches (shows that a run went through
    the kernel). The wrapper adds one where it launches, nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _target(src: str) -> tuple[str, str]:
    path = os.path.join(_PKG_DIR, src)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    return path, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(src: str) -> tuple[str, subprocess.Popen | None]:
    path, out = _target(src)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, path]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return out, proc


def _finish(src: str, out: str, proc: subprocess.Popen | None) -> str:
    """Wait for one build; return the compiler's log ("" when cached)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    os.replace(proc.tmp, out)  # type: ignore[attr-defined]
    return log


def build(sources: list[str]) -> dict[str, str]:
    """Compile every source not yet built, one nvcc per source, all started
    together. Returns {source: compiler log}."""
    with _lock:
        started = [(src, *_start(src)) for src in sources]
        return {src: _finish(src, out, proc) for src, out, proc in started}


def load(src: str) -> ctypes.CDLL:
    """The shared library built from `src` (relative to the package)."""
    with _lock:
        lib = _loaded.get(src)
        if lib is None:
            out, proc = _start(src)
            _finish(src, out, proc)
            lib = _loaded[src] = ctypes.CDLL(out)
        return lib
