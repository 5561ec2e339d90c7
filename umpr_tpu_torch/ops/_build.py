"""Build the CUDA sources under ``umpr_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exports a plain C function ``<name>`` (and
``error_string``).  At first use it is compiled by ``nvcc`` for ``sm_90a``
into a shared library under ``build/kernels/`` at the repository root (a
directory git ignores), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, and
loaded with ctypes.  Nothing is compiled while a module is imported, and a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("gru_input_proj", "bigru_recurrence", "bigru_backward",
           "gru_input_proj_bwd", "gru_input_proj_dx", "bias_relu_pool",
           "bias_relu_pool_bwd", "affinity_tiles", "affinity_finish")

_lock = threading.Lock()
_libs = {}  # name -> loaded ctypes.CDLL


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES):
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns {name: compiler
    output} for the sources compiled now (``-Xptxas=-v`` register and
    shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        running[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in running.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name):
    """The ctypes library of ``csrc/<name>.cu``, built and loaded at first
    use."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def kernel_function(name, argtypes, symbol=None):
    """The C function ``symbol`` (default ``name``) of ``csrc/<name>.cu``,
    built and loaded at first use, with its argument types set.  Returns
    (function, error_string function)."""
    lib = library(name)
    fn = getattr(lib, symbol or name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, lib.error_string
