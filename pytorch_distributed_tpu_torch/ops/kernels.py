"""Build ``csrc/*.cu`` at first use and bind the libraries through ctypes.

Each source is compiled on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC`` into
``pytorch_distributed_tpu_torch/build/lib<name>_<hash>.so``, keyed by a hash
of the source, the shared headers and the flags, so an edited source builds
anew and an unchanged one is reused.  Missing libraries are built in
parallel (one ``nvcc`` per source, all started together).  The sources
have a plain C interface and include no PyTorch header, which keeps a
build to seconds.

Every C entry takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``), launches on that stream without synchronising, and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.  The
libraries load as ``ctypes.PyDLL``, which keeps the GIL across a call: a
launch takes microseconds, and a thread that gave the GIL up would wait a
whole switch interval to get it back while actor threads are busy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("per_sample", "torso_gemm", "torso_gemm_sm90")
HEADERS = ("common.cuh", "tma.cuh")  # included by the sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.PyDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelBuildError(
            "nvcc not found (on PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fname in (f"{name}.cu", *HEADERS):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes at once.  Returns ``{name: seconds}`` for those it built."""
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = library_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    if errors:
        raise KernelBuildError("\n".join(errors))
    return took


def library(name: str, signatures: Dict[str, Sequence],
            init: Optional[str] = None) -> ctypes.PyDLL:
    """The loaded library ``name``, built first if needed, with every entry
    in ``signatures`` (``{fn: argtypes}``) declared to return ``c_int``.
    ``init`` names an entry of ``signatures`` without arguments that is
    called once, when the library is loaded (so before any CUDA graph
    capture); it raises if that returns non-zero."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(SOURCES)
            lib = ctypes.PyDLL(library_path(name))
            lib.pdt_error_string.argtypes = [ctypes.c_int]
            lib.pdt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            if init is not None:
                check(lib, getattr(lib, init)(), init)
            _libs[name] = lib
        return lib


def check(lib: ctypes.PyDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.pdt_error_string(err).decode()})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
