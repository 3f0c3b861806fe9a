"""Build the repository's host C++ sources with g++ and load them through
ctypes — the port's copy of native/build.py (``build_library``,
``load_library``).

The source is ``native/{name}.cpp`` at the root of the checkout, read in
place (the port never edits or imports ``native``).  The shared object
goes to ``pytorch_distributed_tpu_torch/build/lib{name}.so`` and is built
again only when the source is newer.  Each build writes a temporary file
and renames it over the target, so processes building one source at
once leave one whole library.  A missing compiler or a failed compile
raises ``NativeBuildError``: callers do not fall back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str, timeout: float = 120.0) -> str:
    """Compile ``native/{name}.cpp`` unless its library is newer; returns
    the library's path."""
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    if not os.path.exists(src):
        raise NativeBuildError(f"no source {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True,
                                  timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"{CXX} could not build {name}: {e}") \
                from e
        if proc.returncode != 0:
            raise NativeBuildError(f"{CXX} failed for {name} (exit "
                                   f"{proc.returncode}):\n"
                                   f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library(name: str, timeout: float = 120.0) -> ctypes.CDLL:
    """The built library, loaded as ``ctypes.CDLL``: its calls release the
    GIL, so a pipelined actor's forward runs while the envs step."""
    return ctypes.CDLL(build_library(name, timeout=timeout))
