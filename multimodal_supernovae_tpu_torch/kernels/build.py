"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
host library of the data layer (``csrc/fastcsv.cpp``).

Each source has a plain C interface and is compiled into its own shared
library, then loaded with ``ctypes``: a ``.cu`` with ``nvcc`` for Hopper
(``sm_90a``, ``NVCC_FLAGS``), a ``.cpp`` with the host compiler (``$CXX``,
else ``g++``; ``HOST_FLAGS``). The sources include no PyTorch headers,
which keeps a build far shorter than one through
``torch.utils.cpp_extension.load``.

Nothing is built at import: the first ``load_library(name)`` compiles the
source into ``<package>/.kernel_build/`` (git-ignored), keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is reused. Builds run under a thread lock and a file lock, so the
serving batcher thread, the main thread and other processes never race on
one output file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / ".kernel_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit")


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found:
        return found
    raise RuntimeError(
        f"host C++ compiler {cxx!r} not found ($CXX, else g++): csrc/*.cpp is "
        "built at first use")


def _is_host(name: str) -> bool:
    return (CSRC_DIR / f"{name}.cpp").exists()


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on its source, the shared
    headers (``csrc/*.cuh``) and the flags; or ``csrc/<name>.cpp``, keyed
    on its source and ``HOST_FLAGS``."""
    if _is_host(name):
        src, flags = (CSRC_DIR / f"{name}.cpp").read_bytes(), HOST_FLAGS
    else:
        src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        flags = NVCC_FLAGS
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) anew; returns the seconds
    the compiler took. A failed build raises.

    The compiler's output (for ``nvcc``, ``-Xptxas=-v``: registers, shared
    memory and spills per kernel) is kept beside the library as
    ``<lib>.log``."""
    if _is_host(name):
        cmd, source = [_cxx(), *HOST_FLAGS], CSRC_DIR / f"{name}.cpp"
    else:
        cmd, source = [_nvcc(), *NVCC_FLAGS], CSRC_DIR / f"{name}.cu"
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed on csrc/{source.name} (exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
