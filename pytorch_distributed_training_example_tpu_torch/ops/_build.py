"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with
a plain C interface, loaded with ``ctypes``. Nothing here runs at import:
a wrapper asks for its library the first time a CUDA tensor reaches it, and
``build_all`` compiles every source at once (one ``nvcc`` process per
source, all started together) for callers that want the build up front.

Libraries land in ``_build/`` inside the package (listed in ``.gitignore``),
named by a hash of their source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt
and an unchanged one is reused. A library is written under a temporary name
and renamed into place, so a reader never sees a half-written file.

A wrapper takes its C function from the library once (``cached``);
``using`` puts another build of a source in place of the loaded one for
the length of a block, as the planted-fault checks and the clock probes do.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel sources, one library each.
SOURCES = ("paged_decode", "flash_fwd", "flash_bwd", "grouped_matmul",
           "fused_router", "fused_bn_matmul")

_loaded: dict[str, ctypes.CDLL] = {}
#: Per library, the cached getters of its functions (``cached``).
_getters: dict[str, list] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def _paths(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    return src, lib


def _start(name: str):
    """Start ``nvcc`` for one source; None if its library is already built."""
    src, lib = _paths(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return out


def build_all() -> dict:
    """Compile every source in parallel. Returns the build seconds and each
    source's compiler log (``-Xptxas -v``: registers, shared memory,
    spills); an already-built library reports an empty log."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in SOURCES}
    logs = {n: (_finish(n, s) if s is not None else "")
            for n, s in started.items()}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(_paths(name)[1])
        _loaded[name] = lib
    return lib


def cached(name: str):
    """Decorator: cache a wrapper's getter of a function of library
    ``name``; ``using`` clears the cache when it swaps the library."""
    def wrap(getter):
        getter = functools.cache(getter)
        _getters.setdefault(name, []).append(getter)
        return getter
    return wrap


@contextlib.contextmanager
def using(name: str, lib: ctypes.CDLL):
    """Inside the block ``library(name)`` is ``lib`` (another build of
    ``csrc/<name>.cu``); the library loaded before, or none, comes back
    after."""
    before = _loaded.get(name)

    def swap(to):
        if to is None:
            _loaded.pop(name, None)
        else:
            _loaded[name] = to
        for getter in _getters.get(name, ()):
            getter.cache_clear()

    swap(lib)
    try:
        yield lib
    finally:
        swap(before)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
