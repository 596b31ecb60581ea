r"""Build and load the port's CUDA kernels, and build its host libraries.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. A host library (:func:`build_host_library`: the frame decoder,
``datasets/csrc/frameio.cpp``) is compiled at first use with the host's C++
compiler (``$CXX``, else ``g++``, the compiler ``nvcc`` drives on the card's
machine), with ``HOST_FLAGS``. Both go to ``gradslam_torch/_build/`` under a
file name that carries a hash of the sources and flags, so an edit rebuilds
them; each is written in a temporary directory there and renamed into
place, so processes that build at once do not clash. Nothing here runs at
import time: the CPU tests import every module without ``nvcc``.

A missing compiler or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "build_host_library", "NVCC_FLAGS", "HOST_FLAGS", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # each kernel's registers, shared memory and spills
]
# No -march and no -ffast-math, and no contraction into fused multiply-adds:
# each float operation rounds on its own, as the numpy version of the same
# arithmetic and the JAX package's native library (a default x86-64 build)
# round it.
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]
# The compilers' messages of the last build in this process (the
# ``-Xptxas=-v`` report); empty when the library was already built.
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of gradslam_torch need the CUDA toolkit to build."
    )


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry
    points' argument and return types."""
    sources = _sources()
    lib_path = BUILD_DIR / f"libgradslam_kernels_{_digest(sources, NVCC_FLAGS)}.so"
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            objs = [os.path.join(work, f"{src.stem}.o") for src in sources]
            compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for obj, src in zip(objs, sources)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for cmd in compiles]
            outputs = [proc.communicate() for proc in procs]  # wait for all
            for cmd, proc, (out, err) in zip(compiles, procs, outputs):
                _check(cmd, proc.returncode, out, err)
            global build_log
            build_log = "".join(out + err for out, err in outputs)
            tmp = os.path.join(work, "lib.so")
            link = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            _check(link, proc.returncode, proc.stdout, proc.stderr)
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gradslam_knn1.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    lib.gradslam_knn1.restype = ci
    lib.gradslam_knn1_resident_blocks.argtypes = []
    lib.gradslam_knn1_resident_blocks.restype = ci
    lib.gradslam_scatter_rows.argtypes = [
        vp, vp, ctypes.c_ulonglong, ci, cll, cll, vp, ci, vp, ci, ci, ci, ci, cll, vp]
    lib.gradslam_scatter_rows.restype = ci
    lib.gradslam_if_begin.argtypes = [vp, vp, vp]
    lib.gradslam_if_begin.restype = ci
    lib.gradslam_if_end.argtypes = [vp]
    lib.gradslam_if_end.restype = ci
    lib.gradslam_cuda_error.argtypes = [ci]
    lib.gradslam_cuda_error.restype = ctypes.c_char_p
    return lib


def _cxx() -> str:
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {name!r} not found ($CXX, else g++ on $PATH); the frame "
            "decoder of gradslam_torch is a C++ library built at first use."
        )
    return found


def build_host_library(name: str, sources) -> Path:
    """Build (if needed) the shared library ``lib<name>_<hash>.so`` from the
    C++ ``sources`` with the host compiler and ``HOST_FLAGS``; returns its
    path. The compiler is looked up only when the library must be built."""
    sources = [Path(s) for s in sources]
    lib_path = BUILD_DIR / f"lib{name}_{_digest(sources, HOST_FLAGS)}.so"
    if not lib_path.exists():
        cxx = _cxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = os.path.join(work, lib_path.name)
            cmd = [cxx, *HOST_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            _check(cmd, proc.returncode, proc.stdout, proc.stderr)
            os.replace(tmp, lib_path)
    return lib_path


def _check(cmd, returncode, stdout, stderr) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed ({returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}"
        )
