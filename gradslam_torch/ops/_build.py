r"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library goes to ``gradslam_torch/_build/`` and its file name
carries a hash of the sources and flags, so an edit rebuilds it. Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.

A missing ``nvcc`` or a failed build raises with the compiler's output.
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

__all__ = ["load_library", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]


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


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry
    points' argument and return types."""
    sources = _sources()
    lib_path = BUILD_DIR / f"libgradslam_kernels_{_digest(sources)}.so"
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
            tmp = os.path.join(work, "lib.so")
            link = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            _check(link, proc.returncode, proc.stdout, proc.stderr)
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gradslam_knn1.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.gradslam_knn1.restype = ci
    lib.gradslam_scatter_rows.argtypes = [
        vp, vp, ctypes.c_ulonglong, vp, ci, vp, ci, cll, cll, cll, cll, vp]
    lib.gradslam_scatter_rows.restype = ci
    return lib


def _check(cmd, returncode, stdout, stderr) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}"
        )
