"""Build and load the package's CUDA kernels.

On first use, ``load()`` compiles every ``csrc/*.cu`` with nvcc for
Hopper (``sm_90a``), one nvcc process per source, all started together,
links the objects into one shared library with a plain C interface, and
loads it with ctypes. The library lands in ``build/grav1synth_tpu_torch/``
at the root of the checkout (``GRAV1_TORCH_BUILD_DIR`` overrides), named
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once. A failed build raises with nvcc's output.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argtypes of the C entry points in csrc/grain_kernels.cu,
# csrc/pattern_kernels.cu, csrc/tables_kernels.cu, csrc/diff_kernels.cu and
# csrc/estimate_kernels.cu
SIGNATURES = {
    "grain_luma": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _P],
    "grain_chroma_pair": [
        _P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
    "grain_fused": [
        _P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
    "grain_chroma": [_P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "grain_pattern": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "grain_tables": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "diff_flat_block_activity": [_P, _P, _I, _I, _I, _P],
    "diff_plane_stats": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "estimate_self_blur": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    "estimate_self_stats": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "grain_error_string": [_I],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_dir() -> str:
    return os.environ.get("GRAV1_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "grav1synth_tpu_torch"
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the grain kernels are built from source on first use"
        )
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC_DIR}")
    return srcs


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir(), f"libgrav1synth_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu (if the hashed library is missing); returns its
    path. ``verbose`` adds ``-Xptxas -v`` and prints nvcc's output."""
    srcs = _sources()
    lib_path = _library_path()
    if os.path.exists(lib_path) and not verbose:
        return lib_path
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        objs = [
            os.path.join(tmp, os.path.basename(src) + ".o") for src in srcs
        ]
        cmds = [
            [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)
        ]
        procs = [
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            for cmd in cmds
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(cmds, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
                )
        so = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        if verbose:
            print("".join(outputs), end="")
        os.replace(so, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.grain_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load().grain_error_string(err).decode()
