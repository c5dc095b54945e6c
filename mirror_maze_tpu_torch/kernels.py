"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``_build/`` beside this
file (listed in ``.gitignore``), and loaded with ``ctypes``. A library is
named by a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused. ``build()`` compiles every source at once, one
``nvcc`` process each, in parallel.

Nothing here runs at import: the CPU tests import every module and this
machine may have no ``nvcc`` at all.

``launches`` counts kernel launches by name. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# No --use_fast_math: IEEE division and square root (-prec-div/-prec-sqrt
# are nvcc's defaults without it), and no multiply-add contraction, so the
# kernels round like their plain PyTorch versions and the CPU reference.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-prec-div=true", "-prec-sqrt=true",
    "-fmad=false",
)

_C = ctypes
_SIGNATURES = {
    "tracer": ("mm_trace_paths", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_int,
        _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_float, _C.c_float, _C.c_void_p,
    ]),
    "present": ("mm_present", [
        _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_void_p,
    ]),
}

launches: collections.Counter = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=tuple(_SIGNATURES), verbose: bool = False) -> dict:
    """Compile (where not built yet) and load the named kernels; returns
    {name: ctypes function}. Raises with nvcc's output on a failed build."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in todo:
            path = _lib_path(name)
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            if verbose:
                print(f"[nvcc {name}]\n{out.strip()}", flush=True)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return {n: _libs[n] for n in names}


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry on the current stream, count the
    launch and raise if CUDA refused it."""
    fn = _libs.get(name) or build((name,))[name]
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: error {err}")
    launches[name] += 1
