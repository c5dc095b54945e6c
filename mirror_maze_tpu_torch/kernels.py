"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each library is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``_build/`` beside this
file (listed in ``.gitignore``), and loaded with ``ctypes``. A library is
named by a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused. ``build()`` compiles every library at once, one
``nvcc`` process each, in parallel.

The tracer's source gives four libraries (``LIBRARIES``): ``tracer``, the
24 instantiations an untextured scene runs, ``tracer_tex`` with the texture
stage, and ``tracer_diag`` / ``tracer_tex_diag``, which also gather the
per-block diagnostics. Each is a translation unit of its own, so a launch
without textures or diagnostics compiles none of their code. ``present``,
``bvh_walk`` (the jnp tracer's BVH traversal), ``threefry`` (every draw
of ops/prng.py), ``shade`` (one segment of the jnp tracer's bounce loop,
render/tracer.py) and the step's glue, ``frame_setup``, ``camera_rays`` and
``resolve`` (render/frame_glue.py), have a source each. The headers a
source includes (``#include "..."``: ``threefry.cuh``, ``quat.cuh``) are
hashed into its library's name with it.

Nothing here runs at import: the CPU tests import every module and this
machine may have no ``nvcc`` at all. A build is the program's span
``kernels.build``, a load and bind ``kernels.load`` (utils/profiling.py).

``launches`` counts kernel launches by name. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels. A launch made while a CUDA graph is captured runs
nothing: inside ``counting_capture()`` it is counted apart, and the graph's
runner adds those counts to ``launches`` on every replay
(runtime/graph.py).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
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
_TRACER = ("mm_trace_paths", [
    _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,     # ori, dirs, planes, P
    _C.c_void_p, _C.c_int,                               # spheres, S
    _C.c_void_p, _C.c_void_p,                            # plane and sphere texture rows
    _C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p,        # tiles, T, single, order
    _C.c_void_p, _C.c_int, _C.c_void_p, _C.c_void_p,     # axis entries, float4s, tile rows, runs
    _C.c_int,                                            # runs
    _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,  # seed, seed_row, light, work
    _C.c_void_p,                                         # counters
    _C.c_void_p, _C.c_void_p, _C.c_int,                  # diagnostics: segments, mask, words
    _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,    # R, B, segments, limits
    _C.c_int, _C.c_int, _C.c_int,                        # prims, glass, fresnel
    _C.c_float, _C.c_float,                              # mirror_tint, t_min
    _C.c_float, _C.c_float, _C.c_float, _C.c_float,      # sky rgb, strength
    _C.c_float, _C.c_float,                              # lighting factor, its log
    _C.c_int, _C.c_void_p,                               # most blocks, geometry out
    _C.c_void_p,                                         # stream
])
_PRESENT = ("mm_present", [
    _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,  # src, dst, halo top, halo bottom
    _C.c_int, _C.c_int, _C.c_int, _C.c_int,              # chunks x, y, chunk width, quantize
    _C.c_void_p,                                         # stream
])
_BVH_WALK = ("mm_bvh_walk", [
    _C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,        # noderow, leafpack, nodes, slots
    _C.c_int,                                            # max leaf
    _C.c_void_p, _C.c_void_p, _C.c_void_p,               # sphere centres, c2r2, ior
    _C.c_int, _C.c_int,                                  # spheres, planes
    _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,  # ori, dirs, t out, idx out
    _C.c_void_p, _C.c_void_p,                            # live ids, their count (or null)
    _C.c_int, _C.c_int, _C.c_float,                      # R, stack levels, t_min
    _C.c_void_p,                                         # work counters
    _C.c_void_p,                                         # stream
])
_THREEFRY = ("mm_threefry", [
    _C.c_void_p, _C.c_longlong, _C.c_int, _C.c_int,      # keys, key stride, source, output
    _C.c_void_p, _C.c_longlong, _C.c_uint,               # data, data stride, data word
    _C.c_ulonglong, _C.c_ulonglong,                      # counts a key, total
    _C.c_float, _C.c_float, _C.c_void_p,                 # lo, hi, out
    _C.c_void_p,                                         # stream
])
_SHADE = ("mm_shade", [
    _C.c_void_p, _C.c_int, _C.c_int,                     # params (render/tracer.py), glass, fresnel
    _C.c_void_p,                                         # stream
])
# The step's glue: the address of a ctypes Structure (render/frame_glue.py), the stream.
_GLUE = [_C.c_void_p, _C.c_void_p]
# name -> (source in csrc/, macros for nvcc, (C symbol, argument types))
LIBRARIES = {
    "tracer": ("tracer.cu", (), _TRACER),
    "tracer_tex": ("tracer.cu", ("-DMM_TEX=1",), _TRACER),
    "tracer_diag": ("tracer.cu", ("-DMM_DIAG=1",), _TRACER),
    "tracer_tex_diag": ("tracer.cu", ("-DMM_TEX=1", "-DMM_DIAG=1"), _TRACER),
    "present": ("present.cu", (), _PRESENT),
    "bvh_walk": ("bvh_walk.cu", (), _BVH_WALK),
    "threefry": ("threefry.cu", (), _THREEFRY),
    "shade": ("shade.cu", (), _SHADE),
    "frame_setup": ("frame_setup.cu", (), ("mm_frame_setup", _GLUE)),
    "camera_rays": ("camera_rays.cu", (), ("mm_camera_rays", _GLUE)),
    "resolve": ("resolve.cu", (), ("mm_resolve", _GLUE)),
}

# Further C entries of a library: (library, symbol) -> argument types.
# threefry's step check of its erf_inv route (ops/prng.py erf_inv_steps), and
# its draw at the rows of a live-id list (ops/prng.py listed).
ENTRIES = {
    ("threefry", "mm_erf_inv_steps"): [_C.c_uint, _C.c_uint, _C.c_ulonglong, _C.c_void_p,
                                       _C.c_void_p],   # first, stride, count, counts, stream
    ("threefry", "mm_threefry_rows"): _THREEFRY[1][:-1] + [
        _C.c_void_p, _C.c_void_p,                        # live ids, their count
        _C.c_void_p,                                     # stream
    ],
}

launches: collections.Counter = collections.Counter()
_captures: list = []    # the Counters of the captures in progress, innermost last
_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


@contextlib.contextmanager
def counting_capture():
    """Count the launches made inside into the yielded Counter instead of
    ``launches``: the block is a CUDA graph capture, where a launch is
    recorded and nothing runs."""
    counted = collections.Counter()
    _captures.append(counted)
    try:
        yield counted
    finally:
        _captures.pop()


def add_launches(counts) -> None:
    """Count the launches of one replay of a captured graph (the Counter
    ``counting_capture`` yielded for it)."""
    launches.update(counts)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sass(name: str) -> str | None:
    """``cuobjdump -sass`` of library ``name`` (built first), or None where
    the toolkit has no ``cuobjdump`` (on the PATH or beside ``nvcc``)."""
    build((name,))
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(_lib_path(name))], capture_output=True,
                          text=True, check=True).stdout


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(source: str) -> list:
    """The files of ``csrc/`` that build ``source``: the source, then every
    header it includes with ``#include "..."``, and theirs, each once, in the
    order first included."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        todo += [m.decode() for m in _INCLUDE.findall((CSRC / name).read_bytes())]
    return seen


def _lib_path(name: str) -> Path:
    source, macros, _ = LIBRARIES[name]
    h = hashlib.sha256()
    for f in sources(source):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + macros).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_summary(out: str) -> str:
    """``nvcc -Xptxas -v`` output cut to one line per kernel entry: its
    template arguments (``Lb1E`` = true), registers, spills, stack."""
    entry = re.compile(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, (\d+) bytes spill "
        r"stores, (\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    lines = []
    for name, stack, st, ld, regs in entry.findall(out):
        args = ",".join(re.findall(r"L[bi](\d+)E", name))
        short = re.sub(r"^_Z\d+", "", name).split("I")[0]
        lines.append(f"{short}<{args}>: {regs} registers, {st}+{ld} bytes spilled, "
                     f"{stack} bytes stack")
    return "\n".join(lines) or out.strip()


def build(names=tuple(LIBRARIES), verbose: bool = False) -> dict:
    """Compile (where not built yet) and load the named libraries; returns
    {name: ctypes function}. Raises with nvcc's output on a failed build."""
    from .utils.profiling import span

    with _lock:
        todo = [n for n in names if n not in _libs]
        missing = [n for n in todo if not _lib_path(n).exists()]
        if missing:
            with span("kernels.build"):
                _compile(missing, verbose)
        if todo:
            with span("kernels.load"):
                for name in todo:
                    symbol, argtypes = LIBRARIES[name][2]
                    _libs[name] = _bind(name, symbol, argtypes)
        return {n: _libs[n] for n in names}


def _compile(names, verbose: bool) -> None:
    """One ``nvcc`` process a library, in parallel; raises with nvcc's
    output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        source, macros, _ = LIBRARIES[name]
        cmd = [_nvcc(), *NVCC_FLAGS, *macros, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / source)]
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
            print(f"[nvcc {name}]\n{ptxas_summary(out)}", flush=True)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def _bind(name: str, symbol: str, argtypes):
    """Library ``name``'s C entry ``symbol``, loaded (built already)."""
    fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _entry(name: str, symbol: str):
    """Library ``name``'s further C entry ``symbol`` (``ENTRIES``)."""
    from .utils.profiling import span

    fn = _libs.get((name, symbol))
    if fn is None:
        build((name,))
        with _lock, span("kernels.load"):
            fn = _libs[(name, symbol)] = _bind(name, symbol, ENTRIES[(name, symbol)])
    return fn


def launch(name: str, *args, count_as: str | None = None, symbol: str | None = None) -> None:
    """Call library ``name``'s C entry (or its further entry ``symbol``) on
    the current stream, count the launch (under ``count_as`` where one
    library serves two variants; into the innermost ``counting_capture``
    where one is open) and raise if CUDA refused it."""
    if symbol is None:
        fn = _libs.get(name) or build((name,))[name]
    else:
        fn = _entry(name, symbol)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: error {err}")
    count(count_as or name)


def count(name: str, n: int = 1) -> None:
    """Count ``n`` launches of kernel ``name`` (into the innermost
    ``counting_capture`` where one is open): ``launch``'s own, and those a C
    entry makes after its first kernel (frame_setup's merge passes)."""
    (_captures[-1] if _captures else launches)[name] += n
