"""Build and bind the CUDA kernels: ``nvcc`` into a shared library with
a plain C interface, loaded with ctypes.

The library is compiled at first use from the sources beside this file,
into ``build/pypardis_tpu_torch/`` at the root of the checkout (or
``$PPTORCH_BUILD_DIR``), under a name keyed by the content of the sources
and the headers they include and by the flags, so an edited source or
header never loads a stale build.  ``PPTORCH_KERNEL_CHECKS=1`` builds
the checked variant instead (``-DPPT_CHECKED``: every guarded global
store of the kernels traps on an index past its extent, ``ppt_check.cuh``)
into a library of its own name, so the two never mix.  Each source
compiles to an object in its own ``nvcc`` process, all started
together, so the build takes as long as its slowest source rather than
their sum as kernel sources are added; one more ``nvcc`` links the
objects into the library.  ``nvcc`` is
taken from ``$CUDA_HOME/bin``, the ``PATH``, or ``/usr/local/cuda/bin``.
Nothing here runs at import time: the CPU tests import every module on
a machine without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("pair_kernels.cu", "sketch_kernels.cu", "query_kernels.cu")
# Headers the sources include: part of the build's key, so an edit to one
# rebuilds every source.
HEADERS = ("bf16_tile.cuh", "label_bound.cuh", "ppt_check.cuh")
# Compile flags of every source; the link adds ``-shared``.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The checked build's extra flag (PPTORCH_KERNEL_CHECKS=1).
CHECK_FLAGS = ("-DPPT_CHECKED",)

_lock = threading.Lock()
_lib = None
# Filled by the first build of the process: seconds spent in nvcc (0.0
# when a cached library was loaded) and the compiler's register /
# shared-memory report.
BUILD_INFO: dict = {}


def build_dir() -> str:
    env = os.environ.get("PPTORCH_BUILD_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(_HERE))
    return os.path.join(root, "build", "pypardis_tpu_torch")


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def checked() -> bool:
    """Whether this process builds and loads the checked variant."""
    return os.environ.get("PPTORCH_KERNEL_CHECKS", "") not in ("", "0")


def compile_flags() -> tuple:
    return NVCC_FLAGS + (CHECK_FLAGS if checked() else ())


def _library_path() -> str:
    h = hashlib.sha256(" ".join(compile_flags()).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    kind = "libpp_kernels_checked" if checked() else "libpp_kernels"
    return os.path.join(build_dir(), f"{kind}_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *compile_flags(), "-c", "-o", obj,
             os.path.join(_HERE, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    BUILD_INFO["log"] = "".join(logs)
    try:
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} ({proc.returncode}):\n{log}"
                )
        link = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        BUILD_INFO["log"] += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    os.replace(tmp, out)


def _bind(lib) -> None:
    p, f, i64, i32 = (
        ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
    )
    pair = [p, p, p, p, f, i64, i32, i32, i32]
    # B2 takes (tile_min, live_rows, out, evaluated, stream).
    skip = [p, p, p, p, p]
    lib.pp_minlab_pairs.argtypes = pair + skip
    lib.pp_minlab_pairs.restype = i32
    # (pts, colval, row_ptr, cols, centers, rnorm, eps2, n, d, tile, nt,
    # mode or fast): B1 then takes (out, band_pairs, flags,
    # rescored_pairs, stream), B2 its skip arguments.
    fast = [p, p, p, p, p, p, f, i64, i32, i32, i32, i32]
    lib.pp_count_pairs.argtypes = fast + [p] * 5
    lib.pp_count_pairs.restype = i32
    lib.pp_minlab_pairs_fast.argtypes = fast + skip
    lib.pp_minlab_pairs_fast.restype = i32
    # The sketch kernels take (..., nt, rescore, out) and end in
    # (band_pairs, flags, rescored_pairs, stream) for B3 and (tile_min,
    # evaluated, stream) for B4; B3 also takes the points' row-major copy
    # and the rows' bf16 fragments after the centres.
    sketch = [f, f, i64, i32, i32, i32, i32, i32, i32, p]
    lib.pp_count_pairs_sketch.argtypes = [p] * 8 + sketch + [p, p, p, p]
    lib.pp_count_pairs_sketch.restype = i32
    lib.pp_minlab_pairs_sketch.argtypes = [p] * 6 + sketch + [p, p, p]
    lib.pp_minlab_pairs_sketch.restype = i32
    lib.pp_mma_dot_probe.argtypes = [p, p, i32, i32, p, p]
    lib.pp_mma_dot_probe.restype = i32
    # B5: the per-index tables (coords, labels, L, C, block, d, then
    # pad_keys, leaf_end, ctr, slots, their four numels, stream); the call
    # (q, tile_leaf, coords, labels, ncols, nqt, d, qb, C, block, the four
    # tables, eps2, mixed, keep_stats, pass_stats, keys, grp, flags, out,
    # the numels of keys, grp and out, stream).
    lib.pp_query_tables.argtypes = [
        p, p, i32, i32, i32, i32, p, p, p, p, i64, i64, i64, i64, p,
    ]
    lib.pp_query_tables.restype = i32
    lib.pp_query_leaf.argtypes = [
        p, p, p, p, i64, i32, i32, i32, i32, i32, p, p, p, p, f, i32,
        p, p, p, p, p, p, i64, i64, i64, p,
    ]
    lib.pp_query_leaf.restype = i32


def load():
    """The bound kernel library, built on first use.  A build that runs
    ``nvcc`` records one ``compile`` event (``stage="kernel_build"``) on
    the current telemetry recorder; a cached load records none."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            BUILD_INFO["checked"] = checked()
            if os.path.exists(path):
                BUILD_INFO.setdefault("seconds", 0.0)
            else:
                _compile(path)
                from ..obs import event

                event("compile", stage="kernel_build",
                      seconds=round(BUILD_INFO["seconds"], 3),
                      checked=checked())
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
    return _lib
