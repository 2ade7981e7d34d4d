"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (``build/repro_torch/<hash>/lib<name>.so`` at the
repository root, where ``<hash>`` covers every source and flag), loaded
with :mod:`ctypes`. All sources compile in parallel, one ``nvcc`` each, on
the first kernel call; later calls and later processes reuse the output.
Nothing is fetched: the build needs the sources in this package and the
CUDA toolkit. A failed build raises; callers never fall back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("lb_sax", "ed", "wkv6", "dtw", "rg_lru")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``, the toolkit's standard prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA toolkit is needed to build the port's kernels")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source not yet built (in parallel). Returns
    ``{"seconds": wall seconds spent, "built": [names], "dir": path}``;
    the ``nvcc`` output of each build is kept in ``<dir>/<name>.log``."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").is_file()]
    t0 = time.perf_counter()
    if todo:
        out.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = []
        for name in todo:
            tmp = out / f"lib{name}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, tmp, proc in procs:
            log, _ = proc.communicate()
            (out / f"{name}.log").write_bytes(log)
            if proc.returncode:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                              f"{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out / f"lib{name}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": todo, "dir": str(out)}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources first
    if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in SOURCES:
                raise KeyError(f"no CUDA source named {name!r}")
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            _declare(name, lib)
            _libs[name] = lib
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported function (pointers and the stream
    as c_void_p, so ctypes never truncates them to 32-bit ints)."""
    if name == "lb_sax":
        lib.lb_sax_matrix_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          ctypes.c_float, _P]
        lib.lb_sax_matrix_f32.restype = _I
    elif name == "ed":
        for fn in (lib.ed_matrix_f32, lib.ed_matrix_bf16):
            fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
            fn.restype = _I
        for fn in (lib.ed_min_f32, lib.ed_min_bf16):
            fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
            fn.restype = _I
        lib.decode_bf16_ed_matrix.argtypes = [_P, _P, ctypes.c_longlong, _P, _P,
                                              _I, _I, _I, _P]
        lib.decode_bf16_ed_matrix.restype = _I
    elif name == "wkv6":
        for fn in (lib.wkv6_f32, lib.wkv6_bf16):
            fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
            fn.restype = _I
    elif name == "dtw":
        lib.dtw_band_f32.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.dtw_band_f32.restype = _I
    elif name == "rg_lru":
        lib.rg_lru_scan_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.rg_lru_scan_f32.restype = _I


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
