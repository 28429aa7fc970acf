"""Builds and loads the port's CUDA kernels.

Each source in csrc/ is compiled by its own `nvcc` for sm_90a into a
shared library with a plain C interface, loaded through ctypes (the way
pipelinedp_tpu/native builds its C++ library with g++). The builds of all
sources start together on first use and land in `build/kernels/` at the
repository root, named by a hash of the sources and flags so an edited
kernel is rebuilt. There is no fallback: a missing `nvcc` or a failed
build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("row_keys", "bound_rows", "reduce_partitions", "release_epilogue",
           "radix_sort", "compact_kept", "quantile_counts", "quantile_descend",
           "vector_release", "block_offsets", "gather_rows",
           "factorize_codes", "lookup_codes", "append_rows", "pld_fft",
           "log_spectrum", "group_stats", "log_bins", "sweep_stats",
           "sweep_report")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_D = ctypes.c_double
_F = ctypes.c_float
_SIGNATURES = {
    "row_keys": {
        "row_keys": (_I, [_P, _P, _P, _LL, _I, _P, _U, _U, _P, _P, _P, _I,
                          _P]),
        "total_keys": (_I, [_P, _P, _LL, _U, _U, _P, _P, _I, _P]),
    },
    "bound_rows": {
        "bound_rows_scratch_bytes": (_LL, [_LL]),
        "bound_rows": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _I,
                            _I, _P, _P, _P, _P, _P, _P, _P, _I, _P]),
        "total_bound_rows": (_I, [_P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P,
                                  _P, _P, _P, _I, _P]),
    },
    "reduce_partitions": {
        "reduce_partitions_scratch_bytes": (_LL, [_LL, _I, _I]),
        "reduce_partitions": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _P,
                                   _P, _P, _P, _P, _P, _I, _I, _P]),
        "reduce_vectors_scratch_bytes": (_LL, [_LL, _I, _I]),
        "reduce_vectors": (_I, [_P, _P, _P, _P, _LL, _I, _I, _LL, _P, _P, _I,
                                _I, _P]),
    },
    "release_epilogue": {
        "release_epilogue": (_I, [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _I, _P, _I, _P]),
    },
    "radix_sort": {
        "radix_sort_scratch_bytes": (_LL, [_LL]),
        "radix_sort_varying": (_I, [_P, _P, _I, _LL, _P, _P]),
        "radix_sort": (_I, [_P, _P, _I, _LL, _P, _P, _P, _P, _P]),
    },
    "compact_kept": {
        "compact_kept_scratch_bytes": (_LL, [_LL]),
        "compact_kept": (_I, [_P, _LL, _P, _P, _P, _I, _I, _P, _P, _P,
                              _P]),
    },
    "quantile_counts": {
        "quantile_leaf_counts": (_I, [_P, _P, _P, _P, _LL, _LL, _I, _I, _D,
                                      _D, _P, _I, _P]),
        "quantile_level_counts": (_I, [_P, _I, _I, _I, _P]),
        "quantile_child_counts": (_I, [_P, _P, _P, _P, _LL, _LL, _I, _I, _I,
                                       _I, _P, _I, _D, _D, _P, _I, _P]),
    },
    "quantile_descend": {
        "quantile_descend_dense": (_I, [_P, _LL, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _P, _I, _D, _I, _P]),
        "quantile_descend_step": (_I, [_P, _LL, _I, _P, _P, _P, _P, _U, _U,
                                       _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _D, _I, _P]),
    },
    "vector_release": {
        "vector_release": (_I, [_P, _LL, _I, _I, _D, _D, _U, _U, _I, _P, _P,
                                _P, _P, _I, _D, _I, _P]),
    },
    "block_offsets": {
        "block_offsets": (_I, [_P, _LL, _P, _LL, _P, _P]),
    },
    "gather_rows": {
        "gather_rows": (_I, [_P, _LL, _P, _P, _P, _P, _I, _P]),
    },
    "factorize_codes": {
        "factorize_codes_scratch_bytes": (_LL, [_LL]),
        "factorize_codes": (_I, [_P, _P, _LL, _P, _P, _P, _P]),
    },
    "lookup_codes": {
        "lookup_codes": (_I, [_P, _LL, _P, _LL, _P, _P, _P]),
    },
    "append_rows": {
        "append_rows_fill_tail": (_I, [_P, _P, _P, _P, _I, _LL, _LL, _P]),
        "append_rows_grow": (_I, [_P, _P, _P, _P, _P, _I, _LL, _LL, _P]),
    },
    "pld_fft": {
        "pld_rfft": (_I, [_P, _LL, _LL, _P, _P, _P, _P]),
        "pld_irfft": (_I, [_P, _LL, _LL, _P, _P, _P, _P]),
    },
    "log_spectrum": {
        "log_spectrum_accumulate": (_I, [_P, _LL, _LL, _P, _P, _P]),
        "log_spectrum_finalize": (_I, [_P, _LL, _P, _P]),
    },
    "group_stats": {
        "group_stats_scratch_bytes": (_LL, [_LL]),
        "group_stats_pairs": (_I, [_P, _P, _P, _P, _P, _LL, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P]),
        "group_stats_keys": (_I, [_P, _P, _P, _LL, _P, _P, _P, _P]),
    },
    "log_bins": {
        "log_bins_int_scratch_bytes": (_LL, []),
        "log_bins_int": (_I, [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P]),
        "log_bins_float": (_I, [_P, _P, _LL, _I, _F, _P, _P, _P, _P, _P,
                                _P, _P]),
    },
    "sweep_stats": {
        "sweep_stats": (_I, [_P, _P, _P, _P, _LL, _P, _LL, _P, _P, _P, _I,
                             _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P]),
    },
    "sweep_report": {
        "sweep_report": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                              _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    },
}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "pipelinedp_tpu_torch/csrc at first use and need the CUDA toolkit "
        "(nvcc on PATH or /usr/local/cuda/bin/nvcc).")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _build_missing() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if errors:
        raise RuntimeError("nvcc failed to build the port's kernels:\n" +
                           "\n".join(errors))


def build_all() -> float:
    """Builds (where missing) and loads every kernel; returns the seconds
    it took."""
    started = time.perf_counter()
    with _lock:
        if len(_libraries) < len(SOURCES):
            _build_missing()
            for src in SOURCES:
                if src in _libraries:
                    continue
                loaded = ctypes.CDLL(str(_target(src)))
                for fn, (restype, argtypes) in _SIGNATURES[src].items():
                    getattr(loaded, fn).restype = restype
                    getattr(loaded, fn).argtypes = argtypes
                _libraries[src] = loaded
    return time.perf_counter() - started


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu."""
    if name not in _libraries:
        build_all()
    return _libraries[name]
