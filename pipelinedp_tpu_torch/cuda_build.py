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
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("row_keys", "bound_rows", "reduce_partitions", "release_epilogue",
           "radix_sort", "compact_kept", "quantile_counts", "quantile_descend",
           "vector_release", "block_offsets", "gather_rows",
           "factorize_codes", "lookup_codes", "append_rows", "pld_fft",
           "log_spectrum", "group_stats", "log_bins", "sweep_stats",
           "sweep_report", "combine_shards", "reshard_count",
           "reshard_exchange", "mesh_factorize")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

# Constants a source shares with the Python side, named only here: nvcc
# gets each as a -D macro of that source, kernels.py reads them from here.
SORT_MAX_WORDS = 4   # C5: key words a sort takes
SORT_MAX_RUNS = 4    # C5: runs of varying bits a word's packed key holds
SORT_DIGIT_BITS = 8  # C5: bits a digit pass sorts
SORT_TILE = 4096     # C5: rows a sweep pass's block ranks
RESHARD_TILE = 4096  # C22: rows a block counts and ranks
EXCHANGE_TILE = 1024  # C23: rows a block stages
DESCEND_VALUE_QUANTILES = 32  # C8: quantiles the launch's parameters carry
DESCEND_LANE_WORDS = 512  # C8: lane key words the parameters carry
LOG_BINS_MAX_STATS = 16  # C18: integer stats one launch bins
DEFINES = {
    "radix_sort": {"PDP_SORT_MAX_WORDS": SORT_MAX_WORDS,
                   "PDP_SORT_MAX_RUNS": SORT_MAX_RUNS,
                   "PDP_SORT_DIGIT_BITS": SORT_DIGIT_BITS,
                   "PDP_SORT_TILE": SORT_TILE},
    "reshard_count": {"PDP_RESHARD_TILE": RESHARD_TILE},
    "reshard_exchange": {"PDP_EXCHANGE_TILE": EXCHANGE_TILE},
    "quantile_descend": {"PDP_DESCEND_VALUE_QUANTILES": DESCEND_VALUE_QUANTILES,
                         "PDP_DESCEND_LANE_WORDS": DESCEND_LANE_WORDS},
    "log_bins": {"PDP_LOG_BINS_MAX_STATS": LOG_BINS_MAX_STATS},
}

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
        "row_keys_lanes": (_I, [_P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P,
                                _P, _I, _P]),
        "total_keys_lanes": (_I, [_P, _P, _LL, _LL, _P, _P, _P, _I, _P]),
    },
    "bound_rows": {
        "bound_rows_scratch_bytes": (_LL, [_LL]),
        "bound_rows": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _I,
                            _I, _P, _P, _P, _P, _P, _P, _P, _I, _P]),
        "total_bound_rows": (_I, [_P, _P, _P, _P, _P, _LL, _LL, _I, _P, _P,
                                  _P, _P, _P, _I, _P]),
        "bound_rows_lanes": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _LL,
                                  _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _P]),
        "total_bound_rows_lanes": (_I, [_P, _P, _P, _P, _P, _LL, _LL, _LL,
                                        _I, _P, _P, _P, _P, _P, _I, _P]),
    },
    "reduce_partitions": {
        "reduce_partitions_scratch_bytes": (_LL, [_LL, _I, _I]),
        "reduce_partitions": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _P,
                                   _P, _LL, _P, _P, _P, _P, _P, _I, _I, _P]),
        "reduce_vectors_scratch_bytes": (_LL, [_LL, _I, _I, _I]),
        "reduce_vectors": (_I, [_P, _P, _P, _P, _LL, _I, _I, _LL, _P, _P, _I,
                                _I, _P]),
        "reduce_partitions_lanes_scratch_bytes": (_LL, [_LL, _LL, _I, _I,
                                                        _I]),
        "reduce_partitions_lanes": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL,
                                         _I, _P, _P, _LL, _P, _P, _P, _P, _P,
                                         _I, _I, _P]),
        "reduce_vectors_lanes": (_I, [_P, _P, _P, _P, _LL, _LL, _I, _I, _P,
                                      _P, _I, _I, _P]),
    },
    "release_epilogue": {
        "release_epilogue_plan_bytes": (_LL, []),
        "release_epilogue": (_I, [_P, _P, _LL, _I, _I, _I, _P]),
    },
    "radix_sort": {
        "radix_sort_scratch_bytes": (_LL, [_LL]),
        "radix_sort_varying": (_I, [_P, _P, _I, _LL, _P, _P, _P]),
        "radix_sort": (_I, [_P, _P, _I, _LL, _P, _P, _P, _P, _P]),
    },
    "compact_kept": {
        "compact_kept_blocks_per_sm": (_I, [_I]),
        "compact_kept": (_I, [_P, _P, _P, _P, _P]),
    },
    "quantile_counts": {
        "quantile_leaf_counts": (_I, [_P, _P, _P, _P, _LL, _LL, _I, _I, _D,
                                      _D, _P, _I, _P]),
        "quantile_level_counts": (_I, [_P, _I, _I, _I, _P]),
        "quantile_child_counts": (_I, [_P, _P, _P, _P, _LL, _LL, _I, _I, _I,
                                       _I, _P, _I, _D, _D, _P, _P, _I, _I,
                                       _P]),
    },
    "quantile_descend": {
        "quantile_descend_dense": (_I, [_P, _LL, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _P, _P, _I, _D, _I, _P]),
        "quantile_descend_step": (_I, [_P, _LL, _I, _P, _P, _P, _P, _P, _P,
                                       _U, _U, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _D, _I, _P]),
        "quantile_descend_dense_lanes": (_I, [_P, _LL, _I, _P, _P, _P, _P,
                                              _P, _P, _P, _P, _P, _P, _P, _P,
                                              _I, _D, _I, _P]),
        "quantile_descend_step_lanes": (_I, [_P, _LL, _I, _I, _P, _P, _P, _P,
                                             _P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _P, _P, _P, _I, _D, _I,
                                             _P]),
    },
    "vector_release": {
        "vector_release": (_I, [_P, _LL, _I, _I, _D, _D, _U, _U, _I, _P, _P,
                                _P, _P, _I, _D, _I, _P]),
        "vector_release_lanes": (_I, [_P, _LL, _I, _I, _I, _D, _D, _I, _P,
                                      _P, _P, _P, _P, _I, _D, _I, _P]),
    },
    "block_offsets": {
        "block_offsets": (_I, [_P, _LL, _P, _LL, _P, _P]),
        "block_window_offsets": (_I, [_P, _I, _LL, _LL, _LL, _LL, _P, _P]),
    },
    "gather_rows": {
        "gather_rows": (_I, [_P, _LL, _P, _P, _P, _P, _I, _P]),
    },
    "factorize_codes": {
        "factorize_codes_scratch_bytes": (_LL, [_LL, _LL, _LL]),
        "factorize_codes": (_I, [_P, _LL, _LL, _I, _P, _P, _P, _LL, _P]),
    },
    "lookup_codes": {
        "lookup_codes": (_I, [_P, _LL, _P, _LL, _P, _P, _P]),
    },
    "append_rows": {
        "append_rows": (_I, [_P, _I, _LL, _LL, _LL, _P]),
    },
    "pld_fft": {
        "pld_rfft": (_I, [_P, _LL, _LL, _I, _I, _I, _P, _P, _P]),
        "pld_irfft": (_I, [_P, _LL, _LL, _I, _I, _I, _P, _P, _P]),
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
        "log_bins_int_record_bytes": (_LL, []),
        "log_bins_int_scratch_bytes": (_LL, []),
        "log_bins_int_blocks_per_sm": (_I, []),
        "log_bins_float_blocks_per_sm": (_I, [_I]),
        "log_bins_int": (_I, [_P, _I, _I, _P, _P]),
        "log_bins_float": (_I, [_P, _P, _LL, _I, _F, _I, _P, _P, _P, _P, _P,
                                _P, _P]),
    },
    "sweep_stats": {
        "sweep_stats": (_I, [_P, _P, _P, _P, _LL, _P, _LL, _P, _P, _P, _I,
                             _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P]),
    },
    "sweep_report": {
        "sweep_report_scratch_bytes": (_LL, [_I, _LL, _I, _I, _I]),
        "sweep_report": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                              _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    },
    "combine_shards": {
        "combine_parts": (_I, [_P, _I, _I, _I, _I, _P]),
        "combine_stack": (_I, [_P, _I, _LL, _I, _I, _P, _P]),
    },
    "reshard_count": {
        "reshard_count": (_I, [_P, _P, _LL, _I, _U, _P, _P, _P, _P, _LL,
                               _P]),
    },
    "reshard_exchange": {
        "reshard_exchange": (_I, [_P, _P, _P, _I, _I, _P, _P, _LL, _I, _P,
                                  _P]),
    },
    "mesh_factorize": {
        "mesh_remap_codes": (_I, [_P, _LL, _P, _LL, _P, _P]),
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


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{macro}={value}" for macro, value in
                              DEFINES.get(name, {}).items())


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
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
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
