"""The twenty CUDA kernels of the dense and blocked release and selection
paths, the streamed ingest, the PLD composition, the dataset histograms and
the utility-analysis sweep, their wrappers and their plain PyTorch
versions.

    C1 row_keys           csrc/row_keys.cu           bounding-sort keys + row uniform;
                                                     total-bound keys (total_bound_keys)
    C2 bound_rows         csrc/bound_rows.cu         L0/Linf bounding, row columns;
                                                     total bound (total_bound_rows)
    C3 reduce_partitions  csrc/reduce_partitions.cu  dense partition columns;
                                                     vector sums (D columns)
    C4 release_epilogue   csrc/release_epilogue.cu   selection, noise, metrics, flags
    C5 radix_sort         csrc/radix_sort.cu         stable multi-word LSD radix sort
    C6 compact_kept       csrc/compact_kept.cu       kept-first compaction
    C7 quantile_counts    csrc/quantile_counts.cu    quantile-tree counts: leaf
                                                     histogram, level roll-ups,
                                                     child counts of a level
    C8 quantile_descend   csrc/quantile_descend.cu   node noise + descent (both
                                                     regimes), percentile flags
    C9 vector_release     csrc/vector_release.cu     norm-ball clip, noise, flags
    C10 block_offsets     csrc/block_offsets.cu      row window of every partition
                                                     block (blocked route)
    C11 gather_rows       csrc/gather_rows.cu        columns gathered through one
                                                     index (host-staged survivors)
    C12 factorize_codes   csrc/factorize_codes.cu    first-occurrence codes of key
                                                     hashes (after a C5 sort)
    C13 lookup_codes      csrc/lookup_codes.cu       the same codes by a search of
                                                     the host-merged hash table
    C14 append_rows       csrc/append_rows.cu        the streamed row buffers: pad
                                                     tail fill, growth (fill_tail,
                                                     grow_rows)
    C15 pld_fft           csrc/pld_fft.cu            complex128 rfft / irfft of
                                                     the PLD composition
                                                     (pld_rfft, pld_irfft)
    C16 log_spectrum      csrc/log_spectrum.cu       weighted sum of log spectra,
                                                     its exp (log_spectrum_*)
    C17 group_stats       csrc/group_stats.cu        pair / pid / key statistics
                                                     of C5-sorted rows
                                                     (group_stats_pairs, _keys)
    C18 log_bins          csrc/log_bins.cu           log-binned int and equal-
                                                     width float histograms
                                                     (log_bins_int, _float)
    C19 sweep_stats       csrc/sweep_stats.cu        per-(config, partition)
                                                     sufficient statistics of
                                                     the analysis sweep
    C20 sweep_report      csrc/sweep_report.cu       keep probabilities, report
                                                     rows, bucket sums

The blocked route (parallel/large_p.py) runs C3 and C7 on windows of the
partition-sorted stream: their windowed entries (base=) rebase each row's
partition to skey2 - base, drop what falls outside the block and take a
null perm for a stream already in sorted order. They count under their
own names (reduce_partitions_windowed, quantile_counts_windowed, ...).

Two modes add entries (numeric_mode="safe" and secure_noise=True):

    C3 compensated        reduce_partitions(compensated=True): float32 sums
                          carried as TwoSum (hi, lo) pairs
    C4 / C8 / C9 secure   release_epilogue, quantile_descend_*,
                          vector_release with tables=: snapped discrete
                          noise, the table search pdp::snapped_release of
                          csrc/common.cuh

Each wrapper launches its kernel on the current CUDA stream when its inputs
lie on a CUDA device, and computes the plain version when they lie on the
CPU (the tests' path). On a CUDA tensor it never falls back: a failed build
or launch raises. Outputs and scratch are allocated here with torch; the
kernels allocate nothing. `launch_counts` counts wrapper calls that
launched a kernel, under the name of the kernel's source, or of its
compensated / secure entry (a tile scan issues three CUDA launches; a
radix sort three a pass).
"""

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import cuda_build
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import secure_noise
from pipelinedp_tpu_torch.ops import segment_ops
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry

KERNELS = ("row_keys", "bound_rows", "reduce_partitions", "release_epilogue",
           "radix_sort", "compact_kept", "quantile_counts", "quantile_descend",
           "vector_release", "reduce_partitions_compensated",
           "release_epilogue_secure", "quantile_descend_secure",
           "vector_release_secure", "block_offsets", "gather_rows",
           "reduce_partitions_windowed",
           "reduce_partitions_compensated_windowed",
           "quantile_counts_windowed", "factorize_codes", "lookup_codes",
           "append_rows", "pld_fft", "log_spectrum", "group_stats",
           "log_bins", "sweep_stats", "sweep_report")
launch_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)

PLAN_KINDS = {"count": 0, "privacy_id_count": 1, "sum": 2, "mean": 3,
              "variance": 4}
OUTPUT_BITS = {"count": 1, "privacy_id_count": 2, "sum": 4, "mean": 8,
               "variance": 16}
# Plan entries whose outputs other kernels release (C9, C8): C4 draws no
# noise for them, but their noise slots still count in the slot offsets.
SKIPPED_KINDS = ("vector_sum", "quantiles")
NORM_KINDS = {"linf": 0, "l1": 1, "l2": 2}
_M32 = 0xFFFFFFFF
_INT32_MAX = 0x7FFFFFFF


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one device type, got "
                     f"{sorted(devices)}")


def _check(t: Optional[torch.Tensor], dtype: torch.dtype, n: int,
           what: str) -> None:
    if t is None:
        return
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n or \
            not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous {dtype}[{n}], got "
                         f"{t.dtype}{list(t.shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {status})")


def _f64(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"working dtype must be float32/float64, got {dtype}")
    return int(dtype == torch.float64)


def _check_table(thr: torch.Tensor, rows: Optional[int]) -> None:
    """A packed secure-noise table: int64 [rows, 2K+1] (rows None: one
    slot's [2K+1]), contiguous, of odd length."""
    shape = (thr.shape[-1],) if rows is None else (rows, thr.shape[-1])
    if thr.dtype != torch.int64 or tuple(thr.shape) != shape or \
            not thr.is_contiguous() or thr.shape[-1] % 2 != 1:
        raise ValueError(f"secure table: expected contiguous int64{list(shape)}"
                         f" of odd length, got {thr.dtype}{list(thr.shape)}")


def _clamp0(x: torch.Tensor) -> torch.Tensor:
    """jnp.maximum(x, 0): NaN kept."""
    return torch.where(torch.isnan(x), x, x.clamp(min=0.0))


# ---------------------------------------------------------------------------
# C1 row_keys


def row_keys(pid: torch.Tensor, pk: torch.Tensor, valid: torch.Tensor,
             salts: np.ndarray, key, n_partitions: int,
             dtype: Optional[torch.dtype]
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Bounding-sort keys (k1, k2) and the row uniform u, per row.

    k1 = pid << 32 | hash0 and k2 = (hash1 ^ 2^31) << 32 | pk, with
    invalid rows at pid = INT32_MAX, pk = n_partitions: sorting by
    (k1, k2, u) is the JAX package's sort by (pid, hash0, hash1, pk, u).
    salts: jax.random.bits(key_l0, (4,)); key: key_linf. With dtype None
    no uniform is drawn and u is None (standalone selection).
    """
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(pk, torch.int32, n, "pk")
    _check(valid, torch.bool, n, "valid")
    if not _on_cuda(pid, pk, valid):
        return row_keys_plain(pid, pk, valid, salts, key, n_partitions,
                              dtype)
    k1 = torch.empty(n, dtype=torch.int64, device=pid.device)
    k2 = torch.empty_like(k1)
    u = None if dtype is None else torch.empty(n, dtype=dtype,
                                               device=pid.device)
    salts_c = (ctypes.c_uint * 4)(*[int(s) for s in salts])
    key = (0, 0) if key is None else key
    status = cuda_build.library("row_keys").row_keys(
        _ptr(pid), _ptr(pk), _ptr(valid), n, n_partitions, salts_c,
        int(key[0]), int(key[1]), _ptr(k1), _ptr(k2), _ptr(u),
        0 if dtype is None else _f64(dtype), _stream(pid.device))
    _raise_on(status, "row_keys")
    launch_counts["row_keys"] += 1
    return k1, k2, u


def _hash_mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def pair_hash(pid: torch.Tensor, pk: torch.Tensor, salts: np.ndarray):
    """executor._pair_hash on int64 tensors of uint32 values."""
    s = [int(v) for v in salts]
    h = _hash_mix((pid * 0x9E3779B9 + s[0]) & _M32)
    lane0 = _hash_mix(h ^ _hash_mix((pk + s[1]) & _M32))
    h2 = _hash_mix((pid * 0x85EBCA6B + s[2]) & _M32)
    lane1 = _hash_mix(h2 ^ _hash_mix((pk + s[3]) & _M32))
    return lane0, lane1


def row_keys_plain(pid, pk, valid, salts, key, n_partitions, dtype):
    p = torch.where(valid, pid.to(torch.int64), 0x7FFFFFFF)
    q = torch.where(valid, pk.to(torch.int64), n_partitions)
    lane0, lane1 = pair_hash(p, q, salts)
    k1 = (p << 32) | lane0
    k2 = ((lane1 - 0x80000000) << 32) | q
    u = (None if dtype is None else
         threefry.uniform(key, pid.shape[0], dtype, device=pid.device))
    return k1, k2, u


def total_bound_keys(pid: torch.Tensor, valid: torch.Tensor, key,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The total-bound sort key (C1's second entry): pid_sent = pid where
    valid, INT32_MAX elsewhere, and u = uniform(key_total)[i] of the
    working dtype; sorting by (pid_sent, u) is the JAX package's sort at
    executor.py:370."""
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(valid, torch.bool, n, "valid")
    if not _on_cuda(pid, valid):
        return total_bound_keys_plain(pid, valid, key, dtype)
    pid_sent = torch.empty(n, dtype=torch.int32, device=pid.device)
    u = torch.empty(n, dtype=dtype, device=pid.device)
    status = cuda_build.library("row_keys").total_keys(
        _ptr(pid), _ptr(valid), n, int(key[0]), int(key[1]), _ptr(pid_sent),
        _ptr(u), _f64(dtype), _stream(pid.device))
    _raise_on(status, "row_keys")
    launch_counts["row_keys"] += 1
    return pid_sent, u


def total_bound_keys_plain(pid, valid, key, dtype):
    pid_sent = torch.where(valid, pid, _INT32_MAX).to(torch.int32)
    return pid_sent, threefry.uniform(key, pid.shape[0], dtype,
                                      device=pid.device)


# ---------------------------------------------------------------------------
# C2 bound_rows


def bound_rows(perm: Optional[torch.Tensor], k1: Optional[torch.Tensor],
               k2: Optional[torch.Tensor], pk: torch.Tensor,
               values: Optional[torch.Tensor], valid: torch.Tensor, *,
               n_partitions: int, linf: int, l0: int, clip_per_value: bool,
               clip_pair_sum: bool, scalars: Sequence[float],
               columns: Sequence[str]):
    """Contribution bounding over the row stream in (k1, k2, u) order.

    perm: the sorted order (row index per sorted position). With k1 = k2 =
    perm = None every row is its own pair (contribution bounds already
    enforced) and pk gives its partition. linf: per-pair row cap (0 =
    none); l0: pairs kept per pid (0 = none). scalars = (min_v, max_v,
    min_s, max_s, mid) as Python floats. columns: the reduce columns to
    emit, a subset of ("sum", "nsum", "nsum2"); with values None (standalone
    selection) there are none.

    Returns (key2 int32[n], pair_start bool[n], {column: F[n]}) in sorted
    order; key2 = partition of a kept row, n_partitions otherwise.
    """
    n = valid.shape[0]
    if values is None and columns:
        raise ValueError("bound_rows: columns need values")
    dtype = torch.float32 if values is None else values.dtype
    _f64(dtype)
    for t, dt, what in ((perm, torch.int64, "perm"), (k1, torch.int64, "k1"),
                        (k2, torch.int64, "k2"), (pk, torch.int32, "pk"),
                        (values, dtype, "values"),
                        (valid, torch.bool, "valid")):
        _check(t, dt, n, what)
    if not _on_cuda(perm, k1, k2, pk, values, valid):
        return bound_rows_plain(perm, k1, k2, pk, values, valid,
                                n_partitions=n_partitions, linf=linf, l0=l0,
                                clip_per_value=clip_per_value,
                                clip_pair_sum=clip_pair_sum, scalars=scalars,
                                columns=columns)
    dev = valid.device
    lib = cuda_build.library("bound_rows")
    key2 = torch.empty(n, dtype=torch.int32, device=dev)
    pair_start = torch.empty(n, dtype=torch.bool, device=dev)
    cols = {c: torch.empty(n, dtype=dtype, device=dev) for c in columns}
    scratch = torch.empty(max(1, lib.bound_rows_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    scal = (ctypes.c_double * 5)(*[float(s) for s in scalars])
    status = lib.bound_rows(
        _ptr(perm), _ptr(k1), _ptr(k2), _ptr(pk), _ptr(values), _ptr(valid),
        n, n_partitions, linf, l0, int(clip_per_value), int(clip_pair_sum),
        scal, _ptr(scratch), _ptr(key2), _ptr(pair_start),
        _ptr(cols.get("sum")), _ptr(cols.get("nsum")),
        _ptr(cols.get("nsum2")), _f64(dtype), _stream(dev))
    _raise_on(status, "bound_rows")
    launch_counts["bound_rows"] += 1
    return key2, pair_start, cols


def bound_rows_plain(perm, k1, k2, pk, values, valid, *, n_partitions, linf,
                     l0, clip_per_value, clip_pair_sum, scalars, columns):
    if k1 is None:  # rows are their own pairs
        svalid, sval = valid, values
        spk = torch.where(valid, pk, n_partitions)
        keep = svalid
        new_pair = torch.ones_like(valid)
    else:
        sk1, sk2 = k1[perm], k2[perm]
        svalid = valid[perm]
        sval = None if values is None else values[perm]
        spk = (sk2 & _M32).to(torch.int32)
        new_pair = segment_ops.boundary_mask(sk1, sk2)
        _, rank = segment_ops.segment_starts_and_ids(new_pair)
        row_mask = svalid & (rank < linf) if linf else svalid
        new_pid = segment_ops.boundary_mask(sk1 >> 32)
        pair_rank = segment_ops.segment_rank_of_segments(new_pair, new_pid)
        keep = row_mask & (pair_rank < l0) if l0 else row_mask
    pair_start = new_pair & keep
    key2 = torch.where(keep, spk, n_partitions).to(torch.int32)
    cols = {}
    if not columns:
        return key2, pair_start, cols
    dtype, dev = values.dtype, values.device
    min_v, max_v, min_s, max_s, mid = (
        torch.tensor(s, dtype=dtype, device=dev) for s in scalars)
    clipped = torch.clamp(sval, min_v, max_v) if clip_per_value else sval
    if "sum" in columns:
        contrib = torch.where(keep, clipped, 0.0)
        if clip_pair_sum:
            # Pair totals as segmented sums over each pair's rows.
            pair_id = torch.cumsum(new_pair.to(torch.int64), 0) - 1
            totals = torch.zeros(int(new_pair.sum()), dtype=dtype,
                                 device=dev)
            totals.index_add_(0, pair_id, contrib)
            contrib = torch.where(pair_start,
                                  torch.clamp(totals[pair_id], min_s, max_s),
                                  0.0)
        cols["sum"] = contrib
    if "nsum" in columns:
        centered = torch.where(keep, clipped - mid, 0.0)
        cols["nsum"] = centered
        if "nsum2" in columns:
            cols["nsum2"] = centered * centered
    return key2, pair_start, cols


def total_bound_rows(perm: torch.Tensor, spid: torch.Tensor,
                     pk: torch.Tensor, values: torch.Tensor,
                     valid: torch.Tensor, *, total_bound: int,
                     n_partitions: int):
    """The total contribution bound (C2's second entry).

    perm / spid: the stable sort of total_bound_keys by (pid_sent, u) and
    the sorted pid_sent. Keeps the first total_bound rows of each pid in
    that order. Returns (pid, pk, values, valid) in that order: valid0 =
    valid & rank < total_bound, and pid = INT32_MAX, pk = n_partitions
    where not valid0 (executor.py:371-378 of the JAX package).
    """
    n = valid.shape[0]
    dtype = values.dtype
    _f64(dtype)
    for t, dt, what in ((perm, torch.int64, "perm"),
                        (spid, torch.int32, "spid"), (pk, torch.int32, "pk"),
                        (values, dtype, "values"),
                        (valid, torch.bool, "valid")):
        _check(t, dt, n, what)
    if not _on_cuda(perm, spid, pk, values, valid):
        return total_bound_rows_plain(perm, spid, pk, values, valid,
                                      total_bound=total_bound,
                                      n_partitions=n_partitions)
    dev = valid.device
    lib = cuda_build.library("bound_rows")
    pid_out = torch.empty(n, dtype=torch.int32, device=dev)
    pk_out = torch.empty(n, dtype=torch.int32, device=dev)
    values_out = torch.empty(n, dtype=dtype, device=dev)
    valid_out = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = torch.empty(max(1, lib.bound_rows_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    status = lib.total_bound_rows(
        _ptr(perm), _ptr(spid), _ptr(pk), _ptr(values), _ptr(valid), n,
        total_bound, n_partitions, _ptr(scratch), _ptr(pid_out),
        _ptr(pk_out), _ptr(values_out), _ptr(valid_out), _f64(dtype),
        _stream(dev))
    _raise_on(status, "bound_rows")
    launch_counts["bound_rows"] += 1
    return pid_out, pk_out, values_out, valid_out


def total_bound_rows_plain(perm, spid, pk, values, valid, *, total_bound,
                           n_partitions):
    _, rank = segment_ops.segment_starts_and_ids(
        segment_ops.boundary_mask(spid))
    valid0 = valid[perm] & (rank < total_bound)
    return (torch.where(valid0, spid, _INT32_MAX).to(torch.int32),
            torch.where(valid0, pk[perm], n_partitions).to(torch.int32),
            values[perm], valid0)


# ---------------------------------------------------------------------------
# C3 reduce_partitions


def reduce_partitions(skey2: torch.Tensor, perm: Optional[torch.Tensor],
                      pair_start: torch.Tensor,
                      row_cols: Dict[str, torch.Tensor],
                      n_partitions: int, dtype: torch.dtype,
                      vector_rows: Optional[Tuple[Optional[torch.Tensor],
                                                  torch.Tensor]] = None,
                      compensated: bool = False,
                      base: Optional[int] = None):
    """Dense per-partition columns from rows sorted by key2.

    skey2: key2 sorted ascending; perm: bounded-row index per sorted
    position; row_cols: the bounded rows' sum / nsum / nsum2. vector_rows:
    (row_perm, values[n0, D]) for VECTOR_SUM, where the bounded row at
    position r is values[row_perm[r]] (row_perm None: values[r]); the D
    coordinates are gathered through both permutations, no bounded copy is
    written. Returns {count, pid_count, [sum, nsum, nsum2], [vsum]} as
    dtype[n_partitions] (vsum dtype[n_partitions, D]).

    base (the windowed entry, the blocked route's block): skey2 and perm
    are a window of the sorted stream, row i belongs to partition
    skey2[i] - base, and rows outside [0, n_partitions) are dropped.
    perm None: the rows are in sorted order already, and pair_start,
    row_cols and the vector rows are windows of the same length.

    compensated (numeric_mode="safe"): float32 sums are carried as TwoSum
    (hi, lo) pairs and emitted as hi + lo rounded once, exact for
    integer-valued sums to ~2^48; an overflowed sum is Inf, never NaN.
    float64 sums take the plain entry, as the JAX package's do
    (segment_ops.py:132-133).
    """
    compensated = compensated and dtype == torch.float32
    n = skey2.shape[0]
    _check(skey2, torch.int32, n, "skey2")
    _check(perm, torch.int64, n, "perm")
    # The bounded rows: perm's values index them (length n without perm).
    n_rows = n if perm is None else pair_start.shape[0]
    _check(pair_start, torch.bool, n_rows, "pair_start")
    for name, col in row_cols.items():
        _check(col, dtype, n_rows, name)
    row_perm, vec = vector_rows if vector_rows is not None else (None, None)
    if vec is not None:
        _check(row_perm, torch.int64, n_rows, "row_perm")
        if vec.dtype != dtype or vec.dim() != 2 or not vec.is_contiguous() \
                or (perm is None and row_perm is None and vec.shape[0] != n):
            raise ValueError(f"vector values: expected contiguous "
                             f"{dtype}[n, D], got {vec.dtype}"
                             f"{list(vec.shape)}")
    if not _on_cuda(skey2, perm, pair_start, row_perm, vec,
                    *row_cols.values()):
        return reduce_partitions_plain(skey2, perm, pair_start, row_cols,
                                       n_partitions, dtype, vector_rows,
                                       compensated, base)
    dev = skey2.device
    lib = cuda_build.library("reduce_partitions")
    out = {name: torch.zeros(n_partitions, dtype=dtype, device=dev)
           for name in ("count", "pid_count", *row_cols)}
    scratch = torch.empty(
        max(1, lib.reduce_partitions_scratch_bytes(n, _f64(dtype),
                                                   int(compensated))),
        dtype=torch.uint8, device=dev)
    status = lib.reduce_partitions(
        _ptr(skey2), _ptr(perm), _ptr(pair_start), _ptr(row_cols.get("sum")),
        _ptr(row_cols.get("nsum")), _ptr(row_cols.get("nsum2")), n,
        n_partitions, int(base or 0), _ptr(scratch), _ptr(out["count"]),
        _ptr(out["pid_count"]), _ptr(out.get("sum")), _ptr(out.get("nsum")),
        _ptr(out.get("nsum2")), _f64(dtype), int(compensated), _stream(dev))
    _raise_on(status, "reduce_partitions")
    if vec is not None:
        dim = vec.shape[1]
        out["vsum"] = torch.zeros(n_partitions, dim, dtype=dtype, device=dev)
        vscratch = torch.empty(
            max(1, lib.reduce_vectors_scratch_bytes(n, _f64(dtype),
                                                    int(compensated))),
            dtype=torch.uint8, device=dev)
        status = lib.reduce_vectors(
            _ptr(skey2), _ptr(perm), _ptr(row_perm), _ptr(vec), n, dim,
            n_partitions, int(base or 0), _ptr(vscratch), _ptr(out["vsum"]),
            _f64(dtype), int(compensated), _stream(dev))
        _raise_on(status, "reduce_partitions")
    name = ("reduce_partitions_compensated" if compensated else
            "reduce_partitions")
    launch_counts[name if base is None else f"{name}_windowed"] += 1
    return out


def reduce_partitions_plain(skey2, perm, pair_start, row_cols, n_partitions,
                            dtype, vector_rows=None, compensated=False,
                            base=None):
    slots = n_partitions + 1  # slot n_partitions collects dropped rows
    rel = skey2.to(torch.int64) - (base or 0)
    key = torch.where((rel >= 0) & (rel < n_partitions), rel, n_partitions)
    compensated = compensated and dtype == torch.float32
    if compensated:
        # The JAX package's safe mode: compensated prefixes over the
        # partition-sorted rows, differenced at the partition starts.
        starts = torch.searchsorted(
            rel, torch.arange(n_partitions + 1, device=rel.device))

    def segment_sum(values):
        if compensated and values.is_floating_point():
            cols = values.reshape(values.shape[0], -1)
            sums = [segment_ops.compensated_segment_diff(
                *segment_ops.compensated_cumsum(cols[:, d].contiguous()),
                starts) for d in range(cols.shape[1])]
            return torch.stack(sums, 1).reshape(
                (n_partitions,) + values.shape[1:])
        out = torch.zeros((slots,) + values.shape[1:], dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, key, values)[:n_partitions]

    def take(a):
        return a if perm is None else a[perm]

    out = {
        "count": segment_sum(torch.ones(skey2.shape[0], dtype=torch.int64,
                                        device=skey2.device)).to(dtype),
        "pid_count": segment_sum(take(pair_start).to(torch.int64)).to(dtype),
    }
    for name, col in row_cols.items():
        out[name] = segment_sum(take(col))
    if vector_rows is not None:
        out["vsum"] = segment_sum(sorted_rows(perm, *vector_rows))
    return out


def sorted_rows(perm: Optional[torch.Tensor],
                row_perm: Optional[torch.Tensor],
                values: torch.Tensor) -> torch.Tensor:
    """The values of the rows in partition-sorted order: sorted position i
    holds bounded row perm[i], which is values[row_perm[perm[i]]] (a None
    permutation is the identity)."""
    if perm is None:
        return values if row_perm is None else values[row_perm]
    return values[perm if row_perm is None else row_perm[perm]]


# ---------------------------------------------------------------------------
# C4 release_epilogue


def release_epilogue(cols: Dict[str, torch.Tensor],
                     plan: Sequence[Tuple[str, Tuple[str, ...], int]],
                     stds: np.ndarray, slot_keys: np.ndarray,
                     noise_kind: NoiseKind, degenerate: bool, mid: float,
                     min_v: float,
                     selection: Optional[selection_ops.SelectionParams],
                     key_sel, max_rows: int, tables=None):
    """Selection, noise, metric formulas and the sentinel flag word.

    cols: dense count / pid_count / [sum, nsum, nsum2] of the working
    dtype. plan: (kind, outputs, std offset) per metric entry, in
    executor.build_plan order; entries of SKIPPED_KINDS are released by
    C8 / C9 and skipped here. stds / slot_keys: the noise std and threefry
    key of every slot (slot_keys[s] = fold_in(fold_in(key_noise, entry),
    sub)). selection: None for public partitions. tables (secure noise):
    (thr int64[S, 2K+1], gran float64[S]), the packed table and grid of
    every slot; slot s then releases snap(col) + atom * gran[s], the atom
    searched with the words of split(slot_keys[s]) at element p.

    Returns (keep bool[P], {output: F[P]}, flags int32[1]): the flag word
    (numeric.FLAG_*) over the kept partitions' outputs.
    """
    count = cols["count"]
    p = count.shape[0]
    dtype = count.dtype
    scalar_cols = {k: c for k, c in cols.items() if k != "vsum"}
    for name, col in scalar_cols.items():
        _check(col, dtype, p, name)
    plan = [entry for entry in plan if entry[0] not in SKIPPED_KINDS]
    names = [o for _, outputs, _ in plan for o in outputs]
    if tables is not None:
        _check_table(tables[0], len(stds))
    if not _on_cuda(*scalar_cols.values(),
                    None if tables is None else tables[0]):
        return release_epilogue_plain(cols, plan, stds, slot_keys,
                                      noise_kind, degenerate, mid, min_v,
                                      selection, key_sel, max_rows, tables)
    dev = count.device
    keep = torch.empty(p, dtype=torch.bool, device=dev)
    outputs = {o: torch.empty(p, dtype=dtype, device=dev) for o in names}
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    plan_c = (ctypes.c_int * (3 * len(plan)))(*[
        v for kind, outs, off in plan
        for v in (PLAN_KINDS[kind], sum(OUTPUT_BITS[o] for o in outs), off)
    ])
    stds_c = (ctypes.c_double * len(stds))(*[float(s) for s in stds])
    keys_c = (ctypes.c_uint * (2 * len(stds)))(
        *[int(w) for w in np.asarray(slot_keys).reshape(-1)])
    sel = (selection_ops.selection_scalars(selection)
           if selection is not None else (0.0,) * 14)
    sel_c = (ctypes.c_double * 14)(*sel)
    ksel = key_sel if key_sel is not None else (0, 0)
    key_sel_c = (ctypes.c_uint * 2)(int(ksel[0]), int(ksel[1]))
    misc_c = (ctypes.c_int * 3)(int(noise_kind == NoiseKind.GAUSSIAN),
                                int(degenerate), int(selection is not None))
    scal_c = (ctypes.c_double * 3)(float(mid), float(min_v), float(max_rows))
    secure = tables is not None
    gran_c = (ctypes.c_double * len(stds))(
        *([float(g) for g in tables[1]] if secure else [0.0] * len(stds)))
    status = cuda_build.library("release_epilogue").release_epilogue(
        plan_c, len(plan), stds_c, keys_c, len(stds), sel_c, key_sel_c,
        misc_c, scal_c, p, _ptr(count), _ptr(cols["pid_count"]),
        _ptr(cols.get("sum")), _ptr(cols.get("nsum")),
        _ptr(cols.get("nsum2")), _ptr(keep), _ptr(outputs.get("count")),
        _ptr(outputs.get("privacy_id_count")), _ptr(outputs.get("sum")),
        _ptr(outputs.get("mean")), _ptr(outputs.get("variance")),
        _ptr(flags), _ptr(tables[0]) if secure else None,
        tables[0].shape[-1] if secure else 0, gran_c, _f64(dtype),
        _stream(dev))
    _raise_on(status, "release_epilogue")
    launch_counts["release_epilogue_secure" if secure else
                  "release_epilogue"] += 1
    return keep, outputs, flags


def release_epilogue_plain(cols, plan, stds, slot_keys, noise_kind,
                           degenerate, mid, min_v, selection, key_sel,
                           max_rows, tables=None):
    count = cols["count"]
    p, dtype, dev = count.shape[0], count.dtype, count.device
    if selection is not None:
        est = torch.ceil(cols["pid_count"] / torch.tensor(
            max_rows, dtype=dtype, device=dev)).to(torch.int64)
        keep = selection_ops.sample_keep_decisions(key_sel, est, selection,
                                                   dtype)
    else:
        keep = torch.ones(p, dtype=torch.bool, device=dev)
    mid_t = torch.tensor(mid, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)

    def noised(col, slot):
        if tables is not None:
            return secure_noise.snapped_noisy(col, slot_keys[slot],
                                              tables[0][slot],
                                              float(tables[1][slot]))
        std = torch.tensor(float(stds[slot]), dtype=dtype, device=dev)
        return col + noise_ops.additive_noise(slot_keys[slot], p, std,
                                              noise_kind)

    outputs = {}
    for kind, outs, off in plan:
        if kind in SKIPPED_KINDS:
            continue
        if kind == "count":
            outputs["count"] = noised(count, off)
        elif kind == "privacy_id_count":
            outputs["privacy_id_count"] = noised(cols["pid_count"], off)
        elif kind == "sum":
            outputs["sum"] = noised(cols["sum"], off)
        elif kind == "mean":
            dp_count = noised(count, off)
            dp_nsum = noised(cols["nsum"], off + 1)
            dp_mean = mid_t + dp_nsum / torch.maximum(dp_count, one)
            outputs["mean"] = dp_mean
            if "count" in outs:
                outputs["count"] = dp_count
            if "sum" in outs:
                outputs["sum"] = dp_mean * dp_count
        elif kind == "variance":
            dp_count = noised(count, off)
            denom = torch.maximum(dp_count, one)
            if degenerate:
                nmean = torch.full_like(count, min_v)
                nsqmean = nmean * nmean
            else:
                nmean = noised(cols["nsum"], off + 1) / denom
                nsqmean = noised(cols["nsum2"], off + 2) / denom
            dp_mean = nmean + (0.0 if degenerate else mid_t)
            outputs["variance"] = nsqmean - nmean * nmean
            if "mean" in outs:
                outputs["mean"] = dp_mean
            if "count" in outs:
                outputs["count"] = dp_count
            if "sum" in outs:
                outputs["sum"] = dp_mean * dp_count
        else:
            raise NotImplementedError(f"plan entry {kind!r}")
    flags = torch.tensor([numeric.flags_from_mask(outputs, keep)],
                         dtype=torch.int32, device=dev)
    return keep, outputs, flags


# ---------------------------------------------------------------------------
# C5 radix_sort

_SORT_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}


def radix_sort(words: Sequence[torch.Tensor], sorted_top: bool = False):
    """The stable permutation sorting rows by `words`, most significant
    first (1 to 3 int32 / int64 / float32 / float64 columns of one length).

    Integers sort by value; floats by value with -0.0 before +0.0 (the
    sorts of the port see no negative zero or NaN). Returns perm int64[n],
    or (perm, words[0][perm]) with sorted_top.
    """
    if not 1 <= len(words) <= 3:
        raise ValueError(f"radix_sort takes 1 to 3 key words, got "
                         f"{len(words)}")
    n = words[0].shape[0]
    for j, word in enumerate(words):
        if word.dtype not in _SORT_KINDS:
            raise ValueError(f"radix_sort: word {j} has dtype {word.dtype}")
        _check(word, word.dtype, n, f"word {j}")
    if not _on_cuda(*words):
        return radix_sort_plain(words, sorted_top)
    if n >= 1 << 31:
        raise ValueError(f"radix_sort: {n} rows exceed 2^31")
    dev = words[0].device
    lib = cuda_build.library("radix_sort")
    ptrs = (ctypes.c_void_p * len(words))(*[w.data_ptr() for w in words])
    kinds = (ctypes.c_int * len(words))(*[_SORT_KINDS[w.dtype]
                                          for w in words])
    stream = _stream(dev)
    masks = torch.zeros(len(words), dtype=torch.int64, device=dev)
    _raise_on(lib.radix_sort_varying(ptrs, kinds, len(words), n, _ptr(masks),
                                     stream), "radix_sort")
    # One small copy: the number of passes follows the bits that vary.
    host_masks = (ctypes.c_ulonglong * len(words))(
        *[m & 0xFFFFFFFFFFFFFFFF for m in masks.cpu().tolist()])
    scratch = torch.empty(max(1, lib.radix_sort_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    top = torch.empty_like(words[0]) if sorted_top else None
    _raise_on(lib.radix_sort(ptrs, kinds, len(words), n, host_masks,
                             _ptr(scratch), _ptr(perm), _ptr(top), stream),
              "radix_sort")
    launch_counts["radix_sort"] += 1
    return (perm, top) if sorted_top else perm


def radix_sort_plain(words, sorted_top=False):
    perm = torch.arange(words[0].shape[0], device=words[0].device)
    for word in reversed(words):
        perm = perm[torch.argsort(word[perm], stable=True)]
    return (perm, words[0][perm]) if sorted_top else perm


# ---------------------------------------------------------------------------
# C6 compact_kept


def compact_kept(keep: torch.Tensor, columns: Dict[str, torch.Tensor]):
    """Kept-first compaction: order holds the kept ids ascending, then the
    dropped ids ascending (argsort(~keep, stable=True); its kept prefix is
    nonzero(keep)), and every column is gathered into that order. A column
    is [P] or [P, D] (a vector per partition, gathered whole).

    Returns (n_kept int64[], order int64[P], {name: column in order}).
    """
    p = keep.shape[0]
    _check(keep, torch.bool, p, "keep")
    elem = {c.element_size() for c in columns.values()}
    for name, col in columns.items():
        if col.dim() not in (1, 2) or col.shape[0] != p or \
                not col.is_contiguous():
            raise ValueError(f"{name}: expected contiguous [{p}] or "
                             f"[{p}, D], got {list(col.shape)}")
    if len(elem) > 1 or not elem <= {4, 8}:
        raise ValueError(f"compact_kept: columns must share a 4- or 8-byte "
                         f"dtype, got {[c.dtype for c in columns.values()]}")
    if not _on_cuda(keep, *columns.values()):
        return compact_kept_plain(keep, columns)
    dev = keep.device
    lib = cuda_build.library("compact_kept")
    out = {name: torch.empty_like(col) for name, col in columns.items()}
    order = torch.empty(p, dtype=torch.int64, device=dev)
    n_kept = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(max(1, lib.compact_kept_scratch_bytes(p)),
                          dtype=torch.uint8, device=dev)
    in_c = (ctypes.c_void_p * len(columns))(
        *[c.data_ptr() for c in columns.values()])
    out_c = (ctypes.c_void_p * len(columns))(
        *[out[name].data_ptr() for name in columns])
    widths = (ctypes.c_int * len(columns))(
        *[1 if c.dim() == 1 else c.shape[1] for c in columns.values()])
    status = lib.compact_kept(_ptr(keep), p, in_c, out_c, widths,
                              len(columns), elem.pop() if elem else 8,
                              _ptr(scratch), _ptr(order), _ptr(n_kept),
                              _stream(dev))
    _raise_on(status, "compact_kept")
    launch_counts["compact_kept"] += 1
    return n_kept, order, out


def compact_kept_plain(keep, columns):
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return keep.sum(), order, {n: c[order] for n, c in columns.items()}


# ---------------------------------------------------------------------------
# C7 quantile_counts


def leaf_indices(values: torch.Tensor, min_v: float, max_v: float,
                 n_leaves: int) -> torch.Tensor:
    """The quantile-tree leaf of each value (executor._leaf_indices of the
    JAX package, :270): trunc((v - min) / span * L) clipped to [0, L). The
    float-to-int conversion saturates and maps NaN to 0, as XLA's does;
    clamping to [-1, L] before truncating gives the same leaf."""
    dtype = values.dtype
    lo = torch.tensor(min_v, dtype=dtype, device=values.device)
    span = torch.tensor(max_v, dtype=dtype, device=values.device) - lo
    frac = (values - lo) / torch.where(span > 0, span, torch.ones_like(span))
    x = frac * n_leaves
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    leaf = x.clamp(-1.0, float(n_leaves)).to(torch.int64)
    return leaf.clamp(0, n_leaves - 1)


def _check_rows(skey2, perm, row_perm, values):
    """skey2 / perm: the sorted rows (perm None: already in order);
    row_perm and values are indexed through them, so only a stream with
    neither permutation fixes their length."""
    n = skey2.shape[0]
    _check(skey2, torch.int32, n, "skey2")
    _check(perm, torch.int64, n, "perm")
    if row_perm is not None:
        _check(row_perm, torch.int64, row_perm.shape[0], "row_perm")
    n_values = n if perm is None and row_perm is None else values.shape[0]
    _check(values, values.dtype, n_values, "values")
    _f64(values.dtype)


def _quantile_counts_name(base: Optional[int]) -> str:
    return "quantile_counts" if base is None else "quantile_counts_windowed"


def _kept_leaves(skey2, perm, row_perm, values, n_partitions, n_leaves,
                 min_v, max_v, base=None):
    """(partition, leaf) of every kept row, in partition-sorted order."""
    rel = skey2.to(torch.int64) - (base or 0)
    kept = (rel >= 0) & (rel < n_partitions)
    leaf = leaf_indices(sorted_rows(perm, row_perm, values), min_v, max_v,
                        n_leaves)
    return rel[kept], leaf[kept]


def quantile_leaf_counts(skey2: torch.Tensor, perm: Optional[torch.Tensor],
                         row_perm: Optional[torch.Tensor],
                         values: torch.Tensor, *, n_partitions: int,
                         n_leaves: int, min_v: float, max_v: float,
                         base: Optional[int] = None) -> torch.Tensor:
    """C7 (a): the leaf histogram int32[P, L] of the kept rows.

    Rows come in partition-sorted order (C5's perm / skey2 after C2); the
    value of sorted row i is values[row_perm[perm[i]]] (row_perm None:
    values[perm[i]]), unclipped, and its leaf is leaf_indices(value).
    Integer counts: exact and independent of the order of the additions.
    base (the windowed entry, one block of the blocked route): sorted row
    i belongs to partition skey2[i] - base, rows outside [0, P) count
    nowhere, and perm may be None (rows in sorted order already).
    """
    _check_rows(skey2, perm, row_perm, values)
    if not _on_cuda(skey2, perm, row_perm, values):
        return quantile_leaf_counts_plain(
            skey2, perm, row_perm, values, n_partitions=n_partitions,
            n_leaves=n_leaves, min_v=min_v, max_v=max_v, base=base)
    dev = skey2.device
    hist = torch.zeros(n_partitions, n_leaves, dtype=torch.int32, device=dev)
    status = cuda_build.library("quantile_counts").quantile_leaf_counts(
        _ptr(skey2), _ptr(perm), _ptr(row_perm), _ptr(values),
        skey2.shape[0], int(base or 0), n_partitions, n_leaves, float(min_v),
        float(max_v), _ptr(hist), _f64(values.dtype), _stream(dev))
    _raise_on(status, "quantile_counts")
    launch_counts[_quantile_counts_name(base)] += 1
    return hist


def quantile_leaf_counts_plain(skey2, perm, row_perm, values, *,
                               n_partitions, n_leaves, min_v, max_v,
                               base=None):
    p, leaf = _kept_leaves(skey2, perm, row_perm, values, n_partitions,
                           n_leaves, min_v, max_v, base)
    hist = torch.bincount(p * n_leaves + leaf,
                          minlength=n_partitions * n_leaves)
    return hist.to(torch.int32).reshape(n_partitions, n_leaves)


def quantile_level_counts(leaf_counts: torch.Tensor, *, tree_height: int,
                          branching: int) -> List[torch.Tensor]:
    """C7 (b): the counts of every tree level from the leaf histogram.

    Returns levels[l - 1] = int32[P, B^l] for l = 1..h; levels[h - 1] is
    leaf_counts itself. Node j of level l is the int32 sum of nodes
    j*B .. j*B + B - 1 of level l + 1: exact, as the JAX package's
    reshape(...).sum(-1) roll-ups are.
    """
    p = leaf_counts.shape[0]
    n_leaves = branching**tree_height
    if leaf_counts.dtype != torch.int32 or \
            tuple(leaf_counts.shape) != (p, n_leaves) or \
            not leaf_counts.is_contiguous():
        raise ValueError(f"leaf_counts: expected contiguous int32[{p}, "
                         f"{n_leaves}], got {leaf_counts.dtype}"
                         f"{list(leaf_counts.shape)}")
    if not _on_cuda(leaf_counts):
        return quantile_level_counts_plain(leaf_counts,
                                           tree_height=tree_height,
                                           branching=branching)
    dev = leaf_counts.device
    levels = [torch.empty(p, branching**l, dtype=torch.int32, device=dev)
              for l in range(1, tree_height)] + [leaf_counts]
    ptrs = (ctypes.c_void_p * tree_height)(*[t.data_ptr() for t in levels])
    status = cuda_build.library("quantile_counts").quantile_level_counts(
        ptrs, p, tree_height, branching, _stream(dev))
    _raise_on(status, "quantile_counts")
    launch_counts["quantile_counts"] += 1
    return levels


def quantile_level_counts_plain(leaf_counts, *, tree_height, branching):
    p = leaf_counts.shape[0]
    levels = [leaf_counts]
    for l in range(tree_height - 1, 0, -1):
        levels.append(levels[-1].reshape(p, branching**l, branching).sum(
            -1, dtype=torch.int32))
    return levels[::-1]


def quantile_child_counts(skey2: torch.Tensor, perm: Optional[torch.Tensor],
                          row_perm: Optional[torch.Tensor],
                          values: torch.Tensor, node: torch.Tensor, *,
                          level: int, tree_height: int, branching: int,
                          min_v: float, max_v: float,
                          base: Optional[int] = None) -> torch.Tensor:
    """C7 (c): for every partition p and quantile q, the counts of the B
    children at `level` (1..h) of node[p, q] (a node of level - 1), over
    the kept rows whose level-`level` node lies under it: int32[P, n_q, B].
    One pass over the rows serves every quantile; the counts equal the JAX
    package's per-quantile segment sums (_lazy_quantile_outputs, :796).
    base: the windowed entry, as for quantile_leaf_counts.
    """
    _check_rows(skey2, perm, row_perm, values)
    p, n_q = node.shape
    if node.dtype != torch.int32 or not node.is_contiguous():
        raise ValueError(f"node: expected contiguous int32[P, n_q], got "
                         f"{node.dtype}{list(node.shape)}")
    if not 1 <= level <= tree_height:
        raise ValueError(f"level {level} outside 1..{tree_height}")
    if not _on_cuda(skey2, perm, row_perm, values, node):
        return quantile_child_counts_plain(
            skey2, perm, row_perm, values, node, level=level,
            tree_height=tree_height, branching=branching, min_v=min_v,
            max_v=max_v, base=base)
    dev = skey2.device
    counts = torch.zeros(p, n_q, branching, dtype=torch.int32, device=dev)
    status = cuda_build.library("quantile_counts").quantile_child_counts(
        _ptr(skey2), _ptr(perm), _ptr(row_perm), _ptr(values),
        skey2.shape[0], int(base or 0), p, branching**tree_height,
        branching**(tree_height - level), branching, _ptr(node), n_q,
        float(min_v), float(max_v), _ptr(counts), _f64(values.dtype),
        _stream(dev))
    _raise_on(status, "quantile_counts")
    launch_counts[_quantile_counts_name(base)] += 1
    return counts


def quantile_child_counts_plain(skey2, perm, row_perm, values, node, *,
                                level, tree_height, branching, min_v, max_v,
                                base=None):
    p_all, n_q = node.shape
    p, leaf = _kept_leaves(skey2, perm, row_perm, values, p_all,
                           branching**tree_height, min_v, max_v, base)
    row_node = leaf // branching**(tree_height - level)
    match = node.to(torch.int64)[p] == (row_node // branching)[:, None]
    slot = ((p[:, None] * n_q + torch.arange(n_q, device=p.device)) *
            branching + (row_node % branching)[:, None])
    counts = torch.bincount(slot[match], minlength=p_all * n_q * branching)
    return counts.to(torch.int32).reshape(p_all, n_q, branching)


# ---------------------------------------------------------------------------
# C8 quantile_descend


class DescentState:
    """Per (partition, quantile) state of the lazy descent between levels:
    the node reached (int32, a node of the last level descended), the
    remaining target rank, the tree's noisy total and the noisy count of
    the node reached (dtype)."""

    def __init__(self, n_partitions: int, n_q: int, dtype: torch.dtype,
                 device):
        shape = (n_partitions, n_q)
        self.node = torch.zeros(shape, dtype=torch.int32, device=device)
        self.target = torch.zeros(shape, dtype=dtype, device=device)
        self.total = torch.zeros(shape, dtype=dtype, device=device)
        self.mass = torch.zeros(shape, dtype=dtype, device=device)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from 0, left to right: XLA's order on the
    CPU for reduce and for cumsum's reduce_window."""
    acc = torch.zeros_like(x[..., 0])
    for b in range(x.shape[-1]):
        acc = acc + x[..., b]
    return acc


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[..., 0])
    out = []
    for b in range(x.shape[-1]):
        acc = acc + x[..., b]
        out.append(acc)
    return torch.stack(out, -1)


def _noise_scale(std: float, dtype, gaussian: bool) -> torch.Tensor:
    s = torch.tensor(std, dtype=dtype)
    return s if gaussian else s / torch.sqrt(torch.tensor(2.0, dtype=dtype))


def _noisy_children(counts: torch.Tensor, draws: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """max(count + draw * scale, 0), NaN kept (jnp.maximum)."""
    return _clamp0(counts.to(draws.dtype) + draws * scale.to(draws.device))


def _descend_step(children: torch.Tensor, state: DescentState, level: int,
                  quantiles: Sequence[float]) -> None:
    """One level of the JAX package's _descend_trees (:652), in place:
    children = the noisy, clamped counts [P, n_q, B] of state.node's
    children."""
    dtype, dev = children.dtype, children.device
    B = children.shape[-1]
    tiny = torch.tensor(1e-12, dtype=dtype, device=dev)
    if level == 1:
        q = torch.tensor(list(quantiles), dtype=dtype, device=dev)
        state.total = _seq_sum(children)
        state.target = q * state.total
    else:
        state.target = state.target / torch.maximum(state.mass, tiny) * \
            _seq_sum(children)
    cum = _seq_cumsum(children)
    child = torch.minimum((cum < state.target[..., None]).sum(-1),
                          torch.tensor(B - 1, device=dev))
    before = torch.where(
        child > 0, torch.gather(cum, -1, (child - 1).clamp(min=0)[..., None])
        [..., 0], torch.zeros((), dtype=dtype, device=dev))
    state.target = state.target - before
    state.node = (state.node.to(torch.int64) * B + child).to(torch.int32)
    state.mass = torch.gather(children, -1, child[..., None])[..., 0]


def _descend_values(state: DescentState, n_leaves: int, min_v: float,
                    max_v: float) -> torch.Tensor:
    """The percentile of each (partition, quantile) after the last level:
    leaf interpolation, or the range's middle where the total is <= 0."""
    dtype, dev = state.target.dtype, state.target.device
    lo = torch.tensor(min_v, dtype=dtype, device=dev)
    hi = torch.tensor(max_v, dtype=dtype, device=dev)
    width = (hi - lo) / n_leaves
    mid = lo + (hi - lo) / 2
    leaf_count = torch.maximum(state.mass,
                               torch.tensor(1e-12, dtype=dtype, device=dev))
    leaf_lo = lo + state.node.to(dtype) * width
    frac = torch.minimum(torch.maximum(state.target / leaf_count,
                                       torch.zeros((), dtype=dtype,
                                                   device=dev)),
                         torch.ones((), dtype=dtype, device=dev))
    value = torch.minimum(torch.maximum(leaf_lo + frac * width, lo), hi)
    return torch.where(state.total <= 0, mid, value)


def _finish_quantiles(values: torch.Tensor, quantiles: Sequence[float],
                      keep: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """cummax over the quantiles in ascending order (stable), then the
    columns as [n_q, P] and their flag bits over the kept partitions ORed
    into flags."""
    order = np.argsort(np.asarray(quantiles), kind="stable")
    mono = torch.cummax(values[:, torch.as_tensor(order)], dim=1).values
    out = torch.empty_like(values)
    out[:, torch.as_tensor(order)] = mono
    out = out.t().contiguous()
    flags |= numeric.column_flags(out.t(), keep)
    return out


def _check_descend(keep, flags, quantiles, tree_height, branching):
    """The tree's shape limits hold on both paths, so the card and the CPU
    serve the same requests; DPEngine.aggregate always builds the default
    tree (height 4, branching 16)."""
    _check(flags, torch.int32, 1, "flags")
    if not quantiles or not 1 <= tree_height <= 8 or \
            not 2 <= branching <= 64:
        raise ValueError(f"quantile_descend takes at least one quantile, "
                         f"height 1-8 and branching 2-64, got "
                         f"{len(quantiles)}, {tree_height}, {branching}")
    _check(keep, torch.bool, keep.shape[0], "keep")


def _descend_params(quantiles, std, gaussian, min_v, max_v, tree_height,
                    branching, n_q, device):
    """C8's parameters: the quantiles and their stable ascending order as
    device arrays (any number of quantiles), the scalars on the host."""
    order = np.argsort(np.asarray(quantiles), kind="stable")
    return (torch.tensor([float(q) for q in quantiles], dtype=torch.float64,
                         device=device),
            torch.tensor(order, dtype=torch.int32, device=device),
            (ctypes.c_double * 3)(float(std), float(min_v), float(max_v)),
            (ctypes.c_int * 4)(n_q, tree_height, branching, int(gaussian)))


def quantile_descend_dense(levels: Sequence[torch.Tensor],
                           quantiles: Sequence[float], *, std: float,
                           level_keys: np.ndarray, gaussian: bool,
                           min_v: float, max_v: float, keep: torch.Tensor,
                           flags: torch.Tensor, dtype: torch.dtype,
                           leaves: Optional[torch.Tensor] = None,
                           tables=None) -> torch.Tensor:
    """C8, dense regime (quantile_outputs of the JAX package, :846-905):
    every (partition, quantile) descends its tree through all levels in
    one launch. levels: C7 (b)'s counts; node j of level l draws its noise
    at counter p * B^l + j under level_keys[l - 1] (the words JAX draws for
    the whole level, computed only for the visited nodes). Returns the
    percentiles as dtype[n_q, P] (quantile j's column is row j) and ORs
    their flag bits over the kept partitions into flags; leaves (int32[P,
    n_q], optional) receives the leaf each walk ends at. tables (secure
    noise): (thr int64[2K+1], gran), the quantile slot's packed table and
    grid; a node's count is then snapped and noised with the words of
    split(level_keys[l - 1]) at the same counter (:885-893).
    """
    tree_height = len(levels)
    p = levels[0].shape[0]
    branching = levels[0].shape[1]
    _check_descend(keep, flags, quantiles, tree_height, branching)
    _f64(dtype)
    for l, t in enumerate(levels, 1):
        if t.dtype != torch.int32 or tuple(t.shape) != (p, branching**l) or \
                not t.is_contiguous():
            raise ValueError(f"level {l}: expected int32[{p}, "
                             f"{branching**l}], got {t.dtype}"
                             f"{list(t.shape)}")
    n_q = len(quantiles)
    if leaves is not None and (leaves.dtype != torch.int32 or
                               tuple(leaves.shape) != (p, n_q) or
                               not leaves.is_contiguous()):
        raise ValueError(f"leaves: expected contiguous int32[{p}, {n_q}]")
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, None)
    if not _on_cuda(keep, flags, leaves, thr, *levels):
        return quantile_descend_dense_plain(
            levels, quantiles, std=std, level_keys=level_keys,
            gaussian=gaussian, min_v=min_v, max_v=max_v, keep=keep,
            flags=flags, dtype=dtype, leaves=leaves, tables=tables)
    dev = keep.device
    out = torch.empty(n_q, p, dtype=dtype, device=dev)
    scratch = torch.empty(p, n_q, dtype=dtype, device=dev)
    ptrs = (ctypes.c_void_p * tree_height)(*[t.data_ptr() for t in levels])
    keys = (ctypes.c_uint * (2 * tree_height))(
        *[int(w) for w in np.asarray(level_keys).reshape(-1)])
    q_t, order_t, scal_c, dims_c = _descend_params(
        quantiles, std, gaussian, min_v, max_v, tree_height, branching, n_q,
        dev)
    secure = thr is not None
    status = cuda_build.library("quantile_descend").quantile_descend_dense(
        ptrs, p, _ptr(q_t), _ptr(order_t), scal_c, dims_c, keys, _ptr(keep),
        _ptr(scratch), _ptr(leaves), _ptr(out), _ptr(flags), _ptr(thr),
        thr.shape[0] if secure else 0, float(tables[1]) if secure else 0.0,
        _f64(dtype), _stream(dev))
    _raise_on(status, "quantile_descend")
    launch_counts["quantile_descend_secure" if secure else
                  "quantile_descend"] += 1
    return out


def quantile_descend_dense_plain(levels, quantiles, *, std, level_keys,
                                 gaussian, min_v, max_v, keep, flags, dtype,
                                 leaves=None, tables=None):
    p, branching = levels[0].shape
    n_q = len(quantiles)
    dev = keep.device
    scale = _noise_scale(std, dtype, gaussian)
    state = DescentState(p, n_q, dtype, dev)
    rows = torch.arange(p, device=dev)[:, None, None]
    b = torch.arange(branching, device=dev)
    for level, counts in enumerate(levels, 1):
        j = state.node.to(torch.int64)[..., None] * branching + b
        counter = rows * branching**level + j
        node_counts = torch.gather(counts.to(torch.int64), 1,
                                   j.reshape(p, -1)).reshape(j.shape)
        if tables is not None:
            children = _clamp0(secure_noise.snapped_release(
                node_counts.to(dtype),
                *secure_noise.split_words(level_keys[level - 1], counter),
                tables[0], float(tables[1])))
        else:
            draws = threefry.draws_at(level_keys[level - 1], counter, dtype,
                                      gaussian)
            children = _noisy_children(node_counts, draws, scale)
        _descend_step(children, state, level, quantiles)
    if leaves is not None:
        leaves.copy_(state.node)
    values = _descend_values(state, branching**len(levels), min_v, max_v)
    return _finish_quantiles(values, quantiles, keep, flags)


def quantile_descend_step(counts: torch.Tensor, state: DescentState,
                          quantiles: Sequence[float], *, level: int,
                          tree_height: int, std: float, level_key,
                          gaussian: bool, min_v: float, max_v: float,
                          keep: torch.Tensor, flags: torch.Tensor,
                          tables=None) -> Optional[torch.Tensor]:
    """C8, lazy regime (_lazy_quantile_outputs of the JAX package, :767):
    one level of every (partition, quantile)'s descent from C7 (c)'s child
    counts. The children of node[p, q] at `level` draw their noise at
    counter 0 under fold_in(fold_in(level_key, p), node id), level_key =
    fold_in(qkey, level), derived on the device: a node visited by several
    quantiles gets the same noise. Updates state in place; at the last
    level returns the percentiles as dtype[n_q, P] and ORs their flag bits
    over the kept partitions into flags (else returns None). tables
    (secure noise): (thr int64[2K+1], gran), the quantile slot's packed
    table and grid; a child's count is then snapped and noised with the
    words bits(fold_in(node key, 0)) and bits(fold_in(node key, 1))
    (:748-758).
    """
    p, n_q, branching = counts.shape
    _check_descend(keep, flags, quantiles, tree_height, branching)
    if counts.dtype != torch.int32 or not counts.is_contiguous() or \
            tuple(state.node.shape) != (p, n_q):
        raise ValueError(f"counts: expected contiguous int32[{p}, {n_q}, "
                         f"B] matching the state, got {counts.dtype}"
                         f"{list(counts.shape)}")
    dtype = state.target.dtype
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, None)
    if not _on_cuda(counts, state.node, state.target, keep, flags, thr):
        return quantile_descend_step_plain(
            counts, state, quantiles, level=level, tree_height=tree_height,
            std=std, level_key=level_key, gaussian=gaussian, min_v=min_v,
            max_v=max_v, keep=keep, flags=flags, tables=tables)
    dev = counts.device
    last = level == tree_height
    out = torch.empty(n_q, p, dtype=dtype, device=dev) if last else None
    scratch = torch.empty(p, n_q, dtype=dtype, device=dev) if last else None
    q_t, order_t, scal_c, dims_c = _descend_params(
        quantiles, std, gaussian, min_v, max_v, tree_height, branching, n_q,
        dev)
    status = cuda_build.library("quantile_descend").quantile_descend_step(
        _ptr(counts), p, level, _ptr(q_t), _ptr(order_t), scal_c, dims_c,
        int(level_key[0]), int(level_key[1]), _ptr(state.node),
        _ptr(state.target), _ptr(state.total), _ptr(state.mass), _ptr(keep),
        _ptr(scratch), _ptr(out), _ptr(flags), _ptr(thr),
        0 if thr is None else thr.shape[0],
        0.0 if thr is None else float(tables[1]), _f64(dtype), _stream(dev))
    _raise_on(status, "quantile_descend")
    launch_counts["quantile_descend" if thr is None else
                  "quantile_descend_secure"] += 1
    return out


def quantile_descend_step_plain(counts, state, quantiles, *, level,
                                tree_height, std, level_key, gaussian, min_v,
                                max_v, keep, flags, tables=None):
    p, n_q, branching = counts.shape
    dtype, dev = state.target.dtype, counts.device
    node_id = (state.node.to(torch.int64)[..., None] * branching +
               torch.arange(branching, device=dev))
    pkey = threefry.fold_in_each(level_key, torch.arange(p, device=dev))
    nkey = threefry.fold_in_each((pkey[0][:, None, None],
                                  pkey[1][:, None, None]), node_id)
    zero = torch.zeros_like(node_id)
    if tables is not None:
        uhi = threefry.bits_at(threefry.fold_in_each(nkey, zero), zero)
        ulo = threefry.bits_at(threefry.fold_in_each(nkey, zero + 1), zero)
        children = _clamp0(secure_noise.snapped_release(
            counts.to(dtype), uhi, ulo, tables[0], float(tables[1])))
    else:
        draws = threefry.draws_at(nkey, zero, dtype, gaussian)
        children = _noisy_children(counts, draws,
                                   _noise_scale(std, dtype, gaussian))
    _descend_step(children, state, level, quantiles)
    if level < tree_height:
        return None
    values = _descend_values(state, branching**tree_height, min_v, max_v)
    return _finish_quantiles(values, quantiles, keep, flags)


# ---------------------------------------------------------------------------
# C9 vector_release


def vector_release(vsum: torch.Tensor, keep: torch.Tensor,
                   flags: torch.Tensor, *, max_norm: float, norm_kind: str,
                   std: float, key, gaussian: bool,
                   tables=None) -> torch.Tensor:
    """VECTOR_SUM's release: each partition's vector sum clipped to the
    norm ball (the JAX package's _clip_rows_to_norm_ball, :537: L1 or L2
    scale by min(1, max_norm / norm), L-inf clip per coordinate), plus
    noise at counter p * D + d under the entry's slot key (finalize,
    :612-616). ORs the flag bits of the kept partitions' outputs into
    flags. Returns dtype[P, D]. tables (secure noise): (thr int64[2K+1],
    gran), the entry's packed table and grid; each clipped coordinate is
    then snapped and noised with the words of split(key) at counter
    p * D + d.
    """
    p = keep.shape[0]
    _check(keep, torch.bool, p, "keep")
    _check(flags, torch.int32, 1, "flags")
    if vsum.dim() != 2 or vsum.shape[0] != p or not vsum.is_contiguous():
        raise ValueError(f"vsum: expected contiguous [{p}, D], got "
                         f"{list(vsum.shape)}")
    _f64(vsum.dtype)
    if norm_kind not in NORM_KINDS:
        raise NotImplementedError(
            f"Vector Norm of kind '{norm_kind}' is not supported")
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, None)
    if not _on_cuda(vsum, keep, flags, thr):
        return vector_release_plain(vsum, keep, flags, max_norm=max_norm,
                                    norm_kind=norm_kind, std=std, key=key,
                                    gaussian=gaussian, tables=tables)
    dev = vsum.device
    out = torch.empty_like(vsum)
    status = cuda_build.library("vector_release").vector_release(
        _ptr(vsum), p, vsum.shape[1], NORM_KINDS[norm_kind],
        float(max_norm), float(std), int(key[0]), int(key[1]),
        int(gaussian), _ptr(keep), _ptr(out), _ptr(flags), _ptr(thr),
        0 if thr is None else thr.shape[0],
        0.0 if thr is None else float(tables[1]), _f64(vsum.dtype),
        _stream(dev))
    _raise_on(status, "vector_release")
    launch_counts["vector_release" if thr is None else
                  "vector_release_secure"] += 1
    return out


def vector_release_plain(vsum, keep, flags, *, max_norm, norm_kind, std, key,
                         gaussian, tables=None):
    dtype, dev = vsum.dtype, vsum.device
    p, dim = vsum.shape
    bound = torch.tensor(max_norm, dtype=dtype, device=dev)
    if norm_kind == "linf":
        clipped = torch.minimum(torch.maximum(vsum, -bound), bound)
    else:
        norm = (_seq_sum(vsum.abs()) if norm_kind == "l1" else
                torch.sqrt(_seq_sum(vsum * vsum)))
        one = torch.ones((), dtype=dtype, device=dev)
        scale = torch.minimum(one, bound / torch.where(norm > 0, norm, one))
        clipped = vsum * scale[:, None]
    if tables is not None:
        out = secure_noise.snapped_noisy(clipped, key, tables[0],
                                         float(tables[1]))
    else:
        counter = torch.arange(p * dim, device=dev).reshape(p, dim)
        draws = threefry.draws_at(key, counter, dtype, gaussian)
        out = clipped + draws * _noise_scale(std, dtype, gaussian).to(dev)
    flags |= numeric.column_flags(out, keep)
    return out


# ---------------------------------------------------------------------------
# C10 block_offsets


def block_offsets(stream: torch.Tensor,
                  boundaries: torch.Tensor) -> torch.Tensor:
    """The row window of every partition block: offsets[j] = the first
    position of the ascending int32 stream holding a value >= boundaries[j]
    (searchsorted, side "left"), as int64[m]. Block j's rows are
    [offsets[j], offsets[j + 1]); with the last boundary at the partition
    count, offsets[-1] is the number of surviving rows."""
    n = stream.shape[0]
    m = boundaries.shape[0]
    _check(stream, torch.int32, n, "stream")
    _check(boundaries, torch.int32, m, "boundaries")
    if not _on_cuda(stream, boundaries):
        return block_offsets_plain(stream, boundaries)
    dev = stream.device
    offsets = torch.empty(m, dtype=torch.int64, device=dev)
    status = cuda_build.library("block_offsets").block_offsets(
        _ptr(stream), n, _ptr(boundaries), m, _ptr(offsets), _stream(dev))
    _raise_on(status, "block_offsets")
    launch_counts["block_offsets"] += 1
    return offsets


def block_offsets_plain(stream, boundaries):
    return torch.searchsorted(stream, boundaries, side="left")


# ---------------------------------------------------------------------------
# C11 gather_rows

GATHER_MAX_COLUMNS = 8


def gather_rows(index: torch.Tensor,
                columns: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every column's rows at `index`: out[c] = columns[c][index] for [n]
    or [n, D] columns of 1-, 4- or 8-byte elements (up to
    GATHER_MAX_COLUMNS, each with its own n), through one int64 index [k]
    whose entries lie in [0, n) of every column."""
    k = index.shape[0]
    _check(index, torch.int64, k, "index")
    if len(columns) > GATHER_MAX_COLUMNS:
        raise ValueError(f"gather_rows takes at most {GATHER_MAX_COLUMNS} "
                         f"columns, got {len(columns)}")
    for j, col in enumerate(columns):
        if col.dim() not in (1, 2) or not col.is_contiguous() or \
                col.element_size() not in (1, 4, 8):
            raise ValueError(f"gather_rows column {j}: expected a "
                             f"contiguous [n] or [n, D] column of 1-, 4- or "
                             f"8-byte elements, got {col.dtype}"
                             f"{list(col.shape)}")
    if not _on_cuda(index, *columns):
        return gather_rows_plain(index, columns)
    dev = index.device
    out = [torch.empty((k,) + tuple(c.shape[1:]), dtype=c.dtype, device=dev)
           for c in columns]
    n_cols = len(columns)
    status = cuda_build.library("gather_rows").gather_rows(
        _ptr(index), k, (ctypes.c_void_p * n_cols)(*[_ptr(c)
                                                     for c in columns]),
        (ctypes.c_void_p * n_cols)(*[_ptr(o) for o in out]),
        (ctypes.c_int * n_cols)(*[c.element_size() for c in columns]),
        (ctypes.c_int * n_cols)(*[1 if c.dim() == 1 else c.shape[1]
                                  for c in columns]), n_cols, _stream(dev))
    _raise_on(status, "gather_rows")
    launch_counts["gather_rows"] += 1
    return out


def gather_rows_plain(index, columns):
    return [c.index_select(0, index) for c in columns]


# ---------------------------------------------------------------------------
# Hash rows of the streamed ingest (encode_mode="hash_device"): int32[n, 3]
# holding the bit patterns of the JAX package's uint32 lanes [hash_hi,
# hash_lo, valid]; a row with both hash lanes 0xffffffff (-1 here) is the
# pad sentinel.


def _check_hash_rows(rows: torch.Tensor, what: str = "rows") -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 3 \
            or not rows.is_contiguous():
        raise ValueError(f"{what}: expected contiguous int32[n, 3] hash rows, "
                         f"got {rows.dtype}{list(rows.shape)}")


def _dropped_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sentinel or invalid hash rows: they code to -1."""
    return ((rows[:, 0] == -1) & (rows[:, 1] == -1)) | (rows[:, 2] != 1)


# ---------------------------------------------------------------------------
# C12 factorize_codes


def factorize_codes(rows: torch.Tensor):
    """First-occurrence dense codes of the rows' 64-bit key hashes: a row's
    code is the rank of its hash among the distinct non-sentinel hashes
    ordered by first row, valid rows or not; sentinel and invalid rows
    code to -1 (the JAX package's device_encode.factorize_codes).

    One C5 sort of the two hash lanes (as int32 words: grouping needs only
    adjacency), then C12's scans. Returns (codes int32[n], n_unique int32[]
    on the rows' device)."""
    _check_hash_rows(rows)
    if not _on_cuda(rows):
        return factorize_codes_plain(rows)
    n = rows.shape[0]
    dev = rows.device
    perm = radix_sort([rows[:, 0].contiguous(), rows[:, 1].contiguous()])
    lib = cuda_build.library("factorize_codes")
    scratch = torch.empty(max(1, lib.factorize_codes_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    n_unique = torch.empty((), dtype=torch.int32, device=dev)
    status = lib.factorize_codes(_ptr(rows), _ptr(perm), n, _ptr(scratch),
                                 _ptr(codes), _ptr(n_unique), _stream(dev))
    _raise_on(status, "factorize_codes")
    launch_counts["factorize_codes"] += 1
    return codes, n_unique


def factorize_codes_plain(rows):
    n = rows.shape[0]
    dev = rows.device
    perm = radix_sort_plain([rows[:, 0].contiguous(),
                             rows[:, 1].contiguous()])
    srows = rows[perm]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = (srows[1:, 0] != srows[:-1, 0]) | (srows[1:, 1] != srows[:-1, 1])
    head &= ~((srows[:, 0] == -1) & (srows[:, 1] == -1))
    uid = torch.cumsum(head.to(torch.int64), 0) - 1
    first_row = torch.zeros(max(int(head.sum()), 1), dtype=torch.int64,
                            device=dev)
    first_row[uid[head]] = perm[head]
    row_flag = torch.zeros(n, dtype=torch.int64, device=dev)
    row_flag[perm[head]] = 1
    rank = torch.cumsum(row_flag, 0) - row_flag
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    codes[perm] = rank[first_row[uid.clamp(min=0)]].to(torch.int32)
    codes[_dropped_rows(rows)] = -1
    return codes, head.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# C13 lookup_codes


def lookup_codes(rows: torch.Tensor, table: torch.Tensor,
                 table_codes: torch.Tensor) -> torch.Tensor:
    """The codes of factorize_codes by a lower-bound search of each row's
    hash in the host-merged table (device_encode.build_lookup_table:
    int32[Vcap, 2] lanes ascending as uint64, sentinel-padded, and the
    int32[Vcap] first-occurrence code of each entry); sentinel and invalid
    rows take -1 (the JAX package's device_encode.lookup_codes)."""
    _check_hash_rows(rows)
    v_cap = table.shape[0]
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[1] != 2 or not table.is_contiguous() or v_cap < 1:
        raise ValueError(f"table: expected contiguous int32[Vcap >= 1, 2], "
                         f"got {table.dtype}{list(table.shape)}")
    _check(table_codes, torch.int32, v_cap, "table_codes")
    if not _on_cuda(rows, table, table_codes):
        return lookup_codes_plain(rows, table, table_codes)
    n = rows.shape[0]
    dev = rows.device
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    status = cuda_build.library("lookup_codes").lookup_codes(
        _ptr(rows), n, _ptr(table), v_cap, _ptr(table_codes), _ptr(codes),
        _stream(dev))
    _raise_on(status, "lookup_codes")
    launch_counts["lookup_codes"] += 1
    return codes


def joined_hash_order(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the uint64 order of the (hi, lo)
    uint32 lane pairs (int32 bit patterns): the joined word with its top
    bit flipped."""
    word = ((hi.to(torch.int64) & _M32) << 32) | (lo.to(torch.int64) & _M32)
    return word ^ torch.iinfo(torch.int64).min


def lookup_codes_plain(rows, table, table_codes):
    keys = joined_hash_order(table[:, 0], table[:, 1])
    pos = torch.searchsorted(keys, joined_hash_order(rows[:, 0], rows[:, 1]))
    codes = table_codes[pos.clamp(max=table.shape[0] - 1)]
    return torch.where(_dropped_rows(rows), -1, codes).to(torch.int32)


# ---------------------------------------------------------------------------
# C14 append_rows


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The bit pattern of a pad value in a column of `dtype`."""
    return int(torch.tensor([fill], dtype=dtype).view(
        torch.int32 if dtype.itemsize == 4 else torch.int64)[0]) & (
            _M32 if dtype.itemsize == 4 else 0xFFFFFFFFFFFFFFFF)


def _check_buffers(bufs: Sequence[torch.Tensor], fills: Sequence) -> int:
    """Row buffers of one row count, [cap] or [cap, width], of 4- or 8-byte
    elements, one pad value each (at most three). Returns cap."""
    if not 1 <= len(bufs) <= 3 or len(fills) != len(bufs):
        raise ValueError(f"append_rows takes 1 to 3 buffers with a pad value "
                         f"each, got {len(bufs)} and {len(fills)}")
    cap = bufs[0].shape[0]
    for j, b in enumerate(bufs):
        if b.dim() not in (1, 2) or b.shape[0] != cap or \
                not b.is_contiguous() or b.element_size() not in (4, 8):
            raise ValueError(f"append_rows buffer {j}: expected a contiguous "
                             f"[{cap}] or [{cap}, width] column of 4- or "
                             f"8-byte elements, got {b.dtype}{list(b.shape)}")
    return cap


def _column_args(bufs, fills):
    k = len(bufs)
    return ((ctypes.c_int * k)(*[1 if b.dim() == 1 else b.shape[1]
                                 for b in bufs]),
            (ctypes.c_int * k)(*[b.element_size() for b in bufs]),
            (ctypes.c_ulonglong * k)(*[_fill_bits(f, b.dtype)
                                       for b, f in zip(bufs, fills)]))


def fill_tail(bufs: Sequence[torch.Tensor], start: int,
              fills: Sequence) -> None:
    """Writes each buffer's pad value over its rows [start, cap), in place
    (C14's fill_tail entry, one launch for all buffers)."""
    cap = _check_buffers(bufs, fills)
    if not 0 <= start <= cap:
        raise ValueError(f"fill_tail: start {start} outside [0, {cap}]")
    if not _on_cuda(*bufs):
        return fill_tail_plain(bufs, start, fills)
    if start == cap:
        return  # no tail: nothing to launch
    dev = bufs[0].device
    k = len(bufs)
    widths, elems, bits = _column_args(bufs, fills)
    status = cuda_build.library("append_rows").append_rows_fill_tail(
        (ctypes.c_void_p * k)(*[_ptr(b) for b in bufs]), widths, elems, bits,
        k, start, cap, _stream(dev))
    _raise_on(status, "append_rows")
    launch_counts["append_rows"] += 1


def fill_tail_plain(bufs, start, fills):
    for b, f in zip(bufs, fills):
        b[start:] = f


def grow_rows(bufs: Sequence[torch.Tensor], new_cap: int,
              fills: Sequence) -> List[torch.Tensor]:
    """New buffers of new_cap rows holding each old buffer's rows, their
    rows past the old capacity at the pad value (C14's grow entry, one
    launch for all buffers)."""
    cap = _check_buffers(bufs, fills)
    if new_cap < cap:
        raise ValueError(f"grow_rows: new capacity {new_cap} < {cap}")
    if not _on_cuda(*bufs):
        return grow_rows_plain(bufs, new_cap, fills)
    dev = bufs[0].device
    k = len(bufs)
    out = [torch.empty((new_cap,) + tuple(b.shape[1:]), dtype=b.dtype,
                       device=dev) for b in bufs]
    widths, elems, bits = _column_args(bufs, fills)
    status = cuda_build.library("append_rows").append_rows_grow(
        (ctypes.c_void_p * k)(*[_ptr(b) for b in bufs]),
        (ctypes.c_void_p * k)(*[_ptr(o) for o in out]), widths, elems, bits,
        k, cap, new_cap, _stream(dev))
    _raise_on(status, "append_rows")
    launch_counts["append_rows"] += 1
    return out


def grow_rows_plain(bufs, new_cap, fills):
    return [torch.cat([b, torch.full((new_cap - b.shape[0],) +
                                     tuple(b.shape[1:]), f, dtype=b.dtype,
                                     device=b.device)])
            for b, f in zip(bufs, fills)]


# ---------------------------------------------------------------------------
# C15 pld_fft


def _check_2d(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dtype}[rows, n], "
                         f"got {t.dtype}{list(t.shape)}")
    if not 1 <= t.shape[0] <= 65535:
        raise ValueError(f"{what}: 1 to 65535 rows a call, got {t.shape[0]}")


def _check_fft_length(length: int) -> None:
    if length < 2 or length & (length - 1):
        raise ValueError(f"pld_fft: the transform length must be a power of "
                         f"two >= 2, got {length}")


def pld_rfft(x: torch.Tensor) -> torch.Tensor:
    """torch.fft.rfft(x, dim=1) of float64[rows, L], L a power of two >= 2:
    complex128[rows, L / 2 + 1] (C15's forward entry)."""
    _check_2d(x, torch.float64, "pld_rfft")
    rows, length = x.shape
    _check_fft_length(length)
    if not _on_cuda(x):
        return pld_rfft_plain(x)
    n = length // 2
    dev = x.device
    out = torch.empty((rows, n + 1), dtype=torch.complex128, device=dev)
    work = torch.empty((rows, n), dtype=torch.complex128, device=dev)
    table = torch.empty(n, dtype=torch.complex128, device=dev)
    status = cuda_build.library("pld_fft").pld_rfft(
        _ptr(x), rows, n, _ptr(out), _ptr(work), _ptr(table), _stream(dev))
    _raise_on(status, "pld_fft")
    launch_counts["pld_fft"] += 1
    return out


def pld_rfft_plain(x):
    return torch.fft.rfft(x, dim=1)


def pld_irfft(spectrum: torch.Tensor, length: int) -> torch.Tensor:
    """torch.fft.irfft(spectrum, n=length, dim=1) of complex128[rows,
    length / 2 + 1], length a power of two >= 2: float64[rows, length]
    (C15's inverse entry; the imaginary parts of the first and last bins
    are dropped, as irfft drops them)."""
    _check_2d(spectrum, torch.complex128, "pld_irfft")
    _check_fft_length(length)
    rows = spectrum.shape[0]
    n = length // 2
    if spectrum.shape[1] != n + 1:
        raise ValueError(f"pld_irfft: {spectrum.shape[1]} bins for length "
                         f"{length}, expected {n + 1}")
    if not _on_cuda(spectrum):
        return pld_irfft_plain(spectrum, length)
    dev = spectrum.device
    out = torch.empty((rows, length), dtype=torch.float64, device=dev)
    work = torch.empty((rows, n), dtype=torch.complex128, device=dev)
    table = torch.empty(n, dtype=torch.complex128, device=dev)
    status = cuda_build.library("pld_fft").pld_irfft(
        _ptr(spectrum), rows, n, _ptr(out), _ptr(work), _ptr(table),
        _stream(dev))
    _raise_on(status, "pld_fft")
    launch_counts["pld_fft"] += 1
    return out


def pld_irfft_plain(spectrum, length):
    return torch.fft.irfft(spectrum, n=length, dim=1)


# ---------------------------------------------------------------------------
# C16 log_spectrum


def log_spectrum_accumulate(spectra: torch.Tensor, weights: torch.Tensor,
                            acc: torch.Tensor) -> None:
    """acc += sum_r weights[r] * log(spectra[r]), in place: the complex log
    as (log |z|, atan2(im, z)), the rows' sums taken from 0 in row order and
    then added (C16's accumulate entry). spectra complex128[rows, m],
    weights float64[rows] (no weight 0), acc complex128[m]."""
    _check_2d(spectra, torch.complex128, "log_spectrum_accumulate")
    rows, m = spectra.shape
    _check(weights, torch.float64, rows, "weights")
    _check(acc, torch.complex128, m, "acc")
    if not _on_cuda(spectra, weights, acc):
        return log_spectrum_accumulate_plain(spectra, weights, acc)
    status = cuda_build.library("log_spectrum").log_spectrum_accumulate(
        _ptr(spectra), rows, m, _ptr(weights), _ptr(acc),
        _stream(spectra.device))
    _raise_on(status, "log_spectrum")
    launch_counts["log_spectrum"] += 1


def log_spectrum_accumulate_plain(spectra, weights, acc):
    w = weights[:, None]
    re = (w * torch.log(torch.abs(spectra))).sum(0)
    im = (w * torch.angle(spectra)).sum(0)
    acc += torch.complex(re, im)


def log_spectrum_finalize(acc: torch.Tensor) -> torch.Tensor:
    """exp(acc) where acc's real part is finite, else 0 (C16's finalize
    entry): the composed spectrum."""
    m = acc.shape[0]
    _check(acc, torch.complex128, m, "acc")
    if not _on_cuda(acc):
        return log_spectrum_finalize_plain(acc)
    out = torch.empty_like(acc)
    status = cuda_build.library("log_spectrum").log_spectrum_finalize(
        _ptr(acc), m, _ptr(out), _stream(acc.device))
    _raise_on(status, "log_spectrum")
    launch_counts["log_spectrum"] += 1
    return out


def log_spectrum_finalize_plain(acc):
    alive = torch.isfinite(acc.real)
    spectrum = torch.exp(torch.where(alive, acc, torch.zeros_like(acc)))
    return torch.where(alive, spectrum, torch.zeros_like(acc))


# ---------------------------------------------------------------------------
# C17 group_stats (over C5-sorted streams; dataset_histograms)

PAIR_STATS = ("new_pair", "new_pid", "pair_len", "pair_sum", "l1", "l0",
              "pair_pk")


def sunk_keys(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 keys with every invalid row's key at INT32_MAX, so that a sort
    sinks the invalid rows to the tail (the JAX package's _I32_MAX)."""
    return torch.where(valid, keys, torch.full_like(keys, _INT32_MAX))


def group_stats_pairs(pid: torch.Tensor, pk: torch.Tensor,
                      values: Optional[torch.Tensor], valid: torch.Tensor,
                      perm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-pair and per-pid statistics of rows sorted by (pid, pk)
    (perm: the stable order with invalid rows' keys at INT32_MAX), in
    sorted order, each at its group's first row and 0 elsewhere: new_pair,
    new_pid (bool), pair_len, l1, l0 (int32), pair_sum (float32, added in
    row order from 0), pair_pk (the pk of each pair start, INT32_MAX
    elsewhere) (C17's pairs entry). pid, pk int32[n]; values float32[n] or
    None (sums 0); valid bool[n]; perm int64[n]."""
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(pk, torch.int32, n, "pk")
    _check(values, torch.float32, n, "values")
    _check(valid, torch.bool, n, "valid")
    _check(perm, torch.int64, n, "perm")
    if not _on_cuda(pid, pk, values, valid, perm):
        return group_stats_pairs_plain(pid, pk, values, valid, perm)
    dev = pid.device
    lib = cuda_build.library("group_stats")
    scratch = torch.empty(max(1, lib.group_stats_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    out = {name: torch.empty(n, dtype=dtype, device=dev)
           for name, dtype in zip(PAIR_STATS, (
               torch.bool, torch.bool, torch.int32, torch.float32,
               torch.int32, torch.int32, torch.int32))}
    status = lib.group_stats_pairs(
        _ptr(pid), _ptr(pk), _ptr(values), _ptr(valid), _ptr(perm), n,
        _ptr(scratch), *[_ptr(out[name]) for name in PAIR_STATS],
        _stream(dev))
    _raise_on(status, "group_stats")
    launch_counts["group_stats"] += 1
    return out


def _segment_ids(starts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(starts.to(torch.int64), 0) - 1


def group_stats_pairs_plain(pid, pk, values, valid, perm):
    n = pid.shape[0]
    zero_i = torch.zeros(n, dtype=torch.int32, device=pid.device)
    sv = valid[perm]
    sp = sunk_keys(pid, valid)[perm]
    sq = sunk_keys(pk, valid)[perm]
    pid_head = torch.ones(n, dtype=torch.bool, device=pid.device)
    pid_head[1:] = sp[1:] != sp[:-1]
    pair_head = pid_head.clone()
    pair_head[1:] |= sq[1:] != sq[:-1]
    new_pair, new_pid = pair_head & sv, pid_head & sv
    seg = _segment_ids(new_pair | ~sv)
    vals = (torch.zeros(n, dtype=torch.float32, device=pid.device)
            if values is None else values[perm])
    seg_sum = torch.zeros(n, dtype=torch.float32, device=pid.device)
    seg_sum.index_add_(0, seg, torch.where(sv, vals, torch.zeros_like(vals)))
    seg_len = torch.bincount(seg, minlength=n)
    pseg = _segment_ids(new_pid | ~sv)
    pid_rows = torch.bincount(pseg, minlength=n)
    pid_pairs = torch.bincount(pseg, weights=new_pair.double(), minlength=n)
    return {
        "new_pair": new_pair, "new_pid": new_pid,
        "pair_len": torch.where(new_pair, seg_len[seg].to(torch.int32),
                                zero_i),
        "pair_sum": torch.where(new_pair, seg_sum[seg],
                                torch.zeros_like(seg_sum)),
        "l1": torch.where(new_pid, pid_rows[pseg].to(torch.int32), zero_i),
        "l0": torch.where(new_pid, pid_pairs[pseg].to(torch.int32), zero_i),
        "pair_pk": torch.where(new_pair, sq,
                               torch.full_like(sq, _INT32_MAX)),
    }


def group_stats_keys(keys: torch.Tensor, valid: torch.Tensor,
                     perm: torch.Tensor):
    """The first valid row of each key of a stream sorted by `keys` (perm:
    the stable order) and that key's run length there, 0 elsewhere, in
    sorted order: (new_seg bool[n], seg_len int32[n]) (C17's keys entry).
    Every invalid row is a run of its own."""
    n = keys.shape[0]
    _check(keys, torch.int32, n, "keys")
    _check(valid, torch.bool, n, "valid")
    _check(perm, torch.int64, n, "perm")
    if not _on_cuda(keys, valid, perm):
        return group_stats_keys_plain(keys, valid, perm)
    dev = keys.device
    lib = cuda_build.library("group_stats")
    scratch = torch.empty(max(1, lib.group_stats_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    new_seg = torch.empty(n, dtype=torch.bool, device=dev)
    seg_len = torch.empty(n, dtype=torch.int32, device=dev)
    status = lib.group_stats_keys(_ptr(keys), _ptr(valid), _ptr(perm), n,
                                  _ptr(scratch), _ptr(new_seg),
                                  _ptr(seg_len), _stream(dev))
    _raise_on(status, "group_stats")
    launch_counts["group_stats"] += 1
    return new_seg, seg_len


def group_stats_keys_plain(keys, valid, perm):
    n = keys.shape[0]
    sk, sv = keys[perm], valid[perm]
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = sk[1:] != sk[:-1]
    new_seg = head & sv
    seg = _segment_ids(new_seg | ~sv)
    run = torch.bincount(seg, minlength=n)[seg].to(torch.int32)
    return new_seg, torch.where(new_seg, run, torch.zeros_like(run))


# ---------------------------------------------------------------------------
# C18 log_bins (dataset_histograms)

# Slots of the 3-leading-digit bins over int32 (csrc/log_bins.cu).
LOG_BIN_SLOTS = 6514
_INT32_MIN = -(2**31)
_FLOAT32_MAX = float(np.finfo(np.float32).max)


def _pow10(device) -> torch.Tensor:
    return torch.tensor([10**k for k in range(10)], dtype=torch.int64,
                        device=device)


def log_bin_bounds(values: torch.Tensor):
    """(lower, upper) of the 3-leading-digit bin of each value >= 1
    (int64), in the JAX package's int32 arithmetic: the upper wraps past
    2^31 as an int32 add does."""
    pow10 = _pow10(values.device)
    d = (values[:, None] >= pow10).sum(1)
    is_pow10 = values == pow10[(d - 1).clamp(max=9)]
    e = torch.where(is_pow10, d - 1, d).clamp(min=3)
    base = pow10[(e - 3).clamp(max=7)]
    lower = values // base * base
    at_bound = (e <= 9) & (values == pow10[e.clamp(max=9)])
    upper = lower + torch.where(at_bound, base * 10, base)
    upper = (upper + 2**31) % 2**32 - 2**31
    return lower, upper


def log_bin_slot(lower: torch.Tensor) -> torch.Tensor:
    pow10 = _pow10(lower.device)
    e = (lower[:, None] >= pow10).sum(1) - 1
    m = lower // pow10[(e - 2).clamp(min=0)]
    return torch.where(lower <= 1000, lower - 1,
                       1000 + (e - 3) * 900 + m - 101)


def log_bin_lower(slot: torch.Tensor) -> torch.Tensor:
    u = slot - 999
    e = 3 + torch.div(u, 900, rounding_mode="floor")
    m = u % 900 + 100
    return torch.where(slot < 1000, slot + 1,
                       m * _pow10(slot.device)[(e - 2).clamp(0, 9)])


def log_bins_int(values: torch.Tensor, mask: torch.Tensor):
    """The 3-leading-digit log histogram of the int32 values the bool mask
    selects: (lowers, uppers, counts, sums, maxes, n_bins), LOG_BIN_SLOTS
    entries each, the first n_bins the bins in ascending lower and zeros
    after; lowers, uppers, maxes int32, counts and sums int64 (exact),
    n_bins an int64 scalar (C18's integer entry). Values below 1 bin as 1
    and add their own value to sum and max."""
    n = values.shape[0]
    _check(values, torch.int32, n, "values")
    _check(mask, torch.bool, n, "mask")
    if not _on_cuda(values, mask):
        return log_bins_int_plain(values, mask)
    dev = values.device
    lib = cuda_build.library("log_bins")
    scratch = torch.empty(lib.log_bins_int_scratch_bytes(), dtype=torch.uint8,
                          device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    out = tuple(torch.empty(LOG_BIN_SLOTS, **kind)
                for kind in (i32, i32, i64, i64, i32)) + (
        torch.empty((), **i64),)
    status = lib.log_bins_int(_ptr(values), _ptr(mask), n, _ptr(scratch),
                              *[_ptr(t) for t in out], _stream(dev))
    _raise_on(status, "log_bins")
    launch_counts["log_bins"] += 1
    return out


def log_bins_int_plain(values, mask):
    dev = values.device
    v = values[mask].to(torch.int64)
    lower, _ = log_bin_bounds(v.clamp(min=1))
    slot = log_bin_slot(lower)
    counts = torch.bincount(slot, minlength=LOG_BIN_SLOTS)
    sums = torch.zeros(LOG_BIN_SLOTS, dtype=torch.int64, device=dev)
    sums.index_add_(0, slot, v)
    maxes = torch.full((LOG_BIN_SLOTS,), _INT32_MIN, dtype=torch.int64,
                       device=dev)
    maxes.scatter_reduce_(0, slot, v, "amax")
    full = torch.nonzero(counts > 0).reshape(-1)
    k = full.shape[0]
    lowers, uppers = log_bin_bounds(log_bin_lower(full))
    out = [torch.zeros(LOG_BIN_SLOTS, dtype=dt, device=dev)
           for dt in (torch.int32, torch.int32, torch.int64, torch.int64,
                      torch.int32)]
    for o, col in zip(out, (lowers, uppers, counts[full], sums[full],
                            maxes[full])):
        o[:k] = col.to(o.dtype)
    return (*out, torch.tensor(k, dtype=torch.int64, device=dev))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 a * b + c rounded once (a fused multiply-add): the product
    is exact in float64, the sum is rounded to odd there, and the odd
    float64 rounds correctly to float32."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def linspace_edges_f32(lo: torch.Tensor, hi: torch.Tensor,
                       n_buckets: int) -> torch.Tensor:
    """jnp.linspace(lo, hi, n_buckets + 1) in float32 as XLA compiles it
    for the CPU: edge_i = fma(i, hi * c, lo * fma(-i, c, 1)), c =
    float32(1 / n_buckets), the last edge hi."""
    dev = lo.device
    i = torch.arange(n_buckets, dtype=torch.float32, device=dev)
    c = torch.full_like(i, float(np.float32(1.0 / n_buckets)))
    step = _fma_f32(-i, c, torch.ones_like(i))
    edges = _fma_f32(i, hi * c, lo * step)
    return torch.cat([edges, hi.reshape(1)])


def log_bins_float(values: torch.Tensor, mask: torch.Tensor,
                   n_buckets: int):
    """The equal-width histogram of n_buckets buckets between the min and
    max of the float32 values the bool mask selects: (lo_hi float32[2],
    edges float32[n_buckets + 1], counts int32, sums float32, maxes
    float32 [n_buckets]); a value's bucket is searchsorted(edges, v,
    side="right") - 1, clipped, and its sum the float32 of the bucket's
    float64 sum (C18's float entry). With no value selected lo_hi is
    (float32 max, -float32 max)."""
    n = values.shape[0]
    _check(values, torch.float32, n, "values")
    _check(mask, torch.bool, n, "mask")
    if not _on_cuda(values, mask):
        return log_bins_float_plain(values, mask, n_buckets)
    dev = values.device
    lo_hi = torch.empty(2, dtype=torch.float32, device=dev)
    edges = torch.empty(n_buckets + 1, dtype=torch.float32, device=dev)
    counts = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    sums = torch.empty(n_buckets, dtype=torch.float32, device=dev)
    maxes = torch.empty(n_buckets, dtype=torch.float32, device=dev)
    scratch = torch.empty(n_buckets, dtype=torch.float64, device=dev)
    status = cuda_build.library("log_bins").log_bins_float(
        _ptr(values), _ptr(mask), n, n_buckets,
        float(np.float32(1.0 / n_buckets)), _ptr(scratch), _ptr(lo_hi),
        _ptr(edges), _ptr(counts), _ptr(sums), _ptr(maxes), _stream(dev))
    _raise_on(status, "log_bins")
    launch_counts["log_bins"] += 1
    return lo_hi, edges, counts, sums, maxes


def log_bins_float_plain(values, mask, n_buckets):
    big = torch.full_like(values, _FLOAT32_MAX)
    lo = torch.where(mask, values, big).min()
    hi = torch.where(mask, values, -big).max()
    edges = linspace_edges_f32(lo, hi, n_buckets)
    idx = torch.searchsorted(edges, values, right=True) - 1
    idx = torch.where(mask, idx.clamp(0, n_buckets - 1),
                      torch.full_like(idx, n_buckets))
    counts = torch.zeros(n_buckets + 1, dtype=torch.int32,
                         device=values.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    sums = torch.zeros(n_buckets + 1, dtype=torch.float64,
                       device=values.device)
    sums.index_add_(0, idx, torch.where(mask, values,
                                        torch.zeros_like(values)).double())
    maxes = torch.full((n_buckets + 1,), -_FLOAT32_MAX, dtype=torch.float32,
                       device=values.device)
    maxes.scatter_reduce_(0, idx, torch.where(mask, values, -big), "amax")
    return (torch.stack([lo, hi]), edges, counts[:-1], sums[:-1].float(),
            maxes[:-1])


# ---------------------------------------------------------------------------
# C19 sweep_stats, C20 sweep_report (utility analysis, parameter tuning)

# Selector scalars of the sweep, the rows of sel_cfg [8, K]: the fields
# sel_* of analysis.kernels.SweepConfigArrays, in their order.
SWEEP_SELECTION = ("kind", "pre_shift", "eps1", "delta1", "n_cross",
                   "pi_cross", "threshold", "scale")
SWEEP_METRIC_CODES = (0, 1, 2)  # SUM, COUNT, PRIVACY_ID_COUNT


def _check_metric_codes(metric_codes: Sequence[int]) -> Tuple[int, ...]:
    codes = tuple(int(c) for c in metric_codes)
    if len(codes) > 3 or any(c not in SWEEP_METRIC_CODES for c in codes):
        raise ValueError(f"sweep: metric codes must be at most three of "
                         f"{SWEEP_METRIC_CODES}, got {codes}")
    return codes


def _check_cfg(t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...],
               what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous {dtype}{list(shape)}, "
                         f"got {t.dtype}{list(t.shape)}")


def sweep_stats(counts: torch.Tensor, sums: torch.Tensor,
                contributed: torch.Tensor, perm: torch.Tensor,
                offsets: torch.Tensor, l0: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, *, metric_codes: Sequence[int],
                private: bool, config_chunk: int = 8):
    """The sweep's per-partition sufficient statistics (C19).

    counts, sums, contributed: the preaggregated rows' columns, T[N] (T the
    working float); perm int64[N], the stable order of the rows by
    partition, and offsets int64[P + 1], each partition's rows
    [offsets[p], offsets[p + 1]) in that order (C5, then C10 at 0..P), so
    rows outside [0, P) contribute nothing; l0 T[K]; lo, hi T[K, Ms] (Ms
    >= the metric count M) the clipping bounds. Per configuration k and
    partition p, over p's rows in row order from 0: stats T[K, P, M, 5],
    the five metric terms of error_model.metric_stat_terms per metric, and,
    when
    private, sel T[K, P, 3], error_model.selection_moment_terms (else
    None); per partition n_users (rows), n_rows (sum of counts) and size
    (the first metric's raw sum; n_users without metrics), T[P].
    config_chunk bounds the plain version's [chunk, N, 5] terms.
    """
    codes = _check_metric_codes(metric_codes)
    n = counts.shape[0]
    f = counts.dtype
    _f64(f)
    _check(counts, f, n, "counts")
    _check(sums, f, n, "sums")
    _check(contributed, f, n, "contributed")
    _check(perm, torch.int64, n, "perm")
    p = offsets.shape[0] - 1
    _check(offsets, torch.int64, p + 1, "offsets")
    k = l0.shape[0]
    _check(l0, f, k, "l0")
    ms = lo.shape[1] if lo.dim() == 2 else -1
    if ms < len(codes):
        raise ValueError(f"sweep_stats: lo, hi must be [K, >= M], got "
                         f"{list(lo.shape)}")
    _check_cfg(lo, f, (k, ms), "lo")
    _check_cfg(hi, f, (k, ms), "hi")
    if not _on_cuda(counts, sums, contributed, perm, offsets, l0, lo, hi):
        return sweep_stats_plain(counts, sums, contributed, perm, offsets,
                                 l0, lo, hi, metric_codes=codes,
                                 private=private, config_chunk=config_chunk)
    dev = counts.device
    m = len(codes)
    stats = torch.empty((k, p, m, em.STAT_WIDTH), dtype=f, device=dev)
    sel = (torch.empty((k, p, em.SEL_WIDTH), dtype=f, device=dev)
           if private else None)
    n_users, n_rows, size = (torch.empty(p, dtype=f, device=dev)
                             for _ in range(3))
    scratch = torch.empty((3, n), dtype=f, device=dev)
    code = (ctypes.c_int * 3)(*(codes + (0,) * (3 - m)))
    status = cuda_build.library("sweep_stats").sweep_stats(
        _ptr(counts), _ptr(sums), _ptr(contributed), _ptr(perm), n,
        _ptr(offsets), p, _ptr(l0), _ptr(lo), _ptr(hi), k, ms, m, code,
        int(private), _f64(f), _ptr(scratch), _ptr(stats), _ptr(sel),
        _ptr(n_users), _ptr(n_rows), _ptr(size), _stream(dev))
    _raise_on(status, "sweep_stats")
    launch_counts["sweep_stats"] += 1
    return stats, sel, n_users, n_rows, size


def _metric_values(code: int, counts, sums):
    if code == 0:
        return sums
    if code == 1:
        return counts
    return torch.where(counts > 0, torch.ones_like(counts),
                       torch.zeros_like(counts))


def sweep_stats_plain(counts, sums, contributed, perm, offsets, l0, lo, hi,
                      *, metric_codes, private, config_chunk=8):
    xp = em.TORCH_XP
    f, dev = counts.dtype, counts.device
    p = offsets.shape[0] - 1
    # The partitions' rows in partition order, each in row order: on the
    # CPU index_add_ adds them in that order.
    rows = perm[int(offsets[0]):int(offsets[-1])]
    c, s, con = counts[rows], sums[rows], contributed[rows]
    pk = torch.repeat_interleave(torch.arange(p, device=dev),
                                 offsets[1:] - offsets[:-1])

    def seg(x):
        return torch.zeros(p, dtype=f, device=dev).index_add_(0, pk, x)

    n_users = seg(torch.ones_like(c))
    n_rows = seg(c)
    vals = [_metric_values(code, c, s) for code in metric_codes]
    size = seg(vals[0]) if vals else n_users
    k, m = l0.shape[0], len(metric_codes)
    stats = torch.zeros((k, p, m, em.STAT_WIDTH), dtype=f, device=dev)
    sel = (torch.zeros((k, p, em.SEL_WIDTH), dtype=f, device=dev)
           if private else None)
    for k0 in range(0, k, max(1, config_chunk)):
        k1 = min(k, k0 + max(1, config_chunk))
        q = em.keep_fraction(con[None, :], l0[k0:k1, None], xp=xp)
        for mi in range(m):
            terms = em.metric_stat_terms(vals[mi][None, :],
                                         lo[k0:k1, mi:mi + 1],
                                         hi[k0:k1, mi:mi + 1], q, xp=xp)
            stats[k0:k1, :, mi, :] = torch.zeros(
                (k1 - k0, p, em.STAT_WIDTH), dtype=f,
                device=dev).index_add_(1, pk, terms)
        if private:
            sel[k0:k1] = torch.zeros((k1 - k0, p, em.SEL_WIDTH), dtype=f,
                                     device=dev).index_add_(
                1, pk, em.selection_moment_terms(q, xp=xp))
    return stats, sel, n_users, n_rows, size


def sweep_report(stats: torch.Tensor, sel: Optional[torch.Tensor],
                 n_users: torch.Tensor, size: torch.Tensor,
                 noise_std: torch.Tensor, sel_cfg: torch.Tensor,
                 bounds: torch.Tensor, *, public: bool, window: int = 64,
                 partition_chunk: int = 4096):
    """Keep probabilities, report rows and their bucket sums (C20).

    stats T[K, P, M, 5] and sel T[K, P, 3] (None when public) from C19;
    n_users, size T[P]; noise_std T[K, Ms]; sel_cfg T[8, K], the
    selector scalars (SWEEP_SELECTION); bounds T[NB], the partition-size
    buckets' lower bounds in the working float. Returns bucket int32[P]
    (searchsorted(bounds, size, right) - 1, clipped), keep_prob T[K, P]
    (1 when public; else the selector's keep probability integrated over
    `window` support points of the skew-corrected normal PMF of the
    privacy-id count, or at rint(mu) when sigma is 0), and the sums over
    each bucket's partitions, in partition order from 0, of
    error_model.metric_report_terms, bucket_rows T[K, NB, M, 24], and of
    error_model.info_terms, bucket_info T[K, NB, 5]. partition_chunk
    bounds the plain version's [K, chunk, window] windows.
    """
    f = stats.dtype
    _f64(f)
    if stats.dim() != 4 or stats.shape[3] != em.STAT_WIDTH or \
            not stats.is_contiguous():
        raise ValueError(f"sweep_report: stats must be contiguous "
                         f"[K, P, M, {em.STAT_WIDTH}], got {list(stats.shape)}")
    k, p, m, _ = stats.shape
    if sel is None and not public:
        raise ValueError("sweep_report: private analysis needs sel")
    if sel is not None:
        _check_cfg(sel, f, (k, p, em.SEL_WIDTH), "sel")
    _check(n_users, f, p, "n_users")
    _check(size, f, p, "size")
    ms = noise_std.shape[1] if noise_std.dim() == 2 else -1
    if ms < m:
        raise ValueError(f"sweep_report: noise_std must be [K, >= M], got "
                         f"{list(noise_std.shape)}")
    _check_cfg(noise_std, f, (k, ms), "noise_std")
    _check_cfg(sel_cfg, f, (len(SWEEP_SELECTION), k), "sel_cfg")
    nb = bounds.shape[0]
    _check(bounds, f, nb, "bounds")
    if window < 1:
        raise ValueError(f"sweep_report: window must be >= 1, got {window}")
    if not _on_cuda(stats, sel, n_users, size, noise_std, sel_cfg, bounds):
        return sweep_report_plain(stats, sel, n_users, size, noise_std,
                                  sel_cfg, bounds, public=public,
                                  window=window,
                                  partition_chunk=partition_chunk)
    dev = stats.device
    bucket = torch.empty(p, dtype=torch.int32, device=dev)
    keep_prob = torch.empty((k, p), dtype=f, device=dev)
    bucket_rows = torch.empty((k, nb, m, em.REPORT_WIDTH), dtype=f, device=dev)
    bucket_info = torch.empty((k, nb, em.INFO_WIDTH), dtype=f, device=dev)
    order = torch.empty(p + nb + 1, dtype=torch.int32, device=dev)
    status = cuda_build.library("sweep_report").sweep_report(
        _ptr(stats), _ptr(sel), _ptr(n_users), _ptr(size), _ptr(noise_std),
        _ptr(sel_cfg), _ptr(bounds), k, p, m, ms, nb, int(public), window,
        _f64(f), _ptr(order), _ptr(bucket), _ptr(keep_prob),
        _ptr(bucket_rows), _ptr(bucket_info), _stream(dev))
    _raise_on(status, "sweep_report")
    launch_counts["sweep_report"] += 1
    return bucket, keep_prob, bucket_rows, bucket_info


def sweep_keep_points(xs: torch.Tensor, sel_cfg: torch.Tensor) -> torch.Tensor:
    """The selector keep probability at (possibly fractional) privacy-id
    counts xs [KC, ...], per configuration (sel_cfg [8, KC]): the JAX
    package's analysis/kernels.py _keep_prob_batch. Every strategy's branch
    is evaluated and where-selected, inert parameters sanitized (eps1 1,
    delta1 0.5 where the kind is not truncated geometric; scale >= 1e-30;
    the geometric tail 0 at eps1 >= 700), so unused branches stay
    finite."""
    xp = em.TORCH_XP
    shape = (-1,) + (1,) * (xs.dim() - 1)
    kind, pre_shift, eps1, delta1, n_cross, pi_cross, threshold, scale = (
        row for row in sel_cfg)
    is_tg = kind == 0
    kind = kind.reshape(shape)
    n = xs - pre_shift.reshape(shape)
    eps1 = torch.where(is_tg, eps1, 1.0).reshape(shape)
    delta1 = torch.where(is_tg, delta1, 0.5).reshape(shape)
    n_cross = n_cross.reshape(shape)
    pi_cross = pi_cross.reshape(shape)
    threshold = threshold.reshape(shape)
    scale = xp.maximum(scale.reshape(shape), 1e-30)
    # Truncated geometric (partition_selection.py closed form, log space).
    n_eff = xp.maximum(n, 1.0)
    n1 = xp.minimum(n_eff, n_cross)
    log_pi1 = (torch.log(delta1) + (n1 - 1.0) * eps1 +
               torch.log1p(-torch.exp(-n1 * eps1)) -
               torch.log1p(-torch.exp(-eps1)))
    pi1 = torch.exp(xp.minimum(log_pi1, 0.0))
    kk = xp.maximum(n_eff - n_cross, 0.0)
    decay = torch.exp(-kk * eps1)
    geo = torch.where(eps1 < 700.0,
                      torch.exp(-eps1) * (1.0 - decay) /
                      (1.0 - torch.exp(-xp.minimum(eps1, 700.0))), 0.0)
    q = decay * (1.0 - pi_cross) - delta1 * geo
    p_tg = xp.clip(torch.where(n_eff <= n_cross, pi1,
                               1.0 - xp.maximum(q, 0.0)), 0.0, 1.0)
    # Laplace thresholding.
    z = (n - threshold) / scale
    p_lap = torch.where(z >= 0, 1.0 - 0.5 * torch.exp(-torch.abs(z)),
                        0.5 * torch.exp(-torch.abs(z)))
    # Gaussian thresholding.
    zg = (threshold - n) / scale
    p_gauss = 0.5 * torch.special.erfc(zg / _sqrt_of(2.0, xs))
    probs = torch.where(kind == 0, p_tg,
                        torch.where(kind == 1, p_lap, p_gauss))
    return torch.where(n <= 0, 0.0, probs)


def _sqrt_of(c: float, like: torch.Tensor) -> torch.Tensor:
    """sqrt(c) rounded in like's float (jnp.sqrt of a Python float)."""
    return torch.sqrt(torch.tensor(c, dtype=like.dtype, device=like.device))


def _norm_cdf_skew(z: torch.Tensor, skew: torch.Tensor) -> torch.Tensor:
    """Skew-corrected normal CDF (poisson_binomial.compute_pmf_approximation;
    the JAX package's analysis/kernels.py _norm_cdf_skew)."""
    cdf = 0.5 * torch.special.erfc(-z / _sqrt_of(2.0, z))
    pdf = torch.exp(-0.5 * z * z) / _sqrt_of(2.0 * math.pi, z)
    return em.TORCH_XP.clip(cdf + skew * (1.0 - z * z) * pdf / 6.0, 0.0, 1.0)


def _windowed_keep_prob(mu, var, third, n_users, sel_cfg, window):
    """P(partition kept) from the Poisson-binomial moments mu, var, third
    [KC, PC] (n_users [PC]): the JAX package's _windowed_keep_prob on one
    partition chunk."""
    xp = em.TORCH_XP
    sigma = torch.sqrt(xp.maximum(var, 0.0))
    safe_sigma = xp.maximum(sigma, 1e-30)
    skew = torch.where(sigma > 0, third / (safe_sigma * safe_sigma *
                                           safe_sigma), 0.0)
    step = xp.maximum(1.0, 16.0 * sigma / window)
    offsets = (torch.arange(window, dtype=mu.dtype, device=mu.device) -
               (window - 1) / 2.0)
    xs = mu[..., None] + offsets * step[..., None]  # [KC, PC, W]
    z_hi = (xs + 0.5 * step[..., None] - mu[..., None]) / safe_sigma[..., None]
    z_lo = (xs - 0.5 * step[..., None] - mu[..., None]) / safe_sigma[..., None]
    sk = skew[..., None]
    pmf = xp.maximum(_norm_cdf_skew(z_hi, sk) - _norm_cdf_skew(z_lo, sk), 0.0)
    # Restrict support to [0, n_users] like the host PMF.
    support = (xs > -0.5) & (xs <= n_users[None, :, None] + 0.5)
    pmf = torch.where(support, pmf, 0.0)
    keep = sweep_keep_points(xs, sel_cfg)
    p_win = torch.sum(pmf * keep, dim=-1)
    # Degenerate sigma: all-or-nothing ids, the PMF concentrated at mu
    # (torch.round rounds half to even, as jnp.round).
    p_point = sweep_keep_points(torch.round(mu), sel_cfg)
    return xp.clip(torch.where(sigma > 0, p_win, p_point), 0.0, 1.0)


def sweep_report_plain(stats, sel, n_users, size, noise_std, sel_cfg, bounds,
                       *, public, window=64, partition_chunk=4096):
    xp = em.TORCH_XP
    f, dev = stats.dtype, stats.device
    k, p, m, _ = stats.shape
    nb = bounds.shape[0]
    bucket = torch.clamp(
        torch.searchsorted(bounds, size, right=True) - 1, 0, nb - 1)
    if public:
        keep_prob = torch.ones((k, p), dtype=f, device=dev)
    else:
        keep_prob = torch.empty((k, p), dtype=f, device=dev)
        chunk = max(1, partition_chunk)
        for p0 in range(0, p, chunk):
            p1 = min(p, p0 + chunk)
            keep_prob[:, p0:p1] = _windowed_keep_prob(
                sel[:, p0:p1, em.SEL_MU], sel[:, p0:p1, em.SEL_VAR],
                sel[:, p0:p1, em.SEL_SKEW3], n_users[p0:p1], sel_cfg, window)
    weight = keep_prob
    rows = em.metric_report_terms(stats, keep_prob[..., None],
                                  weight[..., None], noise_std[:, None, :m],
                                  xp=xp)  # [K, P, M, 24]
    info = em.info_terms(n_users[None, :], keep_prob, weight, public, xp=xp)
    bucket_rows = torch.zeros((k, nb, m, em.REPORT_WIDTH), dtype=f,
                              device=dev).index_add_(1, bucket, rows)
    bucket_info = torch.zeros((k, nb, em.INFO_WIDTH), dtype=f,
                              device=dev).index_add_(1, bucket, info)
    return bucket.to(torch.int32), keep_prob, bucket_rows, bucket_info
