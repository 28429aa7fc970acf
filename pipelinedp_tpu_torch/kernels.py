"""The twenty-four CUDA kernels of the dense and blocked release and
selection paths, the device mesh, the streamed ingest, the PLD composition,
the dataset histograms and the utility-analysis sweep, their wrappers and
their plain PyTorch versions.

    C1 row_keys           csrc/row_keys.cu           bounding-sort keys + row uniform;
                                                     total-bound keys (total_bound_keys)
    C2 bound_rows         csrc/bound_rows.cu         L0/Linf bounding, row columns;
                                                     total bound (total_bound_rows):
                                                     one pass, a look-back over
                                                     tiles of 2048 rows
    C3 reduce_partitions  csrc/reduce_partitions.cu  dense partition columns;
                                                     vector sums (D columns)
    C4 release_epilogue   csrc/release_epilogue.cu   selection, noise, metrics, flags
    C5 radix_sort         csrc/radix_sort.cu         stable multi-word LSD radix sort:
                                                     Onesweep, one launch a digit
                                                     pass after one digit-start
                                                     launch (radix_sort_plan)
    C6 compact_kept       csrc/compact_kept.cu       kept-first compaction:
                                                     one cooperative launch,
                                                     a grid barrier between
                                                     the tile counts and the
                                                     scatter
    C7 quantile_counts    csrc/quantile_counts.cu    quantile-tree counts: leaf
                                                     histogram, level roll-ups,
                                                     child counts of a level
                                                     (the leaf gathered once
                                                     into a buffer the later
                                                     levels read; counted as
                                                     quantile_child_counts)
    C8 quantile_descend   csrc/quantile_descend.cu   node noise + descent (both
                                                     regimes), percentile flags:
                                                     one launch; a warp's
                                                     lanes draw each distinct
                                                     node's children once,
                                                     each walk on its lane
    C9 vector_release     csrc/vector_release.cu     norm-ball clip, noise, flags
    C10 block_offsets     csrc/block_offsets.cu      row window of every partition
                                                     block (blocked route): a
                                                     warp's 32-way search a
                                                     boundary; the block
                                                     boundaries of S streams
                                                     made in one launch
                                                     (block_window_offsets)
    C11 gather_rows       csrc/gather_rows.cu        columns gathered through one
                                                     index (host-staged survivors)
    C12 factorize_codes   csrc/factorize_codes.cu    first-occurrence codes of key
                                                     hashes: a hash table of
                                                     each hash's first row, no
                                                     sort
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
                                                     of C5-sorted rows, reading
                                                     C5's sorted key (group_
                                                     stats_pairs, _keys): one
                                                     pass, a look-back
    C18 log_bins          csrc/log_bins.cu           log-binned int and equal-
                                                     width float histograms
                                                     (log_bins_int, _float)
    C19 sweep_stats       csrc/sweep_stats.cu        per-(config, partition)
                                                     sufficient statistics of
                                                     the analysis sweep
    C20 sweep_report      csrc/sweep_report.cu       keep probabilities, report
                                                     rows, bucket sums: a
                                                     tile's in one pass, the
                                                     tiles' in tile order
    C21 combine_shards    csrc/combine_shards.cu     the cross-shard sum of the
                                                     shards' columns read where
                                                     they lie, every column in
                                                     one launch (combine_parts;
                                                     plain, compensated); the
                                                     [D, M] stack entries
                                                     (combine_shards) and K23c's
                                                     heartbeat sum (heartbeat_sum,
                                                     counted collective_heartbeat)
                                                     launch the same kernel
    C22 reshard_count     csrc/reshard_count.cu      destination shard, send
                                                     counts and stable rank of
                                                     every row: one pass, a
                                                     look-back a bucket
    C23 reshard_exchange  csrc/reshard_exchange.cu   every row written to its
                                                     slot on its destination:
                                                     tiles staged in shared
                                                     memory bucket by bucket,
                                                     the padding in the same
                                                     launch
    C24 mesh_factorize    csrc/mesh_factorize.cu     first-occurrence codes of
                                                     row-sharded key hashes:
                                                     C12's table a shard and
                                                     over the gathered uniques
                                                     (no sort), a shard's
                                                     remap

The blocked route (parallel/large_p.py) runs C3 and C7 on windows of the
partition-sorted stream: their windowed entries (base=) rebase each row's
partition to skey2 - base, drop what falls outside the block and take a
null perm for a stream already in sorted order. They count under their
own names (reduce_partitions_windowed, quantile_counts_windowed, ...).

The megabatched service (service/batching.py) adds lane entries, each
counted under its own name: row_keys_lanes, bound_rows_lanes,
reduce_partitions_lanes, release_epilogue_lanes and compact_kept_lanes
run L jobs' rows as one stream of L * n rows and their partitions as one
range of L * P (radix_sort takes the lane as a fourth, most significant
word), each lane equal to its solo run bit for bit. Every dense spec has
them: the total bound (total_bound_keys_lanes, total_bound_rows_lanes),
pre-bounded rows (bound_rows_keyless_lanes), safe mode and vector sums
(reduce_partitions_compensated_lanes, reduce_partitions_vector_lanes),
secure noise (release_epilogue_secure_lanes), the quantile descent in
both regimes (quantile_descend_lanes, quantile_descend_secure_lanes; C7
counts L * P partitions unchanged) and VECTOR_SUM's release
(vector_release_lanes, vector_release_secure_lanes).

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
compensated / secure / lane entry (C4 one launch, C6 one a group of 32
columns, C2, C3 and C17 one after their memsets (C3 one per four
coordinates of a vector sum), C12 four or five after two memsets, a radix
sort one a digit pass after a memset, the masks' launch and copy and one
digit-start launch, C15 one a pass of its plan and one for the split); its
increments are thread-safe, as the
service's workers launch concurrently. No wrapper or kernel keeps host or
device scratch between calls but C4's (its plan, cached under the exact
values it is made of, and a per-stream accumulator of flag bits that
every call leaves zeroed), C6's (its plan, cached per layout, with the
grid sized once a device from the kernel's occupancy) and C8's (above
DESCEND_VALUE_QUANTILES quantiles, their values and order as device
arrays, cached per quantile tuple and device).
"""

import array
import ctypes
import functools
import math
import threading
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
from pipelinedp_tpu_torch.parallel.mesh import MAX_SHARDS, round_capacity

KERNELS = ("row_keys", "bound_rows", "reduce_partitions", "release_epilogue",
           "radix_sort", "compact_kept", "quantile_counts", "quantile_descend",
           "vector_release", "reduce_partitions_compensated",
           "release_epilogue_secure", "quantile_descend_secure",
           "vector_release_secure", "block_offsets", "gather_rows",
           "reduce_partitions_windowed",
           "reduce_partitions_compensated_windowed",
           "quantile_counts_windowed", "quantile_child_counts",
           "quantile_child_counts_windowed", "factorize_codes",
           "lookup_codes",
           "append_rows", "pld_fft", "log_spectrum", "group_stats",
           "log_bins", "sweep_stats", "sweep_report", "row_keys_lanes",
           "bound_rows_lanes", "reduce_partitions_lanes",
           "release_epilogue_lanes", "compact_kept_lanes", "combine_shards",
           "combine_shards_compensated", "reshard_count",
           "reshard_exchange", "total_bound_keys_lanes",
           "total_bound_rows_lanes", "bound_rows_keyless_lanes",
           "reduce_partitions_compensated_lanes",
           "reduce_partitions_vector_lanes", "release_epilogue_secure_lanes",
           "quantile_descend_lanes", "quantile_descend_secure_lanes",
           "vector_release_lanes", "vector_release_secure_lanes",
           "mesh_local_uniques", "mesh_merge_ranks", "mesh_remap_rows",
           "collective_heartbeat", "block_window_offsets", "combine_parts",
           "combine_parts_compensated")
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


# Worker threads of the multi-tenant service launch concurrently.
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            launch_counts[name] = 0


def _count(name: str) -> None:
    """One launch of the named kernel entry (thread-safe)."""
    with _count_lock:
        launch_counts[name] += 1


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    cuda = [t.is_cuda for t in tensors if t is not None]
    if cuda and all(cuda):
        return True
    devices = {t.device.type for t in tensors if t is not None}
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
    """The raw handle of the device's current stream: what
    torch.cuda.current_stream(device).cuda_stream gives, without building
    a Stream object on every launch."""
    index = (device.index if device.index is not None else
             torch.cuda.current_device())
    return torch._C._cuda_getCurrentRawStream(index)


def _launches(device: torch.device, name: str) -> bool:
    """True on a CUDA device (the wrapper launches its kernel), False on
    the CPU (its plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: inputs on {device}; the kernel takes CUDA "
                     f"tensors, the plain version CPU ones")


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
    _count("row_keys")
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
    _count("row_keys")
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
               columns: Sequence[str],
               sorted_k1: Optional[torch.Tensor] = None):
    """Contribution bounding over the row stream in (k1, k2, u) order.

    perm: the sorted order (row index per sorted position). With k1 = k2 =
    perm = None every row is its own pair (contribution bounds already
    enforced) and pk gives its partition. linf: per-pair row cap (0 =
    none); l0: pairs kept per pid (0 = none). scalars = (min_v, max_v,
    min_s, max_s, mid) as Python floats. columns: the reduce columns to
    emit, a subset of ("sum", "nsum", "nsum2"); with values None (standalone
    selection) there are none. sorted_k1: k1[perm], the bounding sort's
    sorted_top, given with k1; the kernel reads it in place of a gather of
    k1.

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
                        (valid, torch.bool, "valid"),
                        (sorted_k1, torch.int64, "sorted_k1")):
        _check(t, dt, n, what)
    if (sorted_k1 is None) != (k1 is None):
        raise ValueError("bound_rows: k1 and sorted_k1 (k1[perm]) come "
                         "together")
    if not _on_cuda(perm, k1, k2, pk, values, valid, sorted_k1):
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
        _ptr(perm), _ptr(sorted_k1), _ptr(k2), _ptr(pk),
        _ptr(values), _ptr(valid),
        n, n_partitions, linf, l0, int(clip_per_value), int(clip_pair_sum),
        scal, _ptr(scratch), _ptr(key2), _ptr(pair_start),
        _ptr(cols.get("sum")), _ptr(cols.get("nsum")),
        _ptr(cols.get("nsum2")), _f64(dtype), _stream(dev))
    _raise_on(status, "bound_rows")
    _count("bound_rows")
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
    _count("bound_rows")
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
    f64, comp = _f64(dtype), int(compensated)
    dim = 0 if vec is None else vec.shape[1]
    # The vector launches run after the scalar one: one scratch serves both.
    scratch_bytes = max(
        lib.reduce_partitions_scratch_bytes(n, f64, comp),
        lib.reduce_vectors_scratch_bytes(n, dim, f64, comp) if dim else 0)
    names = ("count", "pid_count", *row_cols)
    buf, at, scratch, fill = _c3_buffer(names, n_partitions, dtype,
                                        scratch_bytes, dev)
    stream = _stream(dev)
    status = lib.reduce_partitions(
        _ptr(skey2), _ptr(perm), _ptr(pair_start), _ptr(row_cols.get("sum")),
        _ptr(row_cols.get("nsum")), _ptr(row_cols.get("nsum2")), n,
        n_partitions, int(base or 0), scratch, at["count"], fill,
        at["count"], at["pid_count"], at.get("sum"), at.get("nsum"),
        at.get("nsum2"), f64, comp, stream)
    _raise_on(status, "reduce_partitions")
    out = _c3_columns(buf, names, n_partitions, dtype)
    if vec is not None:
        out["vsum"] = torch.empty(n_partitions, dim, dtype=dtype, device=dev)
        status = lib.reduce_vectors(
            _ptr(skey2), _ptr(perm), _ptr(row_perm), _ptr(vec), n, dim,
            n_partitions, int(base or 0), scratch, _ptr(out["vsum"]), f64,
            comp, stream)
        _raise_on(status, "reduce_partitions")
    name = ("reduce_partitions_compensated" if compensated else
            "reduce_partitions")
    _count(name if base is None else f"{name}_windowed")
    return out


def _c3_buffer(names: Sequence[str], n_partitions: int, dtype: torch.dtype,
               scratch_bytes: int, dev: torch.device):
    """C3's outputs and scratch in one allocation: a [len(names),
    n_partitions] block of columns, then the scratch at the next 256-byte
    boundary (the C entry zero-fills the block and the scratch's counters
    and flags in one memset when they are adjacent, as here). Returns the
    buffer, each column's address by name, the scratch's address and the
    bytes to fill."""
    step = n_partitions * dtype.itemsize
    fill = -(-len(names) * step // 256) * 256
    buf = torch.empty(fill + max(1, scratch_bytes), dtype=torch.uint8,
                      device=dev)
    first = buf.data_ptr()
    return (buf, {name: first + i * step for i, name in enumerate(names)},
            first + fill, fill)


def _c3_columns(buf: torch.Tensor, names: Sequence[str], n_partitions: int,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The columns of a _c3_buffer as dtype[n_partitions] views by name,
    made after the launch so that their cost overlaps the kernel."""
    block = buf[:len(names) * n_partitions * dtype.itemsize].view(dtype)
    return dict(zip(names, block.view(len(names), n_partitions).unbind(0)))


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
            # An explicit width: reshape cannot infer -1 from 0 rows.
            cols = values.reshape(values.shape[0],
                                  math.prod(values.shape[1:]))
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


EPILOGUE_MAX_ENTRIES = 8
EPILOGUE_MAX_SLOTS = 8
# Lane key words the C entry carries in the launch's parameters; a larger
# lane table goes up in one pinned copy.
EPILOGUE_LANE_WORDS = 512
_EPILOGUE_COLUMNS = ("count", "pid_count", "sum", "nsum", "nsum2")
_EPILOGUE_OUTPUTS = ("count", "privacy_id_count", "sum", "mean", "variance")


class _EpiloguePlan(ctypes.Structure):
    """C4's Plan (csrc/release_epilogue.cu), field for field: doubles, then
    ints, so neither side pads between them."""
    _fields_ = [("std", ctypes.c_double * EPILOGUE_MAX_SLOTS),
                ("gran", ctypes.c_double * EPILOGUE_MAX_SLOTS),
                ("sel", ctypes.c_double * 14),
                ("mid", ctypes.c_double),
                ("min_v", ctypes.c_double),
                ("max_rows", ctypes.c_double),
                ("n_entries", ctypes.c_int),
                ("kind", ctypes.c_int * EPILOGUE_MAX_ENTRIES),
                ("outputs", ctypes.c_int * EPILOGUE_MAX_ENTRIES),
                ("offset", ctypes.c_int * EPILOGUE_MAX_ENTRIES),
                ("n_slots", ctypes.c_int),
                ("gaussian", ctypes.c_int),
                ("degenerate", ctypes.c_int),
                ("private_selection", ctypes.c_int)]


def release_epilogue_plan(plan, stds, noise_kind: NoiseKind,
                          degenerate: bool, mid: float, min_v: float,
                          selection: Optional[selection_ops.SelectionParams],
                          max_rows: int, gran=None) -> _EpiloguePlan:
    """C4's host plan: the plan entries (kind, output mask, first slot),
    every slot's std and, with secure noise, its grid (gran [S]), the 14
    selection scalars (zeros for public partitions), the noise kind,
    degenerate and private-selection flags, mid, min_v and max_rows; plan
    excludes SKIPPED_KINDS. The keys go apart, in epilogue_lane_table's
    table. Cached under the exact values it is made of, so a release's
    calls share one; the caller must not change it."""
    return _epilogue_plan(
        tuple((kind, tuple(outs), off) for kind, outs, off in plan),
        tuple(float(s) for s in stds), noise_kind, bool(degenerate),
        float(mid), float(min_v), selection, float(max_rows),
        None if gran is None else tuple(float(g) for g in gran))


@functools.lru_cache(maxsize=256)
def _epilogue_plan(plan, stds, noise_kind, degenerate, mid, min_v,
                   selection, max_rows, gran) -> _EpiloguePlan:
    n_slots = len(stds)
    if len(plan) > EPILOGUE_MAX_ENTRIES or n_slots > EPILOGUE_MAX_SLOTS:
        raise ValueError(f"release_epilogue: {len(plan)} entries over "
                         f"{n_slots} noise slots exceed "
                         f"{EPILOGUE_MAX_ENTRIES} / {EPILOGUE_MAX_SLOTS}")
    out = _EpiloguePlan()
    out.n_entries = len(plan)
    out.kind[:len(plan)] = [PLAN_KINDS[kind] for kind, _, _ in plan]
    out.outputs[:len(plan)] = [sum(OUTPUT_BITS[o] for o in outs)
                               for _, outs, _ in plan]
    out.offset[:len(plan)] = [off for _, _, off in plan]
    out.n_slots = n_slots
    out.std[:n_slots] = stds
    if gran is not None:
        out.gran[:n_slots] = gran
    if selection is not None:
        out.sel[:] = selection_ops.selection_scalars(selection)
    out.mid, out.min_v, out.max_rows = mid, min_v, max_rows
    out.gaussian = int(noise_kind == NoiseKind.GAUSSIAN)
    out.degenerate = int(degenerate)
    out.private_selection = int(selection is not None)
    return out


def epilogue_lane_table(slot_keys: np.ndarray,
                        key_sel: Optional[np.ndarray]) -> np.ndarray:
    """C4's key table, u32 [L, 2 + 2S]: each lane's key_sel (zeros without
    selection), then its S slot keys (slot_keys [L, S, 2]); the solo entry
    is one lane. The kernel splits a secure slot's key itself."""
    slot_keys = np.asarray(slot_keys, dtype=np.uint32)
    n_lanes = slot_keys.shape[0]
    table = np.zeros((n_lanes, 2 + slot_keys[0].size), np.uint32)
    if key_sel is not None:
        table[:, :2] = np.asarray(key_sel, dtype=np.uint32).reshape(n_lanes,
                                                                    2)
    table[:, 2:] = slot_keys.reshape(n_lanes, -1)
    return table


_epilogue_lock = threading.Lock()
_epilogue_acc: Dict[Tuple[int, int], torch.Tensor] = {}


def _epilogue_accumulator(dev: torch.device, stream: int,
                          n_lanes: int) -> torch.Tensor:
    """The stream's C4 accumulator, u32 [1 + >= n_lanes] (block tickets,
    then each lane's flag bits): zeroed when made, left zeroed by every
    call, so calls on one stream (which run in order) share it."""
    key = (dev.index if dev.index is not None else
           torch.cuda.current_device(), stream)
    with _epilogue_lock:
        acc = _epilogue_acc.get(key)
        if acc is None or acc.shape[0] < 1 + n_lanes:
            acc = torch.zeros(1 + max(n_lanes, 64), dtype=torch.int32,
                              device=dev)
            _epilogue_acc[key] = acc
    return acc


def _epilogue_outputs(total: int, names: Sequence[str], dtype: torch.dtype,
                      n_lanes: int, dev: torch.device):
    """keep, the outputs and the flag words as views of one allocation:
    rows of a [len(names) + 2, stride] block (each at a 256-byte
    boundary), the outputs', then keep's bytes, then the flag words."""
    size = dtype.itemsize
    width = max(total, n_lanes)
    stride = -(-width * size // 256) * 256 // size
    n = len(names)
    rows = torch.empty((n + 2, stride), dtype=dtype, device=dev)[
        :, :width].unbind(0)
    outputs = rows[:n] if width == total else [r[:total] for r in rows[:n]]
    return (rows[n].view(torch.uint8)[:total].view(torch.bool),
            dict(zip(names, outputs)),
            rows[n + 1].view(torch.int32)[:n_lanes])


def _launch_epilogue(cols, plan_c: _EpiloguePlan, names, total: int,
                     n_lanes: int, dtype: torch.dtype, thr, lane_table):
    """One C4 launch over total = n_lanes * P elements, lane_table
    epilogue_lane_table's. Returns (status, keep, outputs, flags)."""
    dev = cols["count"].device
    stream = _stream(dev)
    keep, outputs, flags = _epilogue_outputs(total, names, dtype, n_lanes,
                                             dev)
    lane_host = lane_dev = 0
    if lane_table.size <= EPILOGUE_LANE_WORDS:
        lane_host = lane_table.ctypes.data
    else:
        pinned = torch.empty(lane_table.shape, dtype=torch.int32,
                             pin_memory=True)
        pinned.numpy()[...] = lane_table.view(np.int32)
        lane_table = pinned.to(dev, non_blocking=True)
        lane_dev = lane_table.data_ptr()
    io = array.array("q", [
        *(cols[c].data_ptr() if c in cols else 0 for c in _EPILOGUE_COLUMNS),
        keep.data_ptr(),
        *(outputs[o].data_ptr() if o in outputs else 0
          for o in _EPILOGUE_OUTPUTS),
        flags.data_ptr(),
        _epilogue_accumulator(dev, stream, n_lanes).data_ptr(),
        0 if thr is None else thr.data_ptr(), lane_host, lane_dev])
    status = cuda_build.library("release_epilogue").release_epilogue(
        ctypes.addressof(plan_c), io.buffer_info()[0], total // n_lanes,
        n_lanes, 0 if thr is None else thr.shape[-1], _f64(dtype), stream)
    return status, keep, outputs, flags


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

    On the card one launch (release_epilogue_plan's Plan, the keys as
    epilogue_lane_table's one row, the outputs as views of one
    allocation, the flag word written whole by the kernel).
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
    secure = tables is not None
    plan_c = release_epilogue_plan(plan, stds, noise_kind, degenerate, mid,
                                   min_v, selection, max_rows,
                                   tables[1] if secure else None)
    keys = epilogue_lane_table(
        np.asarray(slot_keys, dtype=np.uint32).reshape(1, len(stds), 2),
        None if selection is None else key_sel)
    status, keep, outputs, flags = _launch_epilogue(
        cols, plan_c, names, p, 1, dtype, tables[0] if secure else None,
        keys)
    _raise_on(status, "release_epilogue")
    _count("release_epilogue_secure" if secure else "release_epilogue")
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
SORT_MAX_WORDS = cuda_build.SORT_MAX_WORDS
SORT_MAX_RUNS = cuda_build.SORT_MAX_RUNS
SORT_DIGIT_BITS = cuda_build.SORT_DIGIT_BITS


def radix_sort_runs(mask: int) -> Tuple[Tuple[int, int], ...]:
    """The runs (first bit, width) of adjacent set bits of a word's
    varying-bit mask, lowest first, at most 4: where there are more, the
    narrowest constant gap (the lowest of equal ones) is sorted as if it
    varied, until 4 are left. The runs are packed next to each other into
    C5's sort key, so the bits between them cost no pass."""
    mask &= (1 << 64) - 1
    runs = []
    while mask:
        lo = (mask & -mask).bit_length() - 1
        width = (~(mask >> lo) & ((mask >> lo) + 1)).bit_length() - 1
        runs.append([lo, lo + width])
        mask &= ~(((1 << width) - 1) << lo)
    while len(runs) > SORT_MAX_RUNS:
        j = min(range(1, len(runs)),
                key=lambda r: runs[r][0] - runs[r - 1][1])
        runs[j - 1][1] = runs.pop(j)[1]
    return tuple((lo, hi - lo) for lo, hi in runs)


def radix_sort_plan(masks: Sequence[int]) -> Tuple[Tuple[Tuple[int, int],
                                                         ...], ...]:
    """C5's plan: the runs of every word's varying bits (words[0] first;
    no runs for a constant word)."""
    return tuple(radix_sort_runs(int(m)) for m in masks)


class _SortRuns(ctypes.Structure):
    """csrc/radix_sort.cu's Runs: a word's runs and their places in the
    packed key."""
    _fields_ = [("n", ctypes.c_int), ("bits", ctypes.c_int),
                ("lo", ctypes.c_int * SORT_MAX_RUNS),
                ("at", ctypes.c_int * SORT_MAX_RUNS),
                ("mask", ctypes.c_uint64 * SORT_MAX_RUNS),
                ("varying", ctypes.c_uint64)]


class _SortPlan(ctypes.Structure):
    """csrc/radix_sort.cu's Plan: the varying words, least significant
    first, and each word's passes."""
    _fields_ = [("n_words", ctypes.c_int),
                ("word", ctypes.c_int * SORT_MAX_WORDS),
                ("first_pass", ctypes.c_int * SORT_MAX_WORDS),
                ("passes", ctypes.c_int * SORT_MAX_WORDS),
                ("runs", _SortRuns * SORT_MAX_WORDS),
                ("total_passes", ctypes.c_int)]


def _sort_plan(plan) -> _SortPlan:
    """radix_sort_plan's runs laid out as the kernel takes them: each run
    packed above the word's earlier ones, ceil(packed bits / 8) passes a
    word, constant words left out."""
    out = _SortPlan()
    for k in reversed(range(len(plan))):
        if not plan[k]:
            continue
        w = out.n_words
        runs = out.runs[w]
        runs.n = len(plan[k])
        for j, (lo, width) in enumerate(plan[k]):
            mask = (1 << width) - 1
            runs.lo[j], runs.at[j], runs.mask[j] = lo, runs.bits, mask
            runs.varying |= mask << lo
            runs.bits += width
        out.word[w] = k
        out.first_pass[w] = out.total_passes
        out.passes[w] = -(-runs.bits // SORT_DIGIT_BITS)
        out.total_passes += out.passes[w]
        out.n_words += 1
    return out


def radix_sort(words: Sequence[torch.Tensor], sorted_top: bool = False):
    """The stable permutation sorting rows by `words`, most significant
    first (1 to 4 int32 / int64 / float32 / float64 columns of one length;
    the lane-batched release sorts by (lane, k1, k2, u)).

    Integers sort by value; floats by value with -0.0 before +0.0 (the
    sorts of the port see no negative zero or NaN). Returns perm int64[n],
    or (perm, words[0][perm]) with sorted_top. On the card: the masks of
    varying bits (one small copy to the host), radix_sort_plan, then one
    digit-start launch and one Onesweep launch a digit pass.
    """
    if not 1 <= len(words) <= SORT_MAX_WORDS:
        raise ValueError(f"radix_sort takes 1 to {SORT_MAX_WORDS} key words, "
                         f"got {len(words)}")
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
    scratch = torch.empty(max(1, lib.radix_sort_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    # One small copy: the number of passes follows the bits that vary.
    masks = (ctypes.c_ulonglong * len(words))()
    _raise_on(lib.radix_sort_varying(ptrs, kinds, len(words), n,
                                     _ptr(scratch), masks, stream),
              "radix_sort")
    plan = radix_sort_plan(list(masks))
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    top = torch.empty_like(words[0]) if sorted_top else None
    _raise_on(lib.radix_sort(ptrs, kinds, len(words), n,
                             ctypes.byref(_sort_plan(plan)), _ptr(scratch),
                             _ptr(perm), _ptr(top), stream),
              "radix_sort")
    _count("radix_sort")
    return (perm, top) if sorted_top else perm


def radix_sort_plain(words, sorted_top=False):
    perm = torch.arange(words[0].shape[0], device=words[0].device)
    for word in reversed(words):
        perm = perm[torch.argsort(word[perm], stable=True)]
    return (perm, words[0][perm]) if sorted_top else perm


# ---------------------------------------------------------------------------
# C6 compact_kept

# Partitions a C6 tile holds (pdp::kTile of csrc/common.cuh) and output
# columns one launch carries (kMaxColumns of csrc/compact_kept.cu).
COMPACT_TILE = 2048
COMPACT_MAX_COLUMNS = 32
_COMPACT_ALIGN = 256


def compact_kept_grid(items: int, max_blocks: int) -> Tuple[int, int]:
    """C6's grid over `items` tiles when the card holds max_blocks blocks
    at once: (blocks, tiles a block), every block but the last taking the
    same contiguous run."""
    if max_blocks < 1:
        raise ValueError(f"compact_kept: the card holds {max_blocks} blocks")
    run = -(-items // max_blocks)
    return -(-items // run), run


@functools.lru_cache(maxsize=None)
def _compact_max_blocks(device_index: int, elem: int) -> int:
    """The blocks of C6's kernel (elem-byte columns) the card holds at once:
    blocks an SM holds x SMs, asked once a device."""
    with torch.cuda.device(device_index):
        per_sm = cuda_build.library("compact_kept").compact_kept_blocks_per_sm(
            elem)
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"compact_kept: occupancy query failed "
                           f"({per_sm})")
    return per_sm * sms


class _CompactPlan:
    """C6's host plan for one layout: the C entry's words (PlanWord of
    csrc/compact_kept.cu), the size of the call's one allocation, and each
    output's (offset, shape, strides) in elements of its type."""

    def __init__(self, p: int, n_lanes: int, shapes, elem: int,
                 max_blocks: int, solo: bool):
        tiles = max(1, -(-p // COMPACT_TILE))
        grid, run = compact_kept_grid(n_lanes * tiles, max_blocks)
        at = 0

        def region(nbytes):
            nonlocal at
            start = at
            at += -(-nbytes // _COMPACT_ALIGN) * _COMPACT_ALIGN
            return start

        order_at = region(n_lanes * p * 8)
        n_kept_at = region(n_lanes * 8)
        counts_at = region(n_lanes * tiles * 4)
        cols = []
        for shape in shapes:
            width = int(np.prod(shape[1 if solo else 2:], dtype=np.int64))
            cols.append((width, region(n_lanes * p * width * elem), shape))
        self.nbytes = max(at, _COMPACT_ALIGN)
        self.words = array.array("q", [
            p, n_lanes, tiles, run, grid, elem, len(cols), order_at,
            n_kept_at, counts_at] + [v for w, off, _ in cols
                                     for v in (w, off)])
        order_shape = (p,) if solo else (n_lanes, p)
        self.order = (order_at // 8, order_shape, (p, 1)[-len(order_shape):])
        self.n_kept = (n_kept_at // 8, () if solo else (n_lanes,),
                       () if solo else (1,))
        self.columns = [(off // elem, shape,
                         tuple(int(np.prod(shape[d + 1:], dtype=np.int64))
                               for d in range(len(shape))))
                        for _, off, shape in cols]


@functools.lru_cache(maxsize=256)
def _compact_plan(p: int, n_lanes: int, shapes, elem: int, device_index: int,
                  solo: bool) -> _CompactPlan:
    return _CompactPlan(p, n_lanes, shapes, elem,
                        _compact_max_blocks(device_index, elem), solo)


def _compact_outputs(plan: _CompactPlan, columns: Dict[str, torch.Tensor],
                     dev):
    """The call's one allocation (plan.nbytes) and its views: n_kept,
    order and every output column, in the inputs' dtypes and shapes."""
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    words = buf.view(torch.int64)
    typed = {torch.int64: words}
    out = {}
    for (name, col), (off, shape, stride) in zip(columns.items(),
                                                  plan.columns):
        base = typed.get(col.dtype)
        if base is None:
            base = typed[col.dtype] = buf.view(col.dtype)
        out[name] = base.as_strided(shape, stride, off)
    return (buf, words.as_strided(plan.n_kept[1], plan.n_kept[2],
                                  plan.n_kept[0]),
            words.as_strided(plan.order[1], plan.order[2], plan.order[0]),
            out)


def _launch_compact(keep: torch.Tensor, columns: Dict[str, torch.Tensor],
                    shapes, p: int, n_lanes: int, elem: int, solo: bool,
                    name: str):
    """One C6 call: the cached plan, one allocation holding order, n_kept,
    the tile counts and every output column, one ctypes call."""
    dev = keep.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    plan = _compact_plan(p, n_lanes, shapes, elem, index, solo)
    buf, n_kept, order, out = _compact_outputs(plan, columns, dev)
    in_ptrs = array.array("q", [c.data_ptr() for c in columns.values()] or
                          [0])
    status = cuda_build.library("compact_kept").compact_kept(
        keep.data_ptr(), plan.words.buffer_info()[0],
        in_ptrs.buffer_info()[0], buf.data_ptr(), _stream(dev))
    _raise_on(status, name)
    _count(name)
    return n_kept, order, out


def compact_kept(keep: torch.Tensor, columns: Dict[str, torch.Tensor]):
    """Kept-first compaction: order holds the kept ids ascending, then the
    dropped ids ascending (argsort(~keep, stable=True); its kept prefix is
    nonzero(keep)), and every column is gathered into that order. A column
    is [P] or [P, D] (a vector per partition, gathered whole).

    On the card one cooperative launch a group of 32 columns (a plan
    cached per layout; order, n_kept and the columns views of one
    allocation).
    Returns (n_kept int64[], order int64[P], {name: column in order}).
    """
    p = keep.shape[0]
    _check(keep, torch.bool, p, "keep")
    shapes = tuple(tuple(c.shape) for c in columns.values())
    for (name, col), shape in zip(columns.items(), shapes):
        if len(shape) not in (1, 2) or shape[0] != p or \
                not col.is_contiguous():
            raise ValueError(f"{name}: expected contiguous [{p}] or "
                             f"[{p}, D], got {list(shape)}")
    elem = {c.element_size() for c in columns.values()}
    if len(elem) > 1 or not elem <= {4, 8}:
        raise ValueError(f"compact_kept: columns must share a 4- or 8-byte "
                         f"dtype, got {[c.dtype for c in columns.values()]}")
    if not _on_cuda(keep, *columns.values()):
        return compact_kept_plain(keep, columns)
    return _launch_compact(keep, columns, shapes, p, 1,
                           elem.pop() if elem else 8, True, "compact_kept")


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
    _count(_quantile_counts_name(base))
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
    _count("quantile_counts")
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
                          base: Optional[int] = None,
                          leaf: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """C7 (c): for every partition p and quantile q, the counts of the B
    children at `level` (1..h) of node[p, q] (a node of level - 1), over
    the kept rows whose level-`level` node lies under it: int32[P, n_q, B].
    One pass over the rows serves every quantile; the counts equal the JAX
    package's per-quantile segment sums (_lazy_quantile_outputs, :796).
    base: the windowed entry, as for quantile_leaf_counts.

    leaf (the lazy descent's h passes over the same rows): an int32[n]
    buffer, one a sorted row, that the level-1 pass fills with each row's
    leaf (-1 for a row outside [0, P)) and levels 2..h read in place of
    the gather (skey2 and the buffer alone: no permutation, no value).
    None: the level gathers (on the card into a buffer of the call's
    own). Counted as quantile_child_counts (or
    quantile_child_counts_windowed).
    """
    _check_rows(skey2, perm, row_perm, values)
    _check(leaf, torch.int32, skey2.shape[0], "leaf")
    p, n_q = node.shape
    if node.dtype != torch.int32 or not node.is_contiguous():
        raise ValueError(f"node: expected contiguous int32[P, n_q], got "
                         f"{node.dtype}{list(node.shape)}")
    if not 1 <= level <= tree_height:
        raise ValueError(f"level {level} outside 1..{tree_height}")
    if not _on_cuda(skey2, perm, row_perm, values, node, leaf):
        return quantile_child_counts_plain(
            skey2, perm, row_perm, values, node, level=level,
            tree_height=tree_height, branching=branching, min_v=min_v,
            max_v=max_v, base=base, leaf=leaf)
    dev = skey2.device
    counts = torch.zeros(p, n_q, branching, dtype=torch.int32, device=dev)
    mode = 2 if leaf is not None and level > 1 else 1  # read, or fill
    if leaf is None:
        leaf = torch.empty(skey2.shape[0], dtype=torch.int32, device=dev)
    status = cuda_build.library("quantile_counts").quantile_child_counts(
        _ptr(skey2), _ptr(perm), _ptr(row_perm), _ptr(values),
        skey2.shape[0], int(base or 0), p, branching**tree_height,
        branching**(tree_height - level), branching, _ptr(node), n_q,
        float(min_v), float(max_v), _ptr(counts), _ptr(leaf), mode,
        _f64(values.dtype), _stream(dev))
    name = ("quantile_child_counts" if base is None else
            "quantile_child_counts_windowed")
    _raise_on(status, name)
    _count(name)
    return counts


def quantile_child_counts_plain(skey2, perm, row_perm, values, node, *,
                                level, tree_height, branching, min_v, max_v,
                                base=None, leaf=None):
    p_all, n_q = node.shape
    n_leaves = branching**tree_height
    rel = skey2.to(torch.int64) - (base or 0)
    kept = (rel >= 0) & (rel < p_all)
    if leaf is not None and level > 1:
        row_leaf = leaf.to(torch.int64)
    else:
        row_leaf = leaf_indices(sorted_rows(perm, row_perm, values), min_v,
                                max_v, n_leaves)
        if leaf is not None:
            leaf.copy_(torch.where(kept, row_leaf, -1))
    p, row_leaf = rel[kept], row_leaf[kept]
    row_node = row_leaf // branching**(tree_height - level)
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


def _check_descend(keep, flags, quantiles, tree_height, branching,
                   n_lanes: int = 1):
    """The tree's shape limits hold on both paths, so the card and the CPU
    serve the same requests; DPEngine.aggregate always builds the default
    tree (height 4, branching 16). flags: one word a lane."""
    _check(flags, torch.int32, n_lanes, "flags")
    if not quantiles or not 1 <= tree_height <= 8 or \
            not 2 <= branching <= 64:
        raise ValueError(f"quantile_descend takes at least one quantile, "
                         f"height 1-8 and branching 2-64, got "
                         f"{len(quantiles)}, {tree_height}, {branching}")
    _check(keep, torch.bool, keep.shape[0], "keep")


# Quantiles (and lane key words) that C8's launch parameters carry by
# value; more go up once as device arrays (quantiles: cached per tuple and
# device) or, for the keys, in one pinned copy.
DESCEND_VALUE_QUANTILES = cuda_build.DESCEND_VALUE_QUANTILES
DESCEND_LANE_WORDS = cuda_build.DESCEND_LANE_WORDS


@functools.lru_cache(maxsize=256)
def _descend_host_quantiles(quantiles: Tuple[float, ...]):
    """The quantiles and their stable ascending order as ctypes arrays."""
    order = np.argsort(np.asarray(quantiles), kind="stable")
    return ((ctypes.c_double * len(quantiles))(*quantiles),
            (ctypes.c_int * len(quantiles))(*[int(j) for j in order]))


def _pinned_upload(values: np.ndarray, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """values on device, through pinned memory and a copy that does not
    synchronize (the host allocator keeps the pinned block until the copy
    has run)."""
    pinned = torch.empty(values.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = values
    return pinned.to(device, non_blocking=True)


@functools.lru_cache(maxsize=64)
def _descend_device_quantiles(quantiles: Tuple[float, ...],
                              device: torch.device):
    """(q float64, order int32) on device for a tuple above
    DESCEND_VALUE_QUANTILES, uploaded once, and the event after the copy
    that a call on another stream waits for."""
    order = np.argsort(np.asarray(quantiles), kind="stable")
    q = _pinned_upload(np.asarray(quantiles, np.float64), torch.float64,
                       device)
    order_t = _pinned_upload(order.astype(np.int32), torch.int32, device)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return q, order_t, ready


def _descend_device_arrays(quantiles: Tuple[float, ...],
                           device: torch.device) -> Tuple[int, int]:
    """The device pointers of _descend_device_quantiles' arrays, the
    current stream made to wait for their upload."""
    q, order, ready = _descend_device_quantiles(quantiles, device)
    torch.cuda.current_stream(device).wait_event(ready)
    return q.data_ptr(), order.data_ptr()


def _descend_params(quantiles, std, gaussian, min_v, max_v, tree_height,
                    branching, device):
    """C8's parameters: the quantiles and their order as host arrays (the
    launch's parameters carry up to DESCEND_VALUE_QUANTILES of them) and,
    above that, device arrays (0 below it); the scalars on the host."""
    quantiles = tuple(float(q) for q in quantiles)
    q_host, order_host = _descend_host_quantiles(quantiles)
    q_dev = order_dev = 0
    if len(quantiles) > DESCEND_VALUE_QUANTILES:
        q_dev, order_dev = _descend_device_arrays(quantiles, device)
    return (q_host, order_host, q_dev, order_dev,
            (ctypes.c_double * 3)(float(std), float(min_v), float(max_v)),
            (ctypes.c_int * 4)(len(quantiles), tree_height, branching,
                               int(gaussian)))


def _descend_lane_keys(table: np.ndarray, device: torch.device):
    """C8's lane key table, u32 [L, words]: (host pointer, 0, the array) by
    value up to DESCEND_LANE_WORDS words, else (0, device pointer, the
    device copy) through one pinned copy. Keep the third item alive until
    the launch."""
    table = np.ascontiguousarray(table, dtype=np.uint32)
    if table.size <= DESCEND_LANE_WORDS:
        return table.ctypes.data, 0, table
    dev_table = _pinned_upload(table.view(np.int32), torch.int32, device)
    return 0, dev_table.data_ptr(), dev_table


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
    ptrs = (ctypes.c_void_p * tree_height)(*[t.data_ptr() for t in levels])
    keys = (ctypes.c_uint * (2 * tree_height))(
        *[int(w) for w in np.asarray(level_keys).reshape(-1)])
    params = _descend_params(quantiles, std, gaussian, min_v, max_v,
                             tree_height, branching, dev)
    secure = thr is not None
    status = cuda_build.library("quantile_descend").quantile_descend_dense(
        ptrs, p, *params, keys, _ptr(keep), _ptr(leaves), _ptr(out),
        _ptr(flags), _ptr(thr), thr.shape[0] if secure else 0,
        float(tables[1]) if secure else 0.0, _f64(dtype), _stream(dev))
    _raise_on(status, "quantile_descend")
    _count("quantile_descend_secure" if secure else "quantile_descend")
    return out


def quantile_descend_dense_plain(levels, quantiles, *, std, level_keys,
                                 gaussian, min_v, max_v, keep, flags, dtype,
                                 leaves=None, tables=None):
    p, branching = levels[0].shape
    n_q = len(quantiles)
    dev = keep.device
    if p == 0:
        # No partition (public_partitions=[]): nothing to descend, as C8's
        # entry returns at once.
        return torch.empty(n_q, 0, dtype=dtype, device=dev)
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
    params = _descend_params(quantiles, std, gaussian, min_v, max_v,
                             tree_height, branching, dev)
    status = cuda_build.library("quantile_descend").quantile_descend_step(
        _ptr(counts), p, level, *params, int(level_key[0]),
        int(level_key[1]), _ptr(state.node), _ptr(state.target),
        _ptr(state.total), _ptr(state.mass), _ptr(keep), _ptr(out),
        _ptr(flags), _ptr(thr), 0 if thr is None else thr.shape[0],
        0.0 if thr is None else float(tables[1]), _f64(dtype), _stream(dev))
    _raise_on(status, "quantile_descend")
    _count("quantile_descend" if thr is None else "quantile_descend_secure")
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
    _count("vector_release" if thr is None else "vector_release_secure")
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
    count, offsets[-1] is the number of surviving rows. For boundaries of
    the block arithmetic, block_window_offsets makes them in the kernel."""
    if stream.dtype is not torch.int32 or boundaries.dtype is not \
            torch.int32 or stream.dim() != 1 or boundaries.dim() != 1 or \
            not stream.is_contiguous() or not boundaries.is_contiguous():
        raise ValueError(f"block_offsets: expected contiguous int32[n] "
                         f"stream and boundaries, got {stream.dtype}"
                         f"{list(stream.shape)} and {boundaries.dtype}"
                         f"{list(boundaries.shape)}")
    dev = stream.device
    if boundaries.device != dev:
        raise ValueError(f"kernel inputs must all lie on one device, got "
                         f"{dev} and {boundaries.device}")
    if not _launches(dev, "block_offsets"):
        return block_offsets_plain(stream, boundaries)
    m = boundaries.shape[0]
    offsets = stream.new_empty(m, dtype=torch.int64)
    status = cuda_build.library("block_offsets").block_offsets(
        stream.data_ptr(), stream.shape[0], boundaries.data_ptr(), m,
        offsets.data_ptr(), _stream(dev))
    _raise_on(status, "block_offsets")
    _count("block_offsets")
    return offsets


def block_offsets_plain(stream, boundaries):
    return torch.searchsorted(stream, boundaries, side="left")


BLOCK_WINDOW_MAX_STREAMS = 64  # csrc/block_offsets.cu kMaxStreams


def block_window_offsets(streams: Sequence[torch.Tensor], base: int,
                         capacity: int, n_blocks: int,
                         end: int) -> torch.Tensor:
    """The row windows of n_blocks blocks of `capacity` partitions from
    `base` in each of S ascending int32 streams of one device, in one
    launch: out[s, b] = the first position of streams[s] holding a value
    >= min(base + b * capacity, INT32_MAX, end), b in 0..n_blocks, as
    int64[S, n_blocks + 1]. The boundaries are block_window_boundaries
    (the sentinel partition `end` lies in no window); the kernel makes
    them, so nothing is uploaded."""
    n_streams = len(streams)
    if not 1 <= n_streams <= BLOCK_WINDOW_MAX_STREAMS or n_blocks < 0:
        raise ValueError(f"block_window_offsets: 1 to "
                         f"{BLOCK_WINDOW_MAX_STREAMS} streams and n_blocks "
                         f">= 0, got {n_streams} and {n_blocks}")
    dev = streams[0].device
    for t in streams:
        if t.dtype is not torch.int32 or t.dim() != 1 or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError(f"block_window_offsets: expected contiguous "
                             f"int32 streams on {dev}, got {t.dtype}"
                             f"{list(t.shape)} on {t.device}")
    if not _launches(dev, "block_window_offsets"):
        return block_window_offsets_plain(streams, base, capacity, n_blocks,
                                          end)
    out = streams[0].new_empty((n_streams, n_blocks + 1), dtype=torch.int64)
    table = array.array("q", [t.data_ptr() for t in streams] +
                        [t.shape[0] for t in streams])
    status = cuda_build.library("block_offsets").block_window_offsets(
        table.buffer_info()[0], n_streams, int(base), int(capacity),
        int(n_blocks), int(end), out.data_ptr(), _stream(dev))
    _raise_on(status, "block_window_offsets")
    _count("block_window_offsets")
    return out


def block_window_boundaries(base: int, capacity: int, n_blocks: int, end: int,
                            device=None) -> torch.Tensor:
    """The block boundaries over [base, base + n_blocks * capacity],
    clamped into int32 range and to `end`: min(base + b * capacity,
    INT32_MAX, end) for b in 0..n_blocks, as int32[n_blocks + 1]
    (np.minimum(_block_boundaries(...), end) of the JAX package's
    large_p.py:811-818)."""
    b = int(base) + torch.arange(n_blocks + 1, dtype=torch.int64,
                                 device=device) * int(capacity)
    return b.clamp(max=min(_INT32_MAX, int(end))).to(torch.int32)


def block_window_offsets_plain(streams, base, capacity, n_blocks, end):
    bounds = block_window_boundaries(base, capacity, n_blocks, end,
                                     streams[0].device)
    return torch.stack([torch.searchsorted(t, bounds, side="left")
                        for t in streams])


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
    _count("gather_rows")
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


FACTORIZE_MIN_SLOTS = 64
# Slots a key probes before C12 reports its table too small. At a load of
# 1/2 a linear-probe run that long has odds of about 0.82^1024 a row.
FACTORIZE_MAX_PROBES = 1024


def factorize_table_plan(n: int,
                         n_distinct: Optional[int] = None) -> Tuple[int, int]:
    """C12's hash table for n hash rows: (slots, probe bound). The slots are
    the smallest power of two holding twice the distinct hashes (n_distinct,
    the count the ingest's unique merge already holds, else n, which bounds
    it; at least FACTORIZE_MIN_SLOTS), so the table is at most half full; a
    key probes at most min(slots, FACTORIZE_MAX_PROBES) slots before the
    kernel reports the table too small. n_distinct: a non-negative int."""
    if n_distinct is not None and (
            isinstance(n_distinct, bool) or
            not isinstance(n_distinct, (int, np.integer)) or n_distinct < 0):
        raise ValueError(f"factorize_codes: n_distinct must be a "
                         f"non-negative int or None, got {n_distinct!r}")
    keys = n if n_distinct is None else min(int(n_distinct), n)
    slots = max(FACTORIZE_MIN_SLOTS, 1 << (2 * max(1, keys) - 1).bit_length())
    return slots, min(slots, FACTORIZE_MAX_PROBES)


def factorize_codes(rows: torch.Tensor, n_distinct: Optional[int] = None):
    """First-occurrence dense codes of the rows' 64-bit key hashes: a row's
    code is the rank of its hash among the distinct non-sentinel hashes
    ordered by first row, valid rows or not; sentinel and invalid rows
    code to -1 (the JAX package's device_encode.factorize_codes).

    On the card: no sort; a hash table keeps each distinct hash with its
    smallest row (factorize_table_plan sizes it from n_distinct, the
    distinct count the caller already knows, else from the rows), then a
    row bitmap of those smallest rows, its look-back scan and one pass
    writing the codes. Returns (codes int32[n], n_unique int32[] on the
    rows' device); on the card n_unique is -1 where n_distinct was too
    small for the table to hold every distinct hash (the codes are then
    undefined: the caller raises). The plain version validates n_distinct
    and otherwise ignores it."""
    _check_hash_rows(rows)
    slots, probes = factorize_table_plan(rows.shape[0], n_distinct)
    if not _on_cuda(rows):
        return factorize_codes_plain(rows)
    status, codes, n_unique, _ = _factorize_launch(rows, slots, probes)
    _raise_on(status, "factorize_codes")
    _count("factorize_codes")
    return codes, n_unique


def _factorize_launch(rows: torch.Tensor, slots: int, probes: int,
                      heads_cap: int = 0):
    """One C12 call on the card: (status, codes, n_unique, heads), heads
    the int32 [heads_cap, 3] table at the front of the call's scratch
    (None without one)."""
    n = rows.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"factorize_codes: {n} rows exceed 2^31")
    dev = rows.device
    lib = cuda_build.library("factorize_codes")
    scratch = torch.empty(
        max(1, lib.factorize_codes_scratch_bytes(n, slots, heads_cap)),
        dtype=torch.uint8, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    n_unique = torch.empty((), dtype=torch.int32, device=dev)
    status = lib.factorize_codes(_ptr(rows), n, slots, probes, _ptr(scratch),
                                 _ptr(codes), _ptr(n_unique), heads_cap,
                                 _stream(dev))
    heads = (scratch[:heads_cap * 12].view(torch.int32).view(heads_cap, 3)
             if heads_cap else None)
    return status, codes, n_unique, heads


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
    _count("lookup_codes")
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


@functools.lru_cache(maxsize=256)
def _column_words(layout) -> Tuple[int, ...]:
    """(width, element bytes, the pad's bit pattern as a signed word) of
    each column of `layout`, ((dtype, width, pad, sign of the pad), ...):
    built once a layout."""
    words = []
    for dtype, width, fill, _ in layout:
        bits = _fill_bits(fill, dtype)
        words += [width, dtype.itemsize,
                  bits - (1 << 64) if bits >= 1 << 63 else bits]
    return tuple(words)


def _launch_rows(bufs, srcs, fills, copy_rows: int, fill_begin: int,
                 fill_end: int) -> None:
    """One C14 launch: rows [0, copy_rows) of each source into its buffer,
    rows [fill_begin, fill_end) the pad."""
    dev = bufs[0].device
    # The sign tells 0.0 from -0.0, which compare (and hash) equal.
    static = _column_words(tuple(
        (b.dtype, 1 if b.dim() == 1 else b.shape[1], f,
         math.copysign(1.0, float(f))) for b, f in zip(bufs, fills)))
    table = array.array("q")
    for j, b in enumerate(bufs):
        table.extend((b.data_ptr(), srcs[j].data_ptr() if srcs else 0) +
                     static[3 * j:3 * j + 3])
    status = cuda_build.library("append_rows").append_rows(
        table.buffer_info()[0], len(bufs), copy_rows, fill_begin, fill_end,
        _stream(dev))
    _raise_on(status, "append_rows")
    _count("append_rows")


def fill_tail(bufs: Sequence[torch.Tensor], start: int,
              fills: Sequence) -> None:
    """Writes each buffer's pad value over its rows [start, cap), in place
    (C14, one launch for all buffers)."""
    cap = _check_buffers(bufs, fills)
    if not 0 <= start <= cap:
        raise ValueError(f"fill_tail: start {start} outside [0, {cap}]")
    if not _on_cuda(*bufs):
        return fill_tail_plain(bufs, start, fills)
    if start == cap:
        return  # no tail: nothing to launch
    _launch_rows(bufs, None, fills, 0, start, cap)


def fill_tail_plain(bufs, start, fills):
    for b, f in zip(bufs, fills):
        b[start:] = f


def grow_rows(bufs: Sequence[torch.Tensor], new_cap: int,
              fills: Sequence) -> List[torch.Tensor]:
    """New buffers of new_cap rows holding each old buffer's rows, their
    rows past the old capacity at the pad value (C14, one launch for all
    buffers)."""
    cap = _check_buffers(bufs, fills)
    if new_cap < cap:
        raise ValueError(f"grow_rows: new capacity {new_cap} < {cap}")
    if not _on_cuda(*bufs):
        return grow_rows_plain(bufs, new_cap, fills)
    out = [torch.empty((new_cap,) + tuple(b.shape[1:]), dtype=b.dtype,
                       device=b.device) for b in bufs]
    _launch_rows(out, bufs, fills, cap, cap, new_cap)
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


_FFT_MAX_LOG_FACTOR = 11  # C15's passes: factors of at most 2048
_FFT_MAX_PASSES = 3


def pld_fft_plan(n: int) -> Tuple[int, ...]:
    """C15's plan for a complex transform of length n (a power of two):
    its passes' factors, powers of two of at most 2048 whose product is n,
    as even as they can be, the larger first. One pass up to n = 2048, two
    up to 2^22, three up to 2^33; () for n = 1 (the split alone)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"pld_fft_plan: n must be a power of two >= 1, "
                         f"got {n}")
    log_n = n.bit_length() - 1
    passes = -(-log_n // _FFT_MAX_LOG_FACTOR)
    if passes > _FFT_MAX_PASSES:
        raise ValueError(f"pld_fft_plan: n = 2^{log_n} needs more than "
                         f"{_FFT_MAX_PASSES} passes of <= 2048")
    logs = [log_n // passes + (i < log_n % passes) for i in range(passes)]
    return tuple(1 << lg for lg in logs)


def _fft_plan_args(n: int) -> Tuple[Tuple[int, ...], List[int]]:
    plan = pld_fft_plan(n)
    return plan, list(plan) + [1] * (_FFT_MAX_PASSES - len(plan))


def pld_rfft(x: torch.Tensor) -> torch.Tensor:
    """torch.fft.rfft(x, dim=1) of float64[rows, L], L a power of two >= 2:
    complex128[rows, L / 2 + 1] (C15's forward entry)."""
    _check_2d(x, torch.float64, "pld_rfft")
    rows, length = x.shape
    _check_fft_length(length)
    if not _on_cuda(x):
        return pld_rfft_plain(x)
    n = length // 2
    plan, factors = _fft_plan_args(n)
    dev = x.device
    out = torch.empty((rows, n + 1), dtype=torch.complex128, device=dev)
    # Three passes need a buffer besides the output (kernel header).
    work = (torch.empty((rows, n), dtype=torch.complex128, device=dev)
            if len(plan) >= 3 else None)
    status = cuda_build.library("pld_fft").pld_rfft(
        _ptr(x), rows, n, *factors, _ptr(out), _ptr(work), _stream(dev))
    _raise_on(status, "pld_fft")
    _count("pld_fft")
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
    plan, factors = _fft_plan_args(n)
    dev = spectrum.device
    out = torch.empty((rows, length), dtype=torch.float64, device=dev)
    # Two passes or more need a buffer besides the output.
    work = (torch.empty((rows, n), dtype=torch.complex128, device=dev)
            if len(plan) >= 2 else None)
    status = cuda_build.library("pld_fft").pld_irfft(
        _ptr(spectrum), rows, n, *factors, _ptr(out), _ptr(work),
        _stream(dev))
    _raise_on(status, "pld_fft")
    _count("pld_fft")
    return out


def pld_irfft_plain(spectrum, length):
    return torch.fft.irfft(spectrum, n=length, dim=1)


# C15's arithmetic step by step (csrc/pld_fft.cu): the same plan, the same
# Stockham passes and in-block stages, twiddles of the same exact ratios
# (cos / sin of pi times them here, sincospi there) and the same split.
# Not the plain version: the tests hold it against numpy, chip_smoke.py
# holds the kernel against it.


def _twiddles(e: torch.Tensor, m: int, inverse: bool) -> torch.Tensor:
    """exp(-+2 pi i e / m) of integer exponents e in [0, m)."""
    t = math.pi * (2.0 * e.to(torch.float64) / m)
    return torch.complex(torch.cos(t), torch.sin(t) if inverse else
                         -torch.sin(t))


def _rot(w: torch.Tensor, inverse: bool) -> torch.Tensor:
    """w times -i (forward) or +i (inverse)."""
    return (torch.complex(-w.imag, w.real) if inverse else
            torch.complex(w.imag, -w.real))


def _tw_of(table: torch.Tensor, e, log_r: int, inverse: bool):
    """W_R^e from the quarter table W_R^e', e' < R / 4, rotated by
    (-+i)^(e / (R / 4)) (csrc/pld_fft.cu tw_of)."""
    e = torch.as_tensor(e)
    w = table[e & ((1 << (log_r - 2)) - 1)]
    q = e >> (log_r - 2)
    h = torch.where(q & 1 == 1, _rot(w, inverse), w)
    return torch.where(q & 2 == 2, -h, h)


def _dft4(a0, a1, a2, a3, inverse):
    t0, t1 = a0 + a2, a0 - a2
    t2, t3 = a1 + a3, _rot(a1 - a3, inverse)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _dft_q(u, log_q: int, table, log_r: int, inverse: bool):
    """The Q-point DFT of u[t], t < Q (a list of tensors), as the kernel's
    registers take it: Q = 8 as 4 x 2, Q = 16 as 4 x 4 (inner DFTs over
    u[q2 n1 + n2], twiddles W_Q^(n2 k1), outer DFTs to X[k1 + 4 k2])."""
    if log_q == 1:
        return [u[0] + u[1], u[0] - u[1]]
    if log_q == 2:
        return _dft4(*u, inverse)
    q2 = 1 << (log_q - 2)
    y = [_dft4(*[u[q2 * n1 + n2] for n1 in range(4)], inverse)
         for n2 in range(q2)]
    for n2 in range(1, q2):
        for k1 in range(1, 4):
            y[n2][k1] = y[n2][k1] * _tw_of(
                table, (n2 * k1) << (log_r - log_q), log_r, inverse)
    if q2 == 2:
        return ([y[0][k1] + y[1][k1] for k1 in range(4)] +
                [y[0][k1] - y[1][k1] for k1 in range(4)])
    outer = [_dft4(*[y[n2][k1] for n2 in range(4)], inverse)
             for k1 in range(4)]
    return [outer[k1][k2] for k2 in range(4) for k1 in range(4)]


def _block_dft(s: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The R-point DFT along the last dimension as a block of C15 takes it:
    Stockham stages of radix 16 while four bits remain, then one of radix
    2, 4 or 8; stage twiddles W_{Q sub}^(t (jj mod sub)) from the quarter
    table of W_R."""
    r_len = s.shape[-1]
    lead = s.shape[:-1]
    log_r = r_len.bit_length() - 1
    table = (_twiddles(torch.arange(max(1, r_len // 4)), r_len, inverse)
             if log_r >= 2 else None)
    log_s = 0
    while log_s < log_r:
        log_q = min(4, log_r - log_s)
        q, span, sub = 1 << log_q, r_len >> log_q, 1 << log_s
        v = s.reshape(*lead, q, span)  # v[t, jj] = s[jj + t span]
        u = [v[..., t, :] for t in range(q)]
        if log_s > 0:
            k = torch.arange(span) % sub
            for t in range(1, q):
                u[t] = u[t] * _tw_of(table, (t * k) << (log_r - log_q - log_s),
                                     log_r, inverse)
        x = torch.stack(_dft_q(u, log_q, table, log_r, inverse), -2)
        # Position (jj / sub) q sub + t sub + jj mod sub.
        x = x.reshape(*lead, q, span // sub, sub).transpose(-3, -2)
        s = x.reshape(*lead, r_len)
        log_s += log_q
    return s


def _fft_passes(z: torch.Tensor, plan: Sequence[int],
                inverse: bool) -> torch.Tensor:
    """The complex FFT of z[rows, n] through plan's Stockham passes."""
    rows, n = z.shape
    ns = 1
    for r_len in plan:
        m = n // r_len
        v = z.reshape(rows, r_len, m)  # v[:, r, j] = z[j + r m]
        if ns > 1:
            e = torch.arange(r_len)[:, None] * (torch.arange(m) % ns)[None, :]
            v = v * _twiddles(e, ns * r_len, inverse)
        v = _block_dft(v.transpose(1, 2), inverse)  # [rows, j, r]
        # Line j = a ns + b writes r at a ns R + r ns + b.
        v = v.reshape(rows, m // ns, ns, r_len).permute(0, 1, 3, 2)
        z = v.reshape(rows, n)
        ns *= r_len
    return z


def pld_rfft_four_step(x: torch.Tensor,
                       plan: Optional[Sequence[int]] = None) -> torch.Tensor:
    """C15's forward entry modelled in PyTorch (float64[rows, L] ->
    complex128[rows, L / 2 + 1]): packing, the plan's passes, the split."""
    rows, length = x.shape
    n = length // 2
    plan = pld_fft_plan(n) if plan is None else tuple(plan)
    if math.prod(plan) != n:
        raise ValueError(f"plan {plan} is not a factorisation of {n}")
    z = _fft_passes(torch.complex(x[:, 0::2], x[:, 1::2]), plan, False)
    out = torch.empty((rows, n + 1), dtype=torch.complex128)
    out[:, 0] = torch.complex(z[:, 0].real + z[:, 0].imag,
                              torch.zeros(rows, dtype=torch.float64))
    out[:, n] = torch.complex(z[:, 0].real - z[:, 0].imag,
                              torch.zeros(rows, dtype=torch.float64))
    k = torch.arange(1, n // 2 + 1)
    if k.numel():
        a, b = z[:, k], z[:, n - k].conj()
        e, d = (a + b) * 0.5, (a - b) * 0.5
        t = _twiddles(k, 2 * n, False) * torch.complex(d.imag, -d.real)
        out[:, k] = e + t
        inner = k < n - k
        out[:, n - k[inner]] = (e - t)[:, inner].conj()
    return out


def pld_irfft_four_step(spectrum: torch.Tensor, length: int,
                        plan: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """C15's inverse entry modelled in PyTorch (complex128[rows, L / 2 + 1]
    -> float64[rows, L]): the pre-pass (scaled by 1 / n), the plan's
    inverse passes, the packed words read back as reals."""
    rows = spectrum.shape[0]
    n = length // 2
    plan = pld_fft_plan(n) if plan is None else tuple(plan)
    if math.prod(plan) != n:
        raise ValueError(f"plan {plan} is not a factorisation of {n}")
    inv_n = 1.0 / n
    z = torch.empty((rows, n), dtype=torch.complex128)
    a0, an = spectrum[:, 0].real, spectrum[:, n].real
    z[:, 0] = torch.complex((a0 + an) * 0.5 * inv_n, (a0 - an) * 0.5 * inv_n)
    k = torch.arange(1, n // 2 + 1)
    if k.numel():
        a, b = spectrum[:, k], spectrum[:, n - k].conj()
        e, d = (a + b) * 0.5, (a - b) * 0.5
        o = d * _twiddles(k, 2 * n, True)
        z[:, k] = torch.complex((e.real - o.imag) * inv_n,
                                (e.imag + o.real) * inv_n)
        inner = k < n - k
        z[:, n - k[inner]] = torch.complex(
            (e.real + o.imag) * inv_n, (o.real - e.imag) * inv_n)[:, inner]
    z = _fft_passes(z, plan, True)
    return torch.view_as_real(z).reshape(rows, length)


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
    _count("log_spectrum")


# torch's intra-op grain: a CPU elementwise call over at most this many
# elements runs on the calling thread, in one piece.
_INLINE_ELEMENTS = 32768


def _inline(op, x: torch.Tensor) -> torch.Tensor:
    """op(x) of an elementwise torch op; on the CPU in pieces of
    _INLINE_ELEMENTS, each run on the calling thread. A call over the
    whole tensor is split over the intra-op thread team, and on a loaded
    machine the process's first such calls of torch.log gave a few
    elements other bits than every later call did, enough to move an
    epsilon bisection by a step (tests/test_torch_pld.py's composition
    of counts [2, 3, 1, 2]); in pieces, every call gives the bits the
    later whole-tensor calls give."""
    if x.is_cuda:
        return op(x)
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=op(flat[:1]).dtype)
    for at in range(0, flat.shape[0], _INLINE_ELEMENTS):
        out[at:at + _INLINE_ELEMENTS] = op(flat[at:at + _INLINE_ELEMENTS])
    return out.view(x.shape)


def log_spectrum_accumulate_plain(spectra, weights, acc):
    w = weights[:, None]
    re = (w * _inline(torch.log, torch.abs(spectra))).sum(0)
    im = (w * _inline(torch.angle, spectra)).sum(0)
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
    _count("log_spectrum")
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
                      perm: torch.Tensor,
                      sorted_pid: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """The per-pair and per-pid statistics of rows sorted by (pid, pk)
    (perm: the stable order with invalid rows' keys at INT32_MAX), in
    sorted order, each at its group's first row and 0 elsewhere: new_pair,
    new_pid (bool), pair_len, l1, l0 (int32), pair_sum (float32, added in
    row order from 0), pair_pk (the pk of each pair start, INT32_MAX
    elsewhere) (C17's pairs entry). pid, pk int32[n]; values float32[n] or
    None (sums 0); valid bool[n]; perm int64[n]; sorted_pid:
    sunk_keys(pid, valid)[perm], the sort's sorted_top, which the kernel
    reads in place of a gather of pid (required on the card; the plain
    version checks its shape only)."""
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(pk, torch.int32, n, "pk")
    _check(values, torch.float32, n, "values")
    _check(valid, torch.bool, n, "valid")
    _check(perm, torch.int64, n, "perm")
    _check(sorted_pid, torch.int32, n, "sorted_pid")
    if not _on_cuda(pid, pk, values, valid, perm, sorted_pid):
        return group_stats_pairs_plain(pid, pk, values, valid, perm)
    if sorted_pid is None:
        raise ValueError("group_stats_pairs: on the card sorted_pid "
                         "(sunk_keys(pid, valid)[perm], the sort's "
                         "sorted_top) is required")
    dev = pid.device
    lib = cuda_build.library("group_stats")
    scratch = torch.empty(max(1, lib.group_stats_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    out = {name: torch.empty(n, dtype=dtype, device=dev)
           for name, dtype in zip(PAIR_STATS, (
               torch.bool, torch.bool, torch.int32, torch.float32,
               torch.int32, torch.int32, torch.int32))}
    status = lib.group_stats_pairs(
        _ptr(perm), _ptr(sorted_pid), _ptr(pk), _ptr(values), _ptr(valid),
        n, _ptr(scratch), *[_ptr(out[name]) for name in PAIR_STATS],
        _stream(dev))
    _raise_on(status, "group_stats")
    _count("group_stats")
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
                     perm: torch.Tensor,
                     sorted_keys: Optional[torch.Tensor] = None):
    """The first valid row of each key of a stream sorted by `keys` (perm:
    the stable order) and that key's run length there, 0 elsewhere, in
    sorted order: (new_seg bool[n], seg_len int32[n]) (C17's keys entry).
    Every invalid row is a run of its own. sorted_keys: keys[perm], the
    sort's sorted_top, which the kernel reads in place of a gather of keys
    (required on the card; the plain version checks its shape only)."""
    n = keys.shape[0]
    _check(keys, torch.int32, n, "keys")
    _check(valid, torch.bool, n, "valid")
    _check(perm, torch.int64, n, "perm")
    _check(sorted_keys, torch.int32, n, "sorted_keys")
    if not _on_cuda(keys, valid, perm, sorted_keys):
        return group_stats_keys_plain(keys, valid, perm)
    if sorted_keys is None:
        raise ValueError("group_stats_keys: on the card sorted_keys "
                         "(keys[perm], the sort's sorted_top) is required")
    dev = keys.device
    lib = cuda_build.library("group_stats")
    scratch = torch.empty(max(1, lib.group_stats_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    new_seg = torch.empty(n, dtype=torch.bool, device=dev)
    seg_len = torch.empty(n, dtype=torch.int32, device=dev)
    status = lib.group_stats_keys(_ptr(perm), _ptr(sorted_keys), _ptr(valid),
                                  n, _ptr(scratch), _ptr(new_seg),
                                  _ptr(seg_len), _stream(dev))
    _raise_on(status, "group_stats")
    _count("group_stats")
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


# An integer stat's packed output (csrc/log_bins.cu): counts, sums
# int64[LOG_BIN_SLOTS], n_bins int64, lowers, uppers, maxes
# int32[LOG_BIN_SLOTS].
LOG_BINS_RECORD = 28 * LOG_BIN_SLOTS + 8
LOG_BINS_MAX_STATS = cuda_build.LOG_BINS_MAX_STATS


def log_bins_int_unpack(packed: torch.Tensor):
    """The (lowers, uppers, counts, sums, maxes, n_bins) of each record of
    packed uint8 [S, LOG_BINS_RECORD] (log_bins_int_many's result, on any
    device), as views of it."""
    if packed.dtype != torch.uint8 or packed.dim() != 2 or \
            packed.shape[1] != LOG_BINS_RECORD or not packed.is_contiguous():
        raise ValueError(f"log_bins_int_unpack: expected contiguous uint8"
                         f"[S, {LOG_BINS_RECORD}], got {packed.dtype}"
                         f"{list(packed.shape)}")
    k = LOG_BIN_SLOTS
    w64, w32 = packed.view(torch.int64), packed.view(torch.int32)
    at = (16 * k + 8) // 4
    return [(w32[s, at:at + k], w32[s, at + k:at + 2 * k], w64[s, :k],
             w64[s, k:2 * k], w32[s, at + 2 * k:at + 3 * k], w64[s, 2 * k])
            for s in range(packed.shape[0])]


def log_bins_int_pack(binned) -> torch.Tensor:
    """The packed records (log_bins_int_unpack's layout) of single
    integer histograms, each a (lowers, uppers, counts, sums, maxes,
    n_bins)."""
    packed = torch.zeros((len(binned), LOG_BINS_RECORD), dtype=torch.uint8,
                         device=binned[0][0].device)
    for views, one in zip(log_bins_int_unpack(packed), binned):
        for dst, src in zip(views, one):
            dst.copy_(src)
    return packed


def _check_stats(stats) -> list:
    stats = [tuple(s) for s in stats]
    if not 1 <= len(stats) <= LOG_BINS_MAX_STATS:
        raise ValueError(f"log_bins_int_many takes 1 to {LOG_BINS_MAX_STATS} "
                         f"(values, mask) stats, got {len(stats)}")
    for j, (values, mask) in enumerate(stats):
        n = values.shape[0] if values.dim() == 1 else -1
        _check(values, torch.int32, n, f"stat {j} values")
        _check(mask, torch.bool, n, f"stat {j} mask")
    if len({t.device for s in stats for t in s}) != 1:
        raise ValueError("log_bins_int_many: every stat on one device")
    return stats


@functools.lru_cache(maxsize=None)
def _log_bins_blocks(device_index: int, n_buckets: int) -> int:
    """Blocks of C18's integer kernel (n_buckets 0) or float kernel the card
    holds at once: blocks an SM holds x SMs, asked once a device (which
    also raises the kernel's shared-memory limit)."""
    with torch.cuda.device(device_index):
        lib = cuda_build.library("log_bins")
        if lib.log_bins_int_record_bytes() != LOG_BINS_RECORD:
            raise RuntimeError("log_bins: csrc/log_bins.cu's record layout "
                               "differs from LOG_BINS_RECORD")
        per_sm = (lib.log_bins_int_blocks_per_sm() if n_buckets == 0 else
                  lib.log_bins_float_blocks_per_sm(n_buckets))
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"log_bins: occupancy query failed ({per_sm})")
    return per_sm * sms


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch_log_bins_int(stats) -> torch.Tensor:
    """One C18 launch over every stat: the packed records, uint8 [S,
    LOG_BINS_RECORD], views of one allocation that also holds the
    kernel's accumulators."""
    dev = stats[0][0].device
    lib = cuda_build.library("log_bins")
    n_stats = len(stats)
    grid = _log_bins_blocks(_device_index(dev), 0)
    buf = torch.empty(n_stats * (LOG_BINS_RECORD +
                                 lib.log_bins_int_scratch_bytes()),
                      dtype=torch.uint8, device=dev)
    table = array.array("q", [t.data_ptr() for s in stats for t in s] +
                        [s[0].shape[0] for s in stats])
    status = lib.log_bins_int(table.buffer_info()[0], n_stats, grid,
                              buf.data_ptr(), _stream(dev))
    _raise_on(status, "log_bins")
    _count("log_bins")
    return buf[:n_stats * LOG_BINS_RECORD].view(n_stats, LOG_BINS_RECORD)


def log_bins_int_many(stats) -> torch.Tensor:
    """The integer histograms (log_bins_int) of up to LOG_BINS_MAX_STATS
    (values, mask) stats in one launch (C18's integer entry, every block
    binning its chunk of every stat): their packed records, uint8 [S,
    LOG_BINS_RECORD], which one copy brings to the host and
    log_bins_int_unpack reads."""
    stats = _check_stats(stats)
    if not _on_cuda(*[t for s in stats for t in s]):
        return log_bins_int_many_plain(stats)
    return _launch_log_bins_int(stats)


def log_bins_int_many_plain(stats):
    return log_bins_int_pack([log_bins_int_plain(v, m) for v, m in stats])


def log_bins_int(values: torch.Tensor, mask: torch.Tensor):
    """The 3-leading-digit log histogram of the int32 values the bool mask
    selects: (lowers, uppers, counts, sums, maxes, n_bins), LOG_BIN_SLOTS
    entries each, the first n_bins the bins in ascending lower and zeros
    after; lowers, uppers, maxes int32, counts and sums int64 (exact),
    n_bins an int64 scalar (C18's integer entry for one stat). Values below
    1 bin as 1 and add their own value to sum and max."""
    n = values.shape[0]
    _check(values, torch.int32, n, "values")
    _check(mask, torch.bool, n, "mask")
    if not _on_cuda(values, mask):
        return log_bins_int_plain(values, mask)
    return log_bins_int_unpack(_launch_log_bins_int([(values, mask)]))[0]


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


def _carved(parts, device) -> list:
    """Views of one uint8 allocation on device: parts ((dtype, elements),
    ...), each at a 16-byte-aligned offset."""
    offsets, at = [], 0
    for dtype, count in parts:
        offsets.append(at)
        at += -(-count * dtype.itemsize // 16) * 16
    buf = torch.empty(max(at, 16), dtype=torch.uint8, device=device)
    return [buf[o:o + count * dtype.itemsize].view(dtype)
            for o, (dtype, count) in zip(offsets, parts)]


def log_bins_float(values: torch.Tensor, mask: torch.Tensor,
                   n_buckets: int):
    """The equal-width histogram of n_buckets buckets between the min and
    max of the float32 values the bool mask selects: (lo_hi float32[2],
    edges float32[n_buckets + 1], counts int32, sums float32, maxes
    float32 [n_buckets]); a value's bucket is float_buckets(edges, v)
    (searchsorted(edges, v, side="right") - 1, clipped), and its sum the
    float32 of the bucket's float64 sum (C18's float entry, one launch).
    With no value selected lo_hi is (float32 max, -float32 max)."""
    n = values.shape[0]
    _check(values, torch.float32, n, "values")
    _check(mask, torch.bool, n, "mask")
    if not _on_cuda(values, mask):
        return log_bins_float_plain(values, mask, n_buckets)
    dev = values.device
    grid = _log_bins_blocks(_device_index(dev), n_buckets)
    lo_hi, edges, counts, sums, maxes, scratch = _carved((
        (torch.float32, 2), (torch.float32, n_buckets + 1),
        (torch.int32, n_buckets), (torch.float32, n_buckets),
        (torch.float32, n_buckets),
        # float64 sums, each block's min and max
        (torch.uint8, 8 * n_buckets + 8 * grid)), dev)
    status = cuda_build.library("log_bins").log_bins_float(
        _ptr(values), _ptr(mask), n, n_buckets,
        float(np.float32(1.0 / n_buckets)), grid, _ptr(scratch), _ptr(lo_hi),
        _ptr(edges), _ptr(counts), _ptr(sums), _ptr(maxes), _stream(dev))
    _raise_on(status, "log_bins")
    _count("log_bins")
    return lo_hi, edges, counts, sums, maxes


def float_buckets(edges: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Each value's bucket, jnp.searchsorted(edges, v, side="right") - 1
    clipped to [0, len(edges) - 2], as the JAX package's default (scan)
    search runs it: ceil(log2(len(edges) + 1)) halvings of [low, high) =
    [0, len(edges)), high to mid where v sorts below edges[mid] (a NaN
    edge above every value that is not NaN), else low to mid. Where the
    edges do not decrease this is torch.searchsorted's bucket; where they
    decrease somewhere (a range of a few ulps) it is the JAX package's.
    int64, on values' device."""
    n = edges.shape[0]
    low = torch.zeros(values.shape, dtype=torch.int64, device=values.device)
    high = torch.full_like(low, n)
    for _ in range(n.bit_length()):
        mid = (low + high) // 2
        e = edges[mid]
        left = (values < e) | (torch.isnan(e) & ~torch.isnan(values))
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return (high - 1).clamp(0, n - 2)


def log_bins_float_plain(values, mask, n_buckets):
    big = torch.full_like(values, _FLOAT32_MAX)
    lo = torch.where(mask, values, big).min()
    hi = torch.where(mask, values, -big).max()
    edges = linspace_edges_f32(lo, hi, n_buckets)
    idx = float_buckets(edges, values)
    idx = torch.where(mask, idx, torch.full_like(idx, n_buckets))
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
    _count("sweep_stats")
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
    each bucket's partitions of error_model.metric_report_terms,
    bucket_rows T[K, NB, M, 24], and of error_model.info_terms, bucket_info
    T[K, NB, 5]: the plain version adds in partition order from 0, the
    card in a fixed order within a tile of partitions, then the tiles in
    order (two launches, the same bits every call). partition_chunk
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
    lib = cuda_build.library("sweep_report")
    nbytes = lib.sweep_report_scratch_bytes(k, p, m, nb, _f64(f))
    if nbytes < 0:
        raise ValueError(f"sweep_report: {nb} buckets (at most 32) or {m} "
                         f"metrics (at most 3) out of range")
    bucket = torch.empty(p, dtype=torch.int32, device=dev)
    keep_prob = torch.empty((k, p), dtype=f, device=dev)
    bucket_rows = torch.empty((k, nb, m, em.REPORT_WIDTH), dtype=f, device=dev)
    bucket_info = torch.empty((k, nb, em.INFO_WIDTH), dtype=f, device=dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    status = lib.sweep_report(
        _ptr(stats), _ptr(sel), _ptr(n_users), _ptr(size), _ptr(noise_std),
        _ptr(sel_cfg), _ptr(bounds), k, p, m, ms, nb, int(public), window,
        _f64(f), _ptr(scratch), _ptr(bucket), _ptr(keep_prob),
        _ptr(bucket_rows), _ptr(bucket_info), _stream(dev))
    _raise_on(status, "sweep_report")
    _count("sweep_report")
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


# ---------------------------------------------------------------------------
# Lane-batched entries (K24: executor.py:984 / :1141 of the JAX package, the
# megabatched service's vmap of the dense release over job lanes). L jobs'
# rows, each padded to the same lane_rows, run as one stream of L *
# lane_rows rows and their partitions as one range of L * P: C1, C2, C3,
# C4, C6, C8 and C9 have lane entries, C5 sorts with the lane as its most
# significant word and C7 counts the L * P partitions as one job's. Lane
# l's outputs equal its solo run's bit for bit. Each plain version loops
# over the lanes and calls the solo plain version.

_INT32_LIMIT = 1 << 31
_MAX_GRID_Y = 65535


def lane_capacity(lane_rows: int, n_partitions: int, cells: int = 0) -> int:
    """The most lanes one batched launch takes: L * (P + 1) and L *
    lane_rows stay below 2^31 (key2 and the sort are int32-indexed), L
    fits a grid's y dimension, and L * cells stays below 2^31, cells being
    a lane's largest partition table (the dense quantile regime's P * B^h
    leaf histogram, VECTOR_SUM's P * V sums; 0: none)."""
    return max(0, min(_MAX_GRID_Y, (_INT32_LIMIT - 1) // (n_partitions + 1),
                      (_INT32_LIMIT - 1) // max(lane_rows, 1),
                      (_INT32_LIMIT - 1) // max(cells, 1)))


def _lanes_of(n_total: int, lane_rows: int, n_partitions: int) -> int:
    if lane_rows <= 0 or n_total % lane_rows:
        raise ValueError(f"lane entries: {n_total} rows are not whole lanes "
                         f"of {lane_rows}")
    n_lanes = n_total // lane_rows
    if n_lanes > lane_capacity(lane_rows, n_partitions):
        raise ValueError(
            f"lane entries: {n_lanes} lanes of {lane_rows} rows over "
            f"{n_partitions} partitions exceed "
            f"{lane_capacity(lane_rows, n_partitions)} (int32 keys, grid)")
    return n_lanes


def _lanes_in(total: int, n_lanes: int, what: str) -> int:
    """The partitions a lane of a [L * P] range (P)."""
    if n_lanes < 1 or n_lanes > _MAX_GRID_Y or total % n_lanes:
        raise ValueError(f"{what}: {total} partitions are not {n_lanes} "
                         f"lanes")
    return total // n_lanes


def _device_words(words: np.ndarray, device) -> torch.Tensor:
    """u32 words (any shape) as a contiguous int32 tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(words, dtype=np.uint32)).view(np.int32)).to(device)


def _split_keys(keys: np.ndarray) -> np.ndarray:
    """The secure draw's split of every key of a [..., 2] stack: [..., 4],
    (k1, k2) = (fold_in(key, 0), fold_in(key, 1)): the host twin of
    csrc/common.cuh secure_key, equal to threefry.split(key, 2)."""
    keys = np.asarray(keys, dtype=np.uint32)
    flat = [np.concatenate([threefry.fold_in(k, 0), threefry.fold_in(k, 1)])
            for k in keys.reshape(-1, 2)]
    return np.asarray(flat, dtype=np.uint32).reshape(keys.shape[:-1] + (4,))


def row_keys_lanes(pid: torch.Tensor, pk: torch.Tensor, valid: torch.Tensor,
                   lane_rows: int, salts: np.ndarray,
                   keys: Optional[np.ndarray],
                   n_partitions: int, dtype: Optional[torch.dtype]):
    """C1's lane entry: lane l = rows [l * lane_rows, (l + 1) * lane_rows)
    takes salts[l] (jax.random.bits(key_l0, (4,)) of its job) and keys[l]
    (its key_linf); its uniforms draw counter i - l * lane_rows. Returns
    (lane int32, k1, k2, u or None): sorting by (lane, k1, k2, u) sorts
    every lane as its solo run sorts."""
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(pk, torch.int32, n, "pk")
    _check(valid, torch.bool, n, "valid")
    n_lanes = _lanes_of(n, lane_rows, n_partitions)
    salts = np.asarray(salts, dtype=np.uint32).reshape(n_lanes, 4)
    keys = (np.zeros((n_lanes, 2), np.uint32) if keys is None else
            np.asarray(keys, dtype=np.uint32).reshape(n_lanes, 2))
    if not _on_cuda(pid, pk, valid):
        return row_keys_lanes_plain(pid, pk, valid, lane_rows, salts,
                                    None if dtype is None else keys,
                                    n_partitions, dtype)
    dev = pid.device
    table = _device_words(np.concatenate([salts, keys], 1), dev)
    lane = torch.empty(n, dtype=torch.int32, device=dev)
    k1 = torch.empty(n, dtype=torch.int64, device=dev)
    k2 = torch.empty_like(k1)
    u = None if dtype is None else torch.empty(n, dtype=dtype, device=dev)
    status = cuda_build.library("row_keys").row_keys_lanes(
        _ptr(pid), _ptr(pk), _ptr(valid), n, lane_rows, n_partitions,
        _ptr(table), _ptr(lane), _ptr(k1), _ptr(k2), _ptr(u),
        0 if dtype is None else _f64(dtype), _stream(dev))
    _raise_on(status, "row_keys_lanes")
    _count("row_keys_lanes")
    return lane, k1, k2, u


def row_keys_lanes_plain(pid, pk, valid, lane_rows, salts, keys,
                         n_partitions, dtype):
    parts = []
    for l in range(pid.shape[0] // lane_rows):
        sl = slice(l * lane_rows, (l + 1) * lane_rows)
        parts.append(row_keys_plain(pid[sl], pk[sl], valid[sl], salts[l],
                                    None if keys is None else keys[l],
                                    n_partitions, dtype))
    lane = torch.arange(len(parts), dtype=torch.int32,
                        device=pid.device).repeat_interleave(lane_rows)
    k1 = torch.cat([p[0] for p in parts])
    k2 = torch.cat([p[1] for p in parts])
    u = None if dtype is None else torch.cat([p[2] for p in parts])
    return lane, k1, k2, u


def total_bound_keys_lanes(pid: torch.Tensor, valid: torch.Tensor,
                           lane_rows: int, keys: np.ndarray,
                           dtype: torch.dtype
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C1's total-bound lane entry (max_contributions a lane): lane l's
    rows take its key_total keys[l], drawn at the lane-local counter i - l
    * lane_rows. Returns (lane_pid int64 = lane << 32 | pid_sent, u):
    sorting by (lane_pid, u) sorts each lane's rows, within the lane's own
    block, as total_bound_keys' (pid_sent, u) sorts its solo run's."""
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(valid, torch.bool, n, "valid")
    n_lanes = _lanes_of(n, lane_rows, 0)
    keys = np.asarray(keys, dtype=np.uint32).reshape(n_lanes, 2)
    if not _on_cuda(pid, valid):
        return total_bound_keys_lanes_plain(pid, valid, lane_rows, keys,
                                            dtype)
    dev = pid.device
    table = _device_words(keys, dev)
    lane_pid = torch.empty(n, dtype=torch.int64, device=dev)
    u = torch.empty(n, dtype=dtype, device=dev)
    status = cuda_build.library("row_keys").total_keys_lanes(
        _ptr(pid), _ptr(valid), n, lane_rows, _ptr(table), _ptr(lane_pid),
        _ptr(u), _f64(dtype), _stream(dev))
    _raise_on(status, "total_bound_keys_lanes")
    _count("total_bound_keys_lanes")
    return lane_pid, u


def total_bound_keys_lanes_plain(pid, valid, lane_rows, keys, dtype):
    words, us = [], []
    for l in range(pid.shape[0] // lane_rows):
        sl = slice(l * lane_rows, (l + 1) * lane_rows)
        pid_sent, u = total_bound_keys_plain(pid[sl], valid[sl], keys[l],
                                             dtype)
        words.append((l << 32) | (pid_sent.to(torch.int64) & _M32))
        us.append(u)
    return torch.cat(words), torch.cat(us)


def total_bound_rows_lanes(perm: torch.Tensor, slane_pid: torch.Tensor,
                           pk: torch.Tensor, values: torch.Tensor,
                           valid: torch.Tensor, *, lane_rows: int,
                           total_bound: int, n_partitions: int):
    """C2's total-bound lane entry over the rows sorted by (lane_pid, u)
    (radix_sort of total_bound_keys_lanes' words with sorted_top): the
    first total_bound rows of each pid of each lane, every lane's rows in
    its own block of lane_rows. Returns (pid, pk, values, valid) as
    total_bound_rows, pk's sentinel the lane-local n_partitions."""
    n = valid.shape[0]
    dtype = values.dtype
    _f64(dtype)
    for t, dt, what in ((perm, torch.int64, "perm"),
                        (slane_pid, torch.int64, "slane_pid"),
                        (pk, torch.int32, "pk"), (values, dtype, "values"),
                        (valid, torch.bool, "valid")):
        _check(t, dt, n, what)
    _lanes_of(n, lane_rows, n_partitions)
    if not _on_cuda(perm, slane_pid, pk, values, valid):
        return total_bound_rows_lanes_plain(
            perm, slane_pid, pk, values, valid, lane_rows=lane_rows,
            total_bound=total_bound, n_partitions=n_partitions)
    dev = valid.device
    lib = cuda_build.library("bound_rows")
    pid_out = torch.empty(n, dtype=torch.int32, device=dev)
    pk_out = torch.empty(n, dtype=torch.int32, device=dev)
    values_out = torch.empty(n, dtype=dtype, device=dev)
    valid_out = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = torch.empty(max(1, lib.bound_rows_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    status = lib.total_bound_rows_lanes(
        _ptr(perm), _ptr(slane_pid), _ptr(pk), _ptr(values), _ptr(valid), n,
        lane_rows, total_bound, n_partitions, _ptr(scratch), _ptr(pid_out),
        _ptr(pk_out), _ptr(values_out), _ptr(valid_out), _f64(dtype),
        _stream(dev))
    _raise_on(status, "total_bound_rows_lanes")
    _count("total_bound_rows_lanes")
    return pid_out, pk_out, values_out, valid_out


def total_bound_rows_lanes_plain(perm, slane_pid, pk, values, valid, *,
                                 lane_rows, total_bound, n_partitions):
    parts = []
    for l in range(valid.shape[0] // lane_rows):
        sl = slice(l * lane_rows, (l + 1) * lane_rows)
        parts.append(total_bound_rows_plain(
            perm[sl] - l * lane_rows,
            (slane_pid[sl] & _M32).to(torch.int32), pk[sl], values[sl],
            valid[sl], total_bound=total_bound, n_partitions=n_partitions))
    return tuple(torch.cat([p[j] for p in parts]) for j in range(4))


def bound_rows_lanes(perm: Optional[torch.Tensor], k1: Optional[torch.Tensor],
                     k2: Optional[torch.Tensor],
                     values: Optional[torch.Tensor], valid: torch.Tensor, *,
                     lane_rows: int, n_partitions: int, linf: int, l0: int,
                     clip_per_value: bool, clip_pair_sum: bool,
                     scalars: Sequence[float], columns: Sequence[str],
                     pk: Optional[torch.Tensor] = None):
    """C2's lane entry over the rows in (lane, k1, k2, u) order (lane l's
    rows are the sorted positions [l * lane_rows, (l + 1) * lane_rows)).
    Runs break at lane starts too. Returns (key2, pair_start, columns) in
    sorted order: key2 = lane * n_partitions + partition where kept, L *
    n_partitions elsewhere. With perm = k1 = k2 = None (contribution bounds
    already enforced) the rows stay in lane order, each its own pair, and
    pk (lane-local) gives its partition: bound_rows' keyless entry a
    lane."""
    n = valid.shape[0]
    if values is None and columns:
        raise ValueError("bound_rows_lanes: columns need values")
    if k1 is None and pk is None:
        raise ValueError("bound_rows_lanes: keyless rows need pk")
    dtype = torch.float32 if values is None else values.dtype
    _f64(dtype)
    for t, dt, what in ((perm, torch.int64, "perm"), (k1, torch.int64, "k1"),
                        (k2, torch.int64, "k2"), (pk, torch.int32, "pk"),
                        (values, dtype, "values"),
                        (valid, torch.bool, "valid")):
        _check(t, dt, n, what)
    _lanes_of(n, lane_rows, n_partitions)
    args = dict(lane_rows=lane_rows, n_partitions=n_partitions, linf=linf,
                l0=l0, clip_per_value=clip_per_value,
                clip_pair_sum=clip_pair_sum, scalars=scalars,
                columns=columns)
    if not _on_cuda(perm, k1, k2, pk, values, valid):
        return bound_rows_lanes_plain(perm, k1, k2, values, valid, pk=pk,
                                      **args)
    dev = valid.device
    lib = cuda_build.library("bound_rows")
    key2 = torch.empty(n, dtype=torch.int32, device=dev)
    pair_start = torch.empty(n, dtype=torch.bool, device=dev)
    cols = {c: torch.empty(n, dtype=dtype, device=dev) for c in columns}
    scratch = torch.empty(max(1, lib.bound_rows_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    scal = (ctypes.c_double * 5)(*[float(s) for s in scalars])
    status = lib.bound_rows_lanes(
        _ptr(perm), _ptr(k1), _ptr(k2), _ptr(pk), _ptr(values), _ptr(valid),
        n, lane_rows, n_partitions, linf, l0, int(clip_per_value),
        int(clip_pair_sum), scal, _ptr(scratch), _ptr(key2), _ptr(pair_start),
        _ptr(cols.get("sum")), _ptr(cols.get("nsum")),
        _ptr(cols.get("nsum2")), _f64(dtype), _stream(dev))
    name = "bound_rows_lanes" if k1 is not None else "bound_rows_keyless_lanes"
    _raise_on(status, name)
    _count(name)
    return key2, pair_start, cols


def bound_rows_lanes_plain(perm, k1, k2, values, valid, *, lane_rows,
                           n_partitions, linf, l0, clip_per_value,
                           clip_pair_sum, scalars, columns, pk=None):
    n_lanes = valid.shape[0] // lane_rows
    parts = []
    for l in range(n_lanes):
        sl = slice(l * lane_rows, (l + 1) * lane_rows)
        keyed = k1 is not None
        key2, start, cols = bound_rows_plain(
            perm[sl] - l * lane_rows if keyed else None,
            k1[sl] if keyed else None, k2[sl] if keyed else None,
            None if keyed else pk[sl],
            None if values is None else values[sl], valid[sl],
            n_partitions=n_partitions, linf=linf, l0=l0,
            clip_per_value=clip_per_value, clip_pair_sum=clip_pair_sum,
            scalars=scalars, columns=columns)
        key2 = torch.where(key2 < n_partitions, key2 + l * n_partitions,
                           n_lanes * n_partitions).to(torch.int32)
        parts.append((key2, start, cols))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            {c: torch.cat([p[2][c] for p in parts]) for c in columns})


def reduce_partitions_lanes(skey2: torch.Tensor, perm: torch.Tensor,
                            pair_start: torch.Tensor,
                            row_cols: Dict[str, torch.Tensor],
                            lane_rows: int, n_partitions: int,
                            dtype: torch.dtype,
                            vector_rows: Optional[Tuple[
                                Optional[torch.Tensor], torch.Tensor]] = None,
                            compensated: bool = False):
    """C3's lane entry: rows sorted by key2 = lane * P + partition (the
    dropped rows' L * P last); lane l's kept rows are scanned from their
    own first row in tiles of their own, so every float sum has its solo
    run's association. Returns {count, pid_count, [sum, nsum, nsum2],
    [vsum]} as dtype[L * P] (vsum dtype[L * P, D]), lane l's partitions at
    [l * P, (l + 1) * P). vector_rows and compensated as for
    reduce_partitions: the vector entry (reduce_partitions_vector_lanes)
    sums the D coordinates of each lane's window, the compensated one
    (reduce_partitions_compensated_lanes) carries float32 TwoSum pairs."""
    compensated = compensated and dtype == torch.float32
    n = skey2.shape[0]
    _check(skey2, torch.int32, n, "skey2")
    _check(perm, torch.int64, n, "perm")
    _check(pair_start, torch.bool, n, "pair_start")
    for name, col in row_cols.items():
        _check(col, dtype, n, name)
    row_perm, vec = vector_rows if vector_rows is not None else (None, None)
    if vec is not None:
        _check(row_perm, torch.int64, n, "row_perm")
        if vec.dtype != dtype or vec.dim() != 2 or not vec.is_contiguous() \
                or (row_perm is None and vec.shape[0] != n):
            raise ValueError(f"vector values: expected contiguous "
                             f"{dtype}[n, D], got {vec.dtype}"
                             f"{list(vec.shape)}")
    n_lanes = _lanes_of(n, lane_rows, n_partitions)
    if not _on_cuda(skey2, perm, pair_start, row_perm, vec,
                    *row_cols.values()):
        return reduce_partitions_lanes_plain(skey2, perm, pair_start,
                                             row_cols, lane_rows,
                                             n_partitions, dtype,
                                             vector_rows, compensated)
    dev = skey2.device
    lib = cuda_build.library("reduce_partitions")
    f64, comp = _f64(dtype), int(compensated)
    dim = 0 if vec is None else vec.shape[1]
    scratch_bytes = max(
        lib.reduce_partitions_lanes_scratch_bytes(lane_rows, n_lanes, f64,
                                                  comp, 0),
        lib.reduce_partitions_lanes_scratch_bytes(lane_rows, n_lanes, f64,
                                                  comp, dim) if dim else 0)
    names = ("count", "pid_count", *row_cols)
    buf, at, scratch, fill = _c3_buffer(names, n_lanes * n_partitions, dtype,
                                        scratch_bytes, dev)
    stream = _stream(dev)
    status = lib.reduce_partitions_lanes(
        _ptr(skey2), _ptr(perm), _ptr(pair_start), _ptr(row_cols.get("sum")),
        _ptr(row_cols.get("nsum")), _ptr(row_cols.get("nsum2")), n,
        lane_rows, n_partitions, scratch, at["count"], fill, at["count"],
        at["pid_count"], at.get("sum"), at.get("nsum"), at.get("nsum2"), f64,
        comp, stream)
    name = ("reduce_partitions_compensated_lanes" if compensated else
            "reduce_partitions_lanes")
    _raise_on(status, name)
    _count(name)
    out = _c3_columns(buf, names, n_lanes * n_partitions, dtype)
    if vec is not None:
        out["vsum"] = torch.empty(n_lanes * n_partitions, dim, dtype=dtype,
                                  device=dev)
        status = lib.reduce_vectors_lanes(
            _ptr(skey2), _ptr(perm), _ptr(row_perm), _ptr(vec), n, lane_rows,
            dim, n_partitions, scratch, _ptr(out["vsum"]), f64, comp, stream)
        _raise_on(status, "reduce_partitions_vector_lanes")
        _count("reduce_partitions_vector_lanes")
    return out


def reduce_partitions_lanes_plain(skey2, perm, pair_start, row_cols,
                                  lane_rows, n_partitions, dtype,
                                  vector_rows=None, compensated=False):
    n_lanes = skey2.shape[0] // lane_rows
    edges = torch.searchsorted(
        skey2, torch.arange(n_lanes + 1, dtype=torch.int32,
                            device=skey2.device) * n_partitions).tolist()
    parts = [reduce_partitions_plain(skey2[lo:hi], perm[lo:hi], pair_start,
                                     row_cols, n_partitions, dtype,
                                     vector_rows, compensated,
                                     base=l * n_partitions)
             for l, (lo, hi) in enumerate(zip(edges[:-1], edges[1:]))]
    return {name: torch.cat([p[name] for p in parts]) for name in parts[0]}


def release_epilogue_lanes(cols: Dict[str, torch.Tensor],
                           plan: Sequence[Tuple[str, Tuple[str, ...], int]],
                           stds: np.ndarray, slot_keys: np.ndarray,
                           noise_kind: NoiseKind, degenerate: bool,
                           mid: float, min_v: float,
                           selection: Optional[selection_ops.SelectionParams],
                           key_sel: np.ndarray, max_rows: int,
                           n_lanes: int, tables=None):
    """C4's lane entry: cols are [L * P]; lane l draws under its own keys,
    slot_keys[l] ([S, 2]) and key_sel[l], at counter p of partition l * P +
    p. tables (secure noise, release_epilogue_secure_lanes): the slots'
    (thr int64[S, 2K+1], gran float64[S]), shared by the lanes; lane l
    searches with the words of split(slot_keys[l][s]) at element p, the
    split made on the card. The keys go up as epilogue_lane_table's
    [L, 2 + 2S] table: in the launch's parameters up to
    EPILOGUE_LANE_WORDS words, else in one pinned copy.
    Returns (keep bool[L * P], {output: F[L * P]}, flags int32[L], one
    flag word a lane)."""
    count = cols["count"]
    total = count.shape[0]
    dtype = count.dtype
    p = _lanes_in(total, n_lanes, "release_epilogue_lanes")
    scalar_cols = {k: c for k, c in cols.items() if k != "vsum"}
    for name, col in scalar_cols.items():
        _check(col, dtype, total, name)
    plan = [entry for entry in plan if entry[0] not in SKIPPED_KINDS]
    names = [o for _, outputs, _ in plan for o in outputs]
    slot_keys = np.asarray(slot_keys, dtype=np.uint32).reshape(
        n_lanes, len(stds), 2)
    key_sel = (np.zeros((n_lanes, 2), np.uint32) if key_sel is None else
               np.asarray(key_sel, dtype=np.uint32).reshape(n_lanes, 2))
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, len(stds))
    if not _on_cuda(*scalar_cols.values(), thr):
        return release_epilogue_lanes_plain(cols, plan, stds, slot_keys,
                                            noise_kind, degenerate, mid,
                                            min_v, selection, key_sel,
                                            max_rows, n_lanes, tables)
    plan_c = release_epilogue_plan(plan, stds, noise_kind, degenerate, mid,
                                   min_v, selection, max_rows,
                                   None if thr is None else tables[1])
    status, keep, outputs, flags = _launch_epilogue(
        cols, plan_c, names, total, n_lanes, dtype, thr,
        epilogue_lane_table(slot_keys, key_sel))
    name = ("release_epilogue_lanes" if thr is None else
            "release_epilogue_secure_lanes")
    _raise_on(status, name)
    _count(name)
    return keep, outputs, flags


def release_epilogue_lanes_plain(cols, plan, stds, slot_keys, noise_kind,
                                 degenerate, mid, min_v, selection, key_sel,
                                 max_rows, n_lanes, tables=None):
    p = cols["count"].shape[0] // n_lanes
    parts = []
    for l in range(n_lanes):
        lane_cols = {k: c[l * p:(l + 1) * p] for k, c in cols.items()
                     if k != "vsum"}
        parts.append(release_epilogue_plain(
            lane_cols, plan, stds, slot_keys[l], noise_kind, degenerate, mid,
            min_v, selection, None if selection is None else key_sel[l],
            max_rows, tables))
    return (torch.cat([q[0] for q in parts]),
            {o: torch.cat([q[1][o] for q in parts]) for o in parts[0][1]},
            torch.cat([q[2] for q in parts]))


def quantile_descend_dense_lanes(levels: Sequence[torch.Tensor],
                                 quantiles: Sequence[float], *, std: float,
                                 level_keys: np.ndarray, gaussian: bool,
                                 min_v: float, max_v: float,
                                 keep: torch.Tensor, flags: torch.Tensor,
                                 dtype: torch.dtype, n_lanes: int,
                                 tables=None) -> torch.Tensor:
    """C8's dense lane entry (quantile_descend_lanes; with tables
    quantile_descend_secure_lanes): levels are C7 (b)'s counts of L * P
    partitions, lane l's at rows [l * P, (l + 1) * P); level_keys [L, h,
    2] each lane's level keys. Partition p of lane l draws node j of level
    l' at counter p * B^l' + j under level_keys[l][l' - 1], as its solo run
    (quantile_descend_dense); with tables (the quantile slot's, shared)
    the words of the split of that key. Returns dtype[n_q, L * P] and ORs
    each lane's flag bits into flags[l] (int32[L])."""
    tree_height = len(levels)
    total = levels[0].shape[0]
    branching = levels[0].shape[1]
    p = _lanes_in(total, n_lanes, "quantile_descend_dense_lanes")
    _check_descend(keep, flags, quantiles, tree_height, branching, n_lanes)
    _check(keep, torch.bool, total, "keep")
    _f64(dtype)
    for l, t in enumerate(levels, 1):
        if t.dtype != torch.int32 or \
                tuple(t.shape) != (total, branching**l) or \
                not t.is_contiguous():
            raise ValueError(f"level {l}: expected int32[{total}, "
                             f"{branching**l}], got {t.dtype}"
                             f"{list(t.shape)}")
    level_keys = np.asarray(level_keys, dtype=np.uint32).reshape(
        n_lanes, tree_height, 2)
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, None)
    if not _on_cuda(keep, flags, thr, *levels):
        return quantile_descend_dense_lanes_plain(
            levels, quantiles, std=std, level_keys=level_keys,
            gaussian=gaussian, min_v=min_v, max_v=max_v, keep=keep,
            flags=flags, dtype=dtype, n_lanes=n_lanes, tables=tables)
    dev = keep.device
    n_q = len(quantiles)
    out = torch.empty(n_q, total, dtype=dtype, device=dev)
    ptrs = (ctypes.c_void_p * tree_height)(*[t.data_ptr() for t in levels])
    rows = [level_keys.reshape(n_lanes, -1)]
    if thr is not None:
        rows.append(_split_keys(level_keys).reshape(n_lanes, -1))
    lane_host, lane_dev, _held = _descend_lane_keys(
        np.concatenate(rows, 1), dev)
    params = _descend_params(quantiles, std, gaussian, min_v, max_v,
                             tree_height, branching, dev)
    status = cuda_build.library(
        "quantile_descend").quantile_descend_dense_lanes(
            ptrs, p, n_lanes, *params, lane_host, lane_dev, _ptr(keep),
            _ptr(out), _ptr(flags), _ptr(thr),
            0 if thr is None else thr.shape[0],
            0.0 if thr is None else float(tables[1]), _f64(dtype),
            _stream(dev))
    name = ("quantile_descend_lanes" if thr is None else
            "quantile_descend_secure_lanes")
    _raise_on(status, name)
    _count(name)
    return out


def quantile_descend_dense_lanes_plain(levels, quantiles, *, std, level_keys,
                                       gaussian, min_v, max_v, keep, flags,
                                       dtype, n_lanes, tables=None):
    p = levels[0].shape[0] // n_lanes
    outs = []
    for l in range(n_lanes):
        sl = slice(l * p, (l + 1) * p)
        outs.append(quantile_descend_dense_plain(
            [t[sl] for t in levels], quantiles, std=std,
            level_keys=level_keys[l], gaussian=gaussian, min_v=min_v,
            max_v=max_v, keep=keep[sl], flags=flags[l:l + 1], dtype=dtype,
            tables=tables))
    return torch.cat(outs, 1)


def quantile_descend_step_lanes(counts: torch.Tensor, state: DescentState,
                                quantiles: Sequence[float], *, level: int,
                                tree_height: int, std: float,
                                level_keys: np.ndarray, gaussian: bool,
                                min_v: float, max_v: float,
                                keep: torch.Tensor, flags: torch.Tensor,
                                n_lanes: int,
                                tables=None) -> Optional[torch.Tensor]:
    """C8's lazy lane entry (quantile_descend_lanes; with tables
    quantile_descend_secure_lanes): counts int32[L * P, n_q, B] and state
    over L * P partitions; level_keys [L, 2], each lane's fold_in(qkey,
    level). Partition p of lane l derives its node keys from
    fold_in(level_keys[l], p), as its solo run (quantile_descend_step).
    Returns dtype[n_q, L * P] at the last level (else None) and ORs each
    lane's flag bits into flags[l]."""
    total, n_q, branching = counts.shape
    p = _lanes_in(total, n_lanes, "quantile_descend_step_lanes")
    _check_descend(keep, flags, quantiles, tree_height, branching, n_lanes)
    _check(keep, torch.bool, total, "keep")
    if counts.dtype != torch.int32 or not counts.is_contiguous() or \
            tuple(state.node.shape) != (total, n_q):
        raise ValueError(f"counts: expected contiguous int32[{total}, {n_q}, "
                         f"B] matching the state, got {counts.dtype}"
                         f"{list(counts.shape)}")
    level_keys = np.asarray(level_keys, dtype=np.uint32).reshape(n_lanes, 2)
    dtype = state.target.dtype
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, None)
    if not _on_cuda(counts, state.node, state.target, keep, flags, thr):
        return quantile_descend_step_lanes_plain(
            counts, state, quantiles, level=level, tree_height=tree_height,
            std=std, level_keys=level_keys, gaussian=gaussian, min_v=min_v,
            max_v=max_v, keep=keep, flags=flags, n_lanes=n_lanes,
            tables=tables)
    dev = counts.device
    last = level == tree_height
    out = torch.empty(n_q, total, dtype=dtype, device=dev) if last else None
    lane_host, lane_dev, _held = _descend_lane_keys(level_keys, dev)
    params = _descend_params(quantiles, std, gaussian, min_v, max_v,
                             tree_height, branching, dev)
    status = cuda_build.library(
        "quantile_descend").quantile_descend_step_lanes(
            _ptr(counts), p, n_lanes, level, *params, lane_host, lane_dev,
            _ptr(state.node), _ptr(state.target), _ptr(state.total),
            _ptr(state.mass), _ptr(keep), _ptr(out), _ptr(flags), _ptr(thr),
            0 if thr is None else thr.shape[0],
            0.0 if thr is None else float(tables[1]), _f64(dtype),
            _stream(dev))
    name = ("quantile_descend_lanes" if thr is None else
            "quantile_descend_secure_lanes")
    _raise_on(status, name)
    _count(name)
    return out


def quantile_descend_step_lanes_plain(counts, state, quantiles, *, level,
                                      tree_height, std, level_keys, gaussian,
                                      min_v, max_v, keep, flags, n_lanes,
                                      tables=None):
    p = counts.shape[0] // n_lanes
    outs = []
    for l in range(n_lanes):
        sl = slice(l * p, (l + 1) * p)
        lane = DescentState(0, len(quantiles), state.target.dtype,
                            counts.device)
        for name in ("node", "target", "total", "mass"):
            setattr(lane, name, getattr(state, name)[sl].clone())
        outs.append(quantile_descend_step_plain(
            counts[sl], lane, quantiles, level=level,
            tree_height=tree_height, std=std, level_key=level_keys[l],
            gaussian=gaussian, min_v=min_v, max_v=max_v, keep=keep[sl],
            flags=flags[l:l + 1], tables=tables))
        for name in ("node", "target", "total", "mass"):
            getattr(state, name)[sl] = getattr(lane, name)
    return None if level < tree_height else torch.cat(outs, 1)


def vector_release_lanes(vsum: torch.Tensor, keep: torch.Tensor,
                         flags: torch.Tensor, *, max_norm: float,
                         norm_kind: str, std: float, keys: np.ndarray,
                         gaussian: bool, n_lanes: int,
                         tables=None) -> torch.Tensor:
    """C9's lane entry (vector_release_lanes; with tables
    vector_release_secure_lanes): vsum [L * P, D], keep [L * P], flags
    int32[L]; partition p of lane l draws coordinate d at counter p * D + d
    under keys[l], its lane's slot key (with tables, the entry's shared
    (thr, gran), the words of that key's split), and ORs its flag bits into
    flags[l]. Returns dtype[L * P, D], each lane its solo vector_release."""
    total = keep.shape[0]
    p = _lanes_in(total, n_lanes, "vector_release_lanes")
    _check(keep, torch.bool, total, "keep")
    _check(flags, torch.int32, n_lanes, "flags")
    if vsum.dim() != 2 or vsum.shape[0] != total or not vsum.is_contiguous():
        raise ValueError(f"vsum: expected contiguous [{total}, D], got "
                         f"{list(vsum.shape)}")
    _f64(vsum.dtype)
    if norm_kind not in NORM_KINDS:
        raise NotImplementedError(
            f"Vector Norm of kind '{norm_kind}' is not supported")
    keys = np.asarray(keys, dtype=np.uint32).reshape(n_lanes, 2)
    thr = None if tables is None else tables[0]
    if thr is not None:
        _check_table(thr, None)
    if not _on_cuda(vsum, keep, flags, thr):
        return vector_release_lanes_plain(
            vsum, keep, flags, max_norm=max_norm, norm_kind=norm_kind,
            std=std, keys=keys, gaussian=gaussian, n_lanes=n_lanes,
            tables=tables)
    dev = vsum.device
    out = torch.empty_like(vsum)
    rows = [keys] if thr is None else [keys, _split_keys(keys)]
    table = _device_words(np.concatenate(rows, 1), dev)
    status = cuda_build.library("vector_release").vector_release_lanes(
        _ptr(vsum), p, n_lanes, vsum.shape[1], NORM_KINDS[norm_kind],
        float(max_norm), float(std), int(gaussian), _ptr(table), _ptr(keep),
        _ptr(out), _ptr(flags), _ptr(thr),
        0 if thr is None else thr.shape[0],
        0.0 if thr is None else float(tables[1]), _f64(vsum.dtype),
        _stream(dev))
    name = ("vector_release_lanes" if thr is None else
            "vector_release_secure_lanes")
    _raise_on(status, name)
    _count(name)
    return out


def vector_release_lanes_plain(vsum, keep, flags, *, max_norm, norm_kind,
                               std, keys, gaussian, n_lanes, tables=None):
    p = keep.shape[0] // n_lanes
    return torch.cat([vector_release_plain(
        vsum[l * p:(l + 1) * p], keep[l * p:(l + 1) * p], flags[l:l + 1],
        max_norm=max_norm, norm_kind=norm_kind, std=std, key=keys[l],
        gaussian=gaussian, tables=tables) for l in range(n_lanes)])


def _lane_shaped(col: torch.Tensor, n_lanes: int, p: int) -> torch.Tensor:
    """A column of L lanes of P partitions as [L, P] or [L, P, D]: it may
    come as [L * P], [L, P], [L * P, D] or [L, P, D]."""
    if col.dim() == 1 or (col.dim() == 2 and tuple(col.shape) ==
                          (n_lanes, p)):
        return col.reshape(n_lanes, p)
    if col.dim() == 2:
        return col.reshape(n_lanes, p, col.shape[1])
    return col.reshape(n_lanes, p, *col.shape[2:])


def compact_kept_lanes(keep: torch.Tensor, columns: Dict[str, torch.Tensor],
                       n_lanes: int):
    """C6's lane entry: keep and every column hold L lanes of P partitions
    ([L * P] or [L, P]; a vector column [L * P, D] or [L, P, D], moved
    whole); each lane is compacted kept-first on its own, the L x tiles
    as one flat range of C6's launch. Returns (n_kept int64[L], order
    int64[L, P] of lane-local ids, {name: [L, P] (or [L, P, D]) in each
    lane's order})."""
    total = keep.numel()
    if n_lanes < 1 or total % n_lanes:
        raise ValueError(f"compact_kept_lanes: {total} partitions are not "
                         f"{n_lanes} lanes")
    p = total // n_lanes
    keep = keep.reshape(-1)
    _check(keep, torch.bool, total, "keep")
    columns = {name: _lane_shaped(col, n_lanes, p)
               for name, col in columns.items()}
    elem = {c.element_size() for c in columns.values()}
    for name, col in columns.items():
        if not col.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous column")
    if len(elem) > 1 or not elem <= {4, 8}:
        raise ValueError(f"compact_kept_lanes: columns must share a 4- or "
                         f"8-byte dtype, got "
                         f"{[c.dtype for c in columns.values()]}")
    if not _on_cuda(keep, *columns.values()):
        return compact_kept_lanes_plain(keep, columns, n_lanes)
    return _launch_compact(keep, columns,
                           tuple(tuple(c.shape) for c in columns.values()),
                           p, n_lanes, elem.pop() if elem else 8, False,
                           "compact_kept_lanes")


def compact_kept_lanes_plain(keep, columns, n_lanes):
    p = keep.numel() // n_lanes
    keep = keep.reshape(n_lanes, p)
    columns = {n: _lane_shaped(c, n_lanes, p) for n, c in columns.items()}
    parts = [compact_kept_plain(keep[l], {n: c[l] for n, c in
                                          columns.items()})
             for l in range(n_lanes)]
    return (torch.stack([q[0] for q in parts]),
            torch.stack([q[1] for q in parts]),
            {n: torch.stack([q[2][n] for q in parts]) for n in columns})


# ---------------------------------------------------------------------------
# C21 combine_shards

_COMBINE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                  torch.float64: 3}


COMBINE_MAX_SHARDS = 64
# csrc/combine_shards.cu: output columns and input parts a launch
# (kMaxColumns, kMaxParts).
_COMBINE_MAX_COLUMNS = 32
_COMBINE_MAX_PARTS = 256


def combine_parts(parts: Sequence[Sequence[torch.Tensor]],
                  compensated: bool = False) -> List[torch.Tensor]:
    """C21: the shards' columns summed column by column, read where they
    lie. parts[s][c] is shard s's column c: contiguous, column c's number
    of elements on every shard, one dtype (int32, int64, float32 or
    float64), all on one device; 1 <= D <= 64. Returns the C summed
    columns in shard 0's shapes, from one launch (one per group of
    min(32, 256 // D) whole columns).

    Each element folds in shard order 0..D-1 (integers exact, int32
    wrapping as XLA's psum does); compensated (float32 only,
    numeric_mode="safe"): the shards' (hi, lo) pairs combined by TwoSum
    in jax.lax.associative_scan's association, hi + lo of the last
    element (the JAX package's segment_ops.compensated_psum), bit for
    bit.
    """
    d = len(parts)
    if not 1 <= d <= COMBINE_MAX_SHARDS:
        raise ValueError(f"combine_parts: 1 to {COMBINE_MAX_SHARDS} shards, "
                         f"got {d}")
    first = parts[0]
    n_cols = len(first)
    if n_cols == 0:
        if any(len(p) for p in parts):
            raise ValueError("combine_parts: every shard has the same "
                             "columns")
        return []
    dtype, dev = first[0].dtype, first[0].device
    if dtype not in _COMBINE_CODES:
        raise ValueError(f"combine_parts: int32, int64, float32 or float64, "
                         f"got {dtype}")
    if compensated and dtype is not torch.float32:
        raise ValueError(f"combine_parts: the compensated entry takes "
                         f"float32, got {dtype}")
    sizes = [t.numel() for t in first]
    ins = []
    for s, p in enumerate(parts):
        if len(p) != n_cols:
            raise ValueError(f"combine_parts: shard {s} has {len(p)} "
                             f"columns, shard 0 {n_cols}")
        for c, t in enumerate(p):
            if t.dtype is not dtype or t.device != dev or \
                    not t.is_contiguous() or t.numel() != sizes[c]:
                raise ValueError(
                    f"combine_parts: part ({s}, {c}) is {t.dtype}"
                    f"{list(t.shape)} on {t.device}, contiguous "
                    f"{t.is_contiguous()}; expected contiguous {dtype} of "
                    f"{sizes[c]} elements on {dev}")
            ins.append(t.data_ptr())
    if not _launches(dev, "combine_parts"):
        return combine_parts_plain(parts, compensated)
    es = dtype.itemsize
    width = 16 // es
    # One allocation; column c starts where its address agrees with shard
    # 0's part modulo 16 bytes, so that its slots can be 16-byte vectors.
    flat = first[0].new_empty(sum(sizes) + n_cols * width)
    base = flat.data_ptr()
    outs, out_ptrs, at = [], [], 0
    for c, m in enumerate(sizes):
        at += ((ins[c] - base) // es - at) % width
        outs.append(flat.as_strided(first[c].shape, first[c].stride(), at))
        out_ptrs.append(base + at * es)
        at += m
    table = array.array("q", ins + out_ptrs + sizes)
    name = "combine_parts_compensated" if compensated else "combine_parts"
    status = cuda_build.library("combine_shards").combine_parts(
        table.buffer_info()[0], d, n_cols, _COMBINE_CODES[dtype],
        int(compensated), _stream(dev))
    _raise_on(status, name)
    group = min(_COMBINE_MAX_COLUMNS, _COMBINE_MAX_PARTS // d)
    for c0 in range(0, n_cols, group):
        if any(sizes[c0:c0 + group]):
            _count(name)
    return outs


def combine_parts_plain(parts, compensated=False):
    return [combine_shards_plain(
        torch.stack([p[c].reshape(-1) for p in parts]),
        compensated).reshape(parts[0][c].shape)
        for c in range(len(parts[0]))]


def combine_shards(stack: torch.Tensor,
                   compensated: bool = False) -> torch.Tensor:
    """C21 over a [D, M] stack of per-shard partials: its D rows are the
    parts of one column (combine_parts), [M]. Counted as combine_shards
    or combine_shards_compensated."""
    if stack.dim() != 2 or stack.dtype not in _COMBINE_CODES or \
            not stack.is_contiguous() or stack.shape[0] < 1:
        raise ValueError(f"combine_shards: expected a contiguous [D >= 1, M] "
                         f"stack of int32, int64, float32 or float64, got "
                         f"{stack.dtype}{list(stack.shape)}")
    if compensated and stack.dtype != torch.float32:
        raise ValueError(f"combine_shards: the compensated entry takes "
                         f"float32, got {stack.dtype}")
    if stack.shape[0] > COMBINE_MAX_SHARDS:
        raise ValueError(f"combine_shards: at most {COMBINE_MAX_SHARDS} "
                         f"shards, got {stack.shape[0]}")
    if not _launches(stack.device, "combine_shards"):
        return combine_shards_plain(stack, compensated)
    return _combine_stack(stack, compensated, "combine_shards_compensated"
                          if compensated else "combine_shards")


def heartbeat_sum(stack: torch.Tensor) -> torch.Tensor:
    """K23c's sum (parallel/mesh.collective_heartbeat): C21's int32 entry
    over the [D, 1] stack of the slots' ones, int32[1]. The same launch as
    combine_shards(stack), counted as collective_heartbeat."""
    if stack.dim() != 2 or stack.dtype != torch.int32 or \
            stack.shape[1] != 1 or not 1 <= stack.shape[0] <= 64 or \
            not stack.is_contiguous():
        raise ValueError(f"heartbeat_sum: expected a contiguous int32 "
                         f"[1 <= D <= 64, 1] stack, got "
                         f"{stack.dtype}{list(stack.shape)}")
    if not _launches(stack.device, "heartbeat_sum"):
        return combine_shards_plain(stack)
    return _combine_stack(stack, False, "collective_heartbeat")


def _combine_stack(stack: torch.Tensor, compensated: bool,
                   name: str) -> torch.Tensor:
    """C21 over a validated CUDA [D, M] stack, its rows the parts of one
    column, counted as `name`."""
    n_shards, m = stack.shape
    out = stack.new_empty(m)
    status = cuda_build.library("combine_shards").combine_stack(
        stack.data_ptr(), n_shards, m, _COMBINE_CODES[stack.dtype],
        int(compensated), out.data_ptr(), _stream(stack.device))
    _raise_on(status, name)
    if m:
        _count(name)
    return out


def combine_shards_plain(stack, compensated=False):
    if compensated:
        hi, lo = segment_ops._associative_scan(
            segment_ops._comp_combine, (stack, torch.zeros_like(stack)))
        return hi[-1] + lo[-1]
    out = stack[0].clone()
    for s in range(1, stack.shape[0]):
        out = out + stack[s]
    return out


# ---------------------------------------------------------------------------
# C22 reshard_count


def dest_shard(pid: torch.Tensor, n_shards: int, salt: int) -> torch.Tensor:
    """reshard._dest_shard of the JAX package: hash_mix(u32(pid) *
    0x9E3779B9 ^ salt) % n_shards, int32 (plain arithmetic in int64)."""
    x = (((pid.to(torch.int64) & _M32) * 0x9E3779B9) & _M32) ^ (salt & _M32)
    return (_hash_mix(x) % n_shards).to(torch.int32)


RESHARD_TILE = cuda_build.RESHARD_TILE


def reshard_count_plan(n: int, n_shards: int) -> Tuple[int, int]:
    """(tiles, scratch bytes) of C22 over n rows: tiles of RESHARD_TILE
    rows laid in pid's 16-byte phase (up to 3 rows before the first tile's
    first row), and the scratch the call clears: the tile counter (256 B)
    and one 8-byte status word a (tile, bucket), n_shards + 1 buckets."""
    tiles = -(-(n + 3) // RESHARD_TILE) if n > 0 else 0
    return tiles, 256 + tiles * (n_shards + 1) * 8


@functools.lru_cache(maxsize=1024)
def reshard_count_layout(n: int, n_shards: int, phase: int,
                         lead: int) -> Tuple[int, int, int, int, int]:
    """Where C22's outputs lie in one int32 allocation whose element `lead`
    (< 64) is its first on a 256-byte boundary: (scratch, dest, rank,
    counts) element offsets and the length the allocation needs. dest and
    rank start `phase` elements past a 16-byte boundary, pid's phase, so
    the kernel stores them four rows at a time."""
    _, scratch_bytes = reshard_count_plan(n, n_shards)
    dest_at = lead + -(-scratch_bytes // 256) * 64 + phase
    rank_at = dest_at + -(-n // 4) * 4
    counts_at = rank_at + n
    return lead, dest_at, rank_at, counts_at, counts_at + n_shards + 1


def reshard_count(pid: torch.Tensor, valid: torch.Tensor, n_shards: int,
                  salt: int = 0):
    """C22: every row's destination shard, the per-destination counts and
    every row's stable rank within its destination, in one pass (one
    launch after the memset of its status words).

    Returns (dest int32[n]: dest_shard of a valid row, n_shards of an
    invalid one; rank int32[n]: the number of earlier rows with the same
    dest; counts int32[n_shards + 1]: rows a destination, the invalid
    last). On the card the three are views of one allocation with the
    call's scratch (reshard_count_layout)."""
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(valid, torch.bool, n, "valid")
    if not 1 <= n_shards <= 64:
        raise ValueError(f"reshard_count: 1 to 64 shards, got {n_shards}")
    if not _on_cuda(pid, valid):
        return reshard_count_plain(pid, valid, n_shards, salt)
    dev = pid.device
    phase = (pid.data_ptr() >> 2) & 3
    buf = torch.empty(reshard_count_layout(n, n_shards, phase, 63)[-1],
                      dtype=torch.int32, device=dev)
    at, dest_at, rank_at, counts_at, _ = reshard_count_layout(
        n, n_shards, phase, (-(buf.data_ptr() >> 2)) & 63)
    dest = buf[dest_at:dest_at + n]
    rank = buf[rank_at:rank_at + n]
    counts = buf[counts_at:counts_at + n_shards + 1]
    status = cuda_build.library("reshard_count").reshard_count(
        _ptr(pid), _ptr(valid), n, n_shards, int(salt) & _M32, _ptr(dest),
        _ptr(rank), _ptr(counts), buf.data_ptr() + 4 * at,
        4 * (dest_at - phase - at), _stream(dev))
    _raise_on(status, "reshard_count")
    _count("reshard_count")
    return dest, rank, counts


def reshard_count_plain(pid, valid, n_shards, salt=0):
    dest = torch.where(valid, dest_shard(pid, n_shards, salt),
                       n_shards).to(torch.int32)
    counts = torch.bincount(dest.to(torch.int64), minlength=n_shards + 1)
    order = torch.argsort(dest, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(dest)
    rank[order] = (torch.arange(dest.shape[0], device=dest.device) -
                   starts[dest[order].to(torch.int64)]).to(torch.int32)
    return dest, rank, counts.to(torch.int32)


# ---------------------------------------------------------------------------
# C23 reshard_exchange


def _check_exchange_values(values: Optional[torch.Tensor], n: int,
                           what: str) -> int:
    """The width of a [n] or [n, V] float32/float64 value column (0: None)."""
    if values is None:
        return 0
    if values.dtype not in (torch.float32, torch.float64) or \
            values.dim() not in (1, 2) or values.shape[0] != n or \
            not values.is_contiguous():
        raise ValueError(f"{what}: expected contiguous float32/float64 [{n}] "
                         f"or [{n}, V], got {values.dtype}"
                         f"{list(values.shape)}")
    return 1 if values.dim() == 1 else values.shape[1]


def reshard_exchange(pid: torch.Tensor, pk: torch.Tensor,
                     values: Optional[torch.Tensor], dest: torch.Tensor,
                     rank: torch.Tensor, targets, fill) -> None:
    """C23: writes every valid row of one source shard to its slot.

    pid, pk int32[n], values [n] / [n, V] or None, dest / rank from C22.
    targets: one (pid, pk, values, valid, offset) a destination shard,
    the columns the source's rows for that shard go into (its receive
    buffer, or a staging slice to be copied there) and the row they start
    at; the row of rank r goes to offset + r. fill: (pid, pk, values,
    valid, start) of the source's own receive buffer, whose rows from
    start on get the padding row (0, -1, 0, False). Every tensor lies on
    the source's device; the columns are written in place.
    """
    n = pid.shape[0]
    _check(pid, torch.int32, n, "pid")
    _check(pk, torch.int32, n, "pk")
    _check(dest, torch.int32, n, "dest")
    _check(rank, torch.int32, n, "rank")
    width = _check_exchange_values(values, n, "values")
    n_shards = len(targets)
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"reshard_exchange: 1 to {MAX_SHARDS} shards, got "
                         f"{n_shards}")
    outs = list(targets) + [fill]
    for j, (t_pid, t_pk, t_values, t_valid, _) in enumerate(outs):
        cap = t_pid.shape[0]
        _check(t_pid, torch.int32, cap, f"target {j} pid")
        _check(t_pk, torch.int32, cap, f"target {j} pk")
        _check(t_valid, torch.bool, cap, f"target {j} valid")
        if _check_exchange_values(t_values, cap, f"target {j} values") != \
                width or (t_values is not None and
                          t_values.dtype != values.dtype):
            raise ValueError(f"reshard_exchange: target {j}'s values do not "
                             f"match the source's")
    tensors = [pid, pk, values, dest, rank] + [
        t for out in outs for t in out[:4]]
    if not _on_cuda(*tensors):
        return reshard_exchange_plain(pid, pk, values, dest, rank, targets,
                                      fill)
    dev = pid.device
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("reshard_exchange: every target must lie on the "
                         "source shard's device (stage a slice for a shard "
                         "elsewhere)")
    table = reshard_exchange_table(targets, fill)
    status = cuda_build.library("reshard_exchange").reshard_exchange(
        _ptr(pid), _ptr(pk), _ptr(values), width,
        0 if values is None else values.element_size(), _ptr(dest),
        _ptr(rank), n, n_shards, table.buffer_info()[0], _stream(dev))
    _raise_on(status, "reshard_exchange")
    _count("reshard_exchange")


def reshard_exchange_table(targets, fill) -> array.array:
    """C23's packed parameter words (int64): the targets' pid, pk, values
    and valid pointers and their offsets, one run of D each, then the
    fill's pid, pk, values and valid pointers, its start and its end (the
    buffer's rows). A missing values column is 0."""
    words = [_ptr(t[k]) or 0 for k in range(4) for t in targets]
    words += [int(t[4]) for t in targets]
    words += [_ptr(c) or 0 for c in fill[:4]] + [int(fill[4]),
                                                 fill[0].shape[0]]
    return array.array("q", words)


def reshard_exchange_plain(pid, pk, values, dest, rank, targets, fill):
    for d, (t_pid, t_pk, t_values, t_valid, offset) in enumerate(targets):
        rows = torch.nonzero(dest == d).reshape(-1)
        pos = int(offset) + rank[rows].to(torch.int64)
        t_pid[pos] = pid[rows]
        t_pk[pos] = pk[rows]
        t_valid[pos] = True
        if values is not None:
            t_values[pos] = values[rows]
    f_pid, f_pk, f_values, f_valid, start = fill
    f_pid[start:] = 0
    f_pk[start:] = -1
    f_valid[start:] = False
    if f_values is not None:
        f_values[start:] = 0


# ---------------------------------------------------------------------------
# C24 mesh_factorize


def mesh_heads_capacity(n: int, n_distinct: Optional[int] = None) -> int:
    """Rows of mesh_local_uniques' heads table for a shard of n rows:
    round_capacity of the most distinct hashes the shard can hold (n, or
    the caller's global count n_distinct where smaller), so it holds the
    uniq_cap (round_capacity of the largest shard count) of every shard
    count within the hint."""
    return round_capacity(n if n_distinct is None else min(int(n_distinct),
                                                            n))


def mesh_local_uniques(rows: torch.Tensor,
                       n_distinct: Optional[int] = None):
    """C24's local phase on one shard (K23b's per-shard sort and unique):
    C12 over the shard's hash rows, its table sized by
    factorize_table_plan(n, n_distinct), with its heads table. No sort.

    Returns (lcode int32[n]: each row's local code, the rank of its hash
    among the shard's distinct non-sentinel hashes by first row, -1 for a
    sentinel or invalid row; n_new int32[]: that distinct count, -1 on the
    card where n_distinct was too small for the table; heads int32[H, 3],
    H = mesh_heads_capacity(n, n_distinct): slot k the shard's k-th
    distinct hash by first row as a hash row (hi, lo, 1), the sentinel row
    past n_new). The plain version validates n_distinct and otherwise
    ignores it."""
    _check_hash_rows(rows)
    n = rows.shape[0]
    slots, probes = factorize_table_plan(n, n_distinct)
    cap = mesh_heads_capacity(n, n_distinct)
    if not _on_cuda(rows):
        return mesh_local_uniques_plain(rows, n_distinct)
    status, lcode, n_new, heads = _factorize_launch(rows, slots, probes, cap)
    _raise_on(status, "mesh_local_uniques")
    _count("mesh_local_uniques")
    return lcode, n_new, heads


def mesh_local_uniques_plain(rows, n_distinct=None):
    n = rows.shape[0]
    dev = rows.device
    lcode, n_new = factorize_codes_plain(rows)
    real = torch.nonzero(~((rows[:, 0] == -1) & (rows[:, 1] == -1)))[:, 0]
    _, inv = torch.unique(joined_hash_order(rows[real, 0], rows[real, 1]),
                          return_inverse=True)
    first = torch.full((int(n_new),), n, dtype=torch.int64, device=dev)
    first = torch.sort(first.scatter_reduce_(0, inv, real, "amin")).values
    heads = torch.full((mesh_heads_capacity(n, n_distinct), 3), -1,
                       dtype=torch.int32, device=dev)
    k = min(first.shape[0], heads.shape[0])
    heads[:k, :2] = rows[first[:k], :2]
    heads[:k, 2] = 1
    return lcode, n_new, heads


def mesh_merge_ranks(gathered: torch.Tensor,
                     n_distinct: Optional[int] = None):
    """C24's merge (K23b's replicated merge, run once on the gathering
    device): C12 over the gathered [m = D x uniq_cap, 3] heads tables,
    shard s's at rows [s * uniq_cap, (s + 1) * uniq_cap). A gathered slot's
    index orders the distinct hashes as their global first positions do
    (csrc/mesh_factorize.cu), so C12's first-row codes are the global
    codes. Returns (remap int32[m]: the code of each gathered slot, -1 for
    a sentinel slot; n_unique int32[], -1 on the card where n_distinct was
    too small for the table)."""
    _check_hash_rows(gathered, "gathered")
    slots, probes = factorize_table_plan(gathered.shape[0], n_distinct)
    if not _on_cuda(gathered):
        return mesh_merge_ranks_plain(gathered, n_distinct)
    status, remap, n_unique, _ = _factorize_launch(gathered, slots, probes)
    _raise_on(status, "mesh_merge_ranks")
    _count("mesh_merge_ranks")
    return remap, n_unique


def mesh_merge_ranks_plain(gathered, n_distinct=None):
    return factorize_codes_plain(gathered)


def mesh_remap_rows(lcode: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """C24's remap on one shard (K23b's per-shard remap): codes[r] =
    window[lcode[r]], or -1 where lcode[r] is -1 (a sentinel or invalid
    row). window is the shard's [uniq_cap] slice of mesh_merge_ranks'
    remap, on its device."""
    n = lcode.shape[0]
    _check(lcode, torch.int32, n, "lcode")
    _check(window, torch.int32, window.shape[0], "window")
    if not _on_cuda(lcode, window):
        return mesh_remap_rows_plain(lcode, window)
    dev = lcode.device
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    status = cuda_build.library("mesh_factorize").mesh_remap_codes(
        _ptr(lcode), n, _ptr(window), window.shape[0], _ptr(codes),
        _stream(dev))
    _raise_on(status, "mesh_remap_rows")
    _count("mesh_remap_rows")
    return codes


def mesh_remap_rows_plain(lcode, window):
    cap = window.shape[0]
    if cap == 0:
        return torch.full_like(lcode, -1)
    code = lcode.to(torch.int64)
    return torch.where((code >= 0) & (code < cap),
                       window[code.clamp(0, cap - 1)], -1).to(torch.int32)
