"""The six CUDA kernels of the dense release and selection paths, their
wrappers and their plain PyTorch versions.

    C1 row_keys           csrc/row_keys.cu           bounding-sort keys + row uniform;
                                                     total-bound keys (total_bound_keys)
    C2 bound_rows         csrc/bound_rows.cu         L0/Linf bounding, row columns;
                                                     total bound (total_bound_rows)
    C3 reduce_partitions  csrc/reduce_partitions.cu  dense partition columns
    C4 release_epilogue   csrc/release_epilogue.cu   selection, noise, metrics, flags
    C5 radix_sort         csrc/radix_sort.cu         stable multi-word LSD radix sort
    C6 compact_kept       csrc/compact_kept.cu       kept-first compaction

Each wrapper launches its kernel on the current CUDA stream when its inputs
lie on a CUDA device, and computes the plain version when they lie on the
CPU (the tests' path). On a CUDA tensor it never falls back: a failed build
or launch raises. Outputs and scratch are allocated here with torch; the
kernels allocate nothing. `launch_counts` counts wrapper calls that
launched a kernel, under the name of the kernel's source (a tile scan
issues three CUDA launches; a radix sort three a pass).
"""

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import cuda_build
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import segment_ops
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry

KERNELS = ("row_keys", "bound_rows", "reduce_partitions", "release_epilogue",
           "radix_sort", "compact_kept")
launch_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)

PLAN_KINDS = {"count": 0, "privacy_id_count": 1, "sum": 2, "mean": 3,
              "variance": 4}
OUTPUT_BITS = {"count": 1, "privacy_id_count": 2, "sum": 4, "mean": 8,
               "variance": 16}
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


def reduce_partitions(skey2: torch.Tensor, perm: torch.Tensor,
                      pair_start: torch.Tensor,
                      row_cols: Dict[str, torch.Tensor],
                      n_partitions: int, dtype: torch.dtype):
    """Dense per-partition columns from rows sorted by key2.

    skey2: key2 sorted ascending; perm: bounded-row index per sorted
    position; row_cols: the bounded rows' sum / nsum / nsum2. Returns
    {count, pid_count, [sum, nsum, nsum2]} as dtype[n_partitions].
    """
    n = skey2.shape[0]
    _check(skey2, torch.int32, n, "skey2")
    _check(perm, torch.int64, n, "perm")
    _check(pair_start, torch.bool, n, "pair_start")
    for name, col in row_cols.items():
        _check(col, dtype, n, name)
    if not _on_cuda(skey2, perm, pair_start, *row_cols.values()):
        return reduce_partitions_plain(skey2, perm, pair_start, row_cols,
                                       n_partitions, dtype)
    dev = skey2.device
    lib = cuda_build.library("reduce_partitions")
    out = {name: torch.zeros(n_partitions, dtype=dtype, device=dev)
           for name in ("count", "pid_count", *row_cols)}
    scratch = torch.empty(
        max(1, lib.reduce_partitions_scratch_bytes(n, _f64(dtype))),
        dtype=torch.uint8, device=dev)
    status = lib.reduce_partitions(
        _ptr(skey2), _ptr(perm), _ptr(pair_start), _ptr(row_cols.get("sum")),
        _ptr(row_cols.get("nsum")), _ptr(row_cols.get("nsum2")), n,
        n_partitions, _ptr(scratch), _ptr(out["count"]),
        _ptr(out["pid_count"]), _ptr(out.get("sum")), _ptr(out.get("nsum")),
        _ptr(out.get("nsum2")), _f64(dtype), _stream(dev))
    _raise_on(status, "reduce_partitions")
    launch_counts["reduce_partitions"] += 1
    return out


def reduce_partitions_plain(skey2, perm, pair_start, row_cols, n_partitions,
                            dtype):
    slots = n_partitions + 1  # slot n_partitions collects dropped rows
    key = skey2.to(torch.int64).clamp(0, n_partitions)

    def segment_sum(values):
        out = torch.zeros(slots, dtype=values.dtype, device=values.device)
        return out.index_add_(0, key, values)[:n_partitions]

    out = {
        "count": segment_sum(torch.ones(skey2.shape[0], dtype=torch.int64,
                                        device=skey2.device)).to(dtype),
        "pid_count": segment_sum(pair_start[perm].to(torch.int64)).to(dtype),
    }
    for name, col in row_cols.items():
        out[name] = segment_sum(col[perm])
    return out


# ---------------------------------------------------------------------------
# C4 release_epilogue


def release_epilogue(cols: Dict[str, torch.Tensor],
                     plan: Sequence[Tuple[str, Tuple[str, ...], int]],
                     stds: np.ndarray, slot_keys: np.ndarray,
                     noise_kind: NoiseKind, degenerate: bool, mid: float,
                     min_v: float,
                     selection: Optional[selection_ops.SelectionParams],
                     key_sel, max_rows: int):
    """Selection, noise, metric formulas and the sentinel flag word.

    cols: dense count / pid_count / [sum, nsum, nsum2] of the working
    dtype. plan: (kind, outputs, std offset) per metric entry, in
    executor.build_plan order. stds / slot_keys: the noise std and threefry
    key of every slot (slot_keys[s] = fold_in(fold_in(key_noise, entry),
    sub)). selection: None for public partitions.

    Returns (keep bool[P], {output: F[P]}, flags int32[1]): the flag word
    (numeric.FLAG_*) over the kept partitions' outputs.
    """
    count = cols["count"]
    p = count.shape[0]
    dtype = count.dtype
    for name, col in cols.items():
        _check(col, dtype, p, name)
    names = [o for _, outputs, _ in plan for o in outputs]
    if not _on_cuda(*cols.values()):
        return release_epilogue_plain(cols, plan, stds, slot_keys,
                                      noise_kind, degenerate, mid, min_v,
                                      selection, key_sel, max_rows)
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
    status = cuda_build.library("release_epilogue").release_epilogue(
        plan_c, len(plan), stds_c, keys_c, len(stds), sel_c, key_sel_c,
        misc_c, scal_c, p, _ptr(count), _ptr(cols["pid_count"]),
        _ptr(cols.get("sum")), _ptr(cols.get("nsum")),
        _ptr(cols.get("nsum2")), _ptr(keep), _ptr(outputs.get("count")),
        _ptr(outputs.get("privacy_id_count")), _ptr(outputs.get("sum")),
        _ptr(outputs.get("mean")), _ptr(outputs.get("variance")),
        _ptr(flags), _f64(dtype), _stream(dev))
    _raise_on(status, "release_epilogue")
    launch_counts["release_epilogue"] += 1
    return keep, outputs, flags


def release_epilogue_plain(cols, plan, stds, slot_keys, noise_kind,
                           degenerate, mid, min_v, selection, key_sel,
                           max_rows):
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
        std = torch.tensor(float(stds[slot]), dtype=dtype, device=dev)
        return col + noise_ops.additive_noise(slot_keys[slot], p, std,
                                              noise_kind)

    outputs = {}
    for kind, outs, off in plan:
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
    nonzero(keep)), and every column is gathered into that order.

    Returns (n_kept int64[], order int64[P], {name: column in order}).
    """
    p = keep.shape[0]
    _check(keep, torch.bool, p, "keep")
    elem = {c.element_size() for c in columns.values()}
    for name, col in columns.items():
        _check(col, col.dtype, p, name)
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
    status = lib.compact_kept(_ptr(keep), p, in_c, out_c, len(columns),
                              elem.pop() if elem else 8, _ptr(scratch),
                              _ptr(order), _ptr(n_kept), _stream(dev))
    _raise_on(status, "compact_kept")
    launch_counts["compact_kept"] += 1
    return n_kept, order, out


def compact_kept_plain(keep, columns):
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return keep.sum(), order, {n: c[order] for n, c in columns.items()}
