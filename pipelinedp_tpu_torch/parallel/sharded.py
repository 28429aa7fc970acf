"""The dense release over a device mesh (K21, K24c).

Port of pipelinedp_tpu/parallel/sharded.py on the single-controller mesh
of parallel/mesh.py. The JAX package runs one shard_map program; the port
runs the same stages from one process, shard by shard:

  1. stage_rows_to_mesh (parallel/reshard.py) puts every privacy id's rows
     on one shard: the host LPT permutation below for host rows, the
     device exchange (C22, C23) for device-resident rows.
  2. Each shard runs the dense release's phase 1 on its rows
     (executor.partial_columns: C1, C5, C2, C5, C3, and C7's counts for
     PERCENTILE) under its own rows key, fold_in(rows_key, shard), on its
     device, one shard after another on the device's stream.
  3. The shards' partial columns are summed onto the gathering device
     (mesh.devices[0]) by one C21 launch (collectives.psum_columns; the
     compensated entry for float32 in numeric_mode="safe"), the quantile
     counts likewise before each descent.
  4. Phase 2 runs once, on the gathering device, under the replicated
     keys (executor.release_columns: C4, C9, C7's roll-ups, C8, C6), so
     every geometry releases the same noise as the single-device run
     wherever the summed columns agree.

Standalone selection splits its key first (key_l0, key_sel), counts each
shard's pairs under fold_in(key_l0, shard) and selects once on the summed
counts. The lane-batched entries (K24c) do the same for L jobs, each lane
staged by its own host LPT permutation, through the lane entries of
C1-C4, C6, C8 and C9: every spec the solo meshed release runs.

fused=False runs the unfused forms (the JAX package's _sharded_kernel
and _sharded_select_kernel, :409-443): phase 2 without the compaction
(C6), returning the dense [P] outputs and keep vector that
executor.decode_results and np.nonzero decode.

Rows may come as host numpy, device tensors or ShardedColumns (the pod
ingest's, parallel/mesh.py): stage_rows_to_mesh exchanges the last from
the shards where they lie.

Both solo entry points run their launches (after the staging) under
retry.retry_call, and enter through runtime/entry.runtime_entry: the
job's health scope, job_id=, retry=, and with elastic= / elastic_grow=
the elastic loop, which re-enters them on a mesh of the surviving slots
after a device loss; at one slot the single-device release runs on that
slot's device (the finalize and selection keys are the replicated halves
of the same split, so it is the same release).
"""

import contextlib
import heapq
import threading
from typing import List, Sequence

import numpy as np
import torch

from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry
from pipelinedp_tpu_torch.parallel import collectives
from pipelinedp_tpu_torch.parallel.mesh import (Mesh, on_device,
                                                round_capacity)
from pipelinedp_tpu_torch.parallel.reshard import (ShardRows,
                                                   stage_rows_to_mesh)
from pipelinedp_tpu_torch.runtime import entry as rt_entry
from pipelinedp_tpu_torch.runtime import retry as rt_retry
from pipelinedp_tpu_torch.runtime import trace as rt_trace

# Concurrent meshed launches from several host threads (the service's
# workers) interleave their shards' kernels and copies on the devices'
# streams, the hazard XLA's CPU collectives have with their rendezvous.
# The service brackets its lifetime with enable/disable below; while any
# hold is active, every meshed release runs under the lock and waits for
# its devices before releasing it. Outside a service the guard stands
# down. An RLock, so a nested meshed call on the same thread cannot
# deadlock.
_COLLECTIVE_LAUNCH_LOCK = threading.RLock()
_COLLECTIVE_SERIALIZE_LOCK = threading.Lock()
_collective_serialize_depth = 0  # guarded by _COLLECTIVE_SERIALIZE_LOCK


def enable_collective_serialization() -> None:
    """Turns on collective-launch serialization (refcounted): called by
    every component that runs meshed releases from worker threads, before
    its first worker starts."""
    global _collective_serialize_depth
    with _COLLECTIVE_SERIALIZE_LOCK:
        _collective_serialize_depth += 1


def disable_collective_serialization() -> None:
    """Drops one serialization hold, after the holder's workers joined."""
    global _collective_serialize_depth
    with _COLLECTIVE_SERIALIZE_LOCK:
        _collective_serialize_depth = max(0, _collective_serialize_depth - 1)


@contextlib.contextmanager
def _collective_launch(mesh: Mesh):
    """Scope of one meshed release's launches: under the lock, and drained
    on the mesh's cards before the lock is released, while a serialization
    hold is active; unguarded otherwise."""
    with _COLLECTIVE_SERIALIZE_LOCK:
        serialize = _collective_serialize_depth > 0
    if not serialize:
        yield
        return
    with _COLLECTIVE_LAUNCH_LOCK:
        yield
        for dev in sorted({d for d in mesh.devices if d.type == "cuda"},
                          key=str):
            torch.cuda.synchronize(dev)


def _unique_ids(pid: np.ndarray):
    """The inverse and counts of np.unique(pid, return_inverse=True,
    return_counts=True). Encoded ids are small non-negative integers
    (0..U-1): a bincount gives the same two arrays without the sort."""
    if pid.size and pid.min() >= 0 and int(pid.max()) < 4 * pid.size + 1024:
        counts = np.bincount(pid)
        present = counts > 0
        return (np.cumsum(present) - 1)[pid], counts[present]
    _, inverse, counts = np.unique(pid, return_inverse=True,
                                   return_counts=True)
    return inverse, counts


def shard_rows_by_pid(pid: np.ndarray, pk: np.ndarray, values: np.ndarray,
                      valid: np.ndarray, n_shards: int):
    """Reorders and pads rows so each privacy id's rows land on exactly one
    shard, shards load-balanced by row count, all shards equal-sized (the
    JAX package's shard_rows_by_pid, :103: the same permutation, heapq tie
    order included, since it decides which shard bounds which id and so
    which rows are sampled; two of its sorts are replaced by a bincount
    and a radix sort that give the same arrays).

    The heaviest few thousand ids go greedy-LPT (each to the least-loaded
    shard), the near-uniform tail serpentine over the shards ordered
    lightest-first; the per-shard capacity is round_capacity of the
    largest load. Returns arrays of length n_shards * capacity whose s-th
    block is shard s's rows, invalid-padded (pid 0, pk -1, values 0).
    """
    inverse, ucounts = _unique_ids(pid)
    heavy_first = np.argsort(-ucounts, kind="stable")
    shard_of_uid = np.empty(len(ucounts), dtype=np.int64)
    n_greedy = min(len(ucounts), max(n_shards * 64, 4096))
    heap = [(0, s) for s in range(n_shards)]
    for uid in heavy_first[:n_greedy]:
        load, s = heapq.heappop(heap)
        shard_of_uid[uid] = s
        heapq.heappush(heap, (load + int(ucounts[uid]), s))
    tail = heavy_first[n_greedy:]
    if len(tail):
        shard_order = np.array([s for _, s in sorted(heap)], dtype=np.int64)
        rank = np.arange(len(tail))
        block, offset = divmod(rank, n_shards)
        pos = np.where(block % 2 == 0, offset, n_shards - 1 - offset)
        shard_of_uid[tail] = shard_order[pos]
    shard = shard_of_uid[inverse]
    # Shard numbers fit 8 bits: numpy's stable sort is then a radix sort,
    # the same permutation as the int64 sort.
    order = np.argsort(shard.astype(np.int8), kind="stable")
    counts = np.bincount(shard, minlength=n_shards)
    per_shard = round_capacity(int(counts.max()))
    n_out = n_shards * per_shard

    out_pid = np.zeros(n_out, dtype=pid.dtype)
    out_pk = np.full(n_out, -1, dtype=pk.dtype)
    out_values = np.zeros((n_out,) + values.shape[1:], dtype=values.dtype)
    out_valid = np.zeros(n_out, dtype=bool)

    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    positions = np.arange(len(pid)) - offsets[shard[order]]
    dest = shard[order] * per_shard + positions
    out_pid[dest] = pid[order]
    out_pk[dest] = pk[order]
    out_values[dest] = values[order]
    out_valid[dest] = valid[order]
    return out_pid, out_pk, out_values, out_valid


def _combine_partials(parts: Sequence[dict], device: torch.device,
                      numeric_mode: str = "fast") -> dict:
    """The shards' partial columns summed onto `device` by one C21 launch
    (the JAX package's _combine_partials, :161): numeric_mode "safe"
    takes the compensated entry for float32. row_count aliases pid_count,
    as reduce_rows_to_partitions' does."""
    names = [k for k in parts[0] if k != "row_count"]
    cols = collectives.psum_columns([{k: p[k] for k in names} for p in parts],
                                    device, numeric_mode == "safe")
    if "pid_count" in cols:
        cols["row_count"] = cols["pid_count"]
    return cols


def _psum_counts(mesh: Mesh):
    """The quantile counts' cross-shard sum (int32, C21's plain entry)."""
    return lambda parts: collectives.psum(parts, mesh.device)


def _fallback_aggregate_arrays(mesh: Mesh, args, kwargs, job):
    """Elastic floor of sharded_aggregate_arrays: the single-device
    release (executor.aggregate_release_kernel, or aggregate_kernel
    unfused) on the surviving slot's device, under retry_call. Its
    finalize key is the replicated half of the same split, so the noise
    is the same release."""

    def go(mesh_, pid, pk, values, valid, min_v, max_v, min_s, max_s, mid,
           stds, rng_key, cfg, secure_tables=None, reshard="auto",
           dtype=torch.float32, fused=True, retry=None):
        del mesh_, reshard
        from pipelinedp_tpu_torch.parallel.large_p import _device_rows
        rows = _device_rows(pid, pk, values, valid, mesh.device, dtype)
        kernel = (executor.aggregate_release_kernel if fused else
                  executor.aggregate_kernel)
        with on_device(mesh.device):
            return rt_retry.retry_call(
                lambda: kernel(*rows, min_v, max_v, min_s, max_s, mid, stds,
                               rng_key, cfg, secure_tables),
                retry, what="single-device aggregation dispatch")

    del job
    return go(*args, **kwargs)


def _fallback_select_partitions(mesh: Mesh, args, kwargs, job):
    """Elastic floor of sharded_select_partitions: the single-device
    selection on the surviving slot's device (the selection key is the
    replicated half of the split, so the decisions are the same
    release)."""

    def go(mesh_, pid, pk, valid, rng_key, l0, n_partitions, selection,
           reshard="auto", dtype=torch.float32, fused=True, retry=None):
        del mesh_, reshard
        from pipelinedp_tpu_torch.parallel.large_p import _device_rows
        pid_t, pk_t, _, valid_t = _device_rows(pid, pk, None, valid,
                                               mesh.device, dtype)
        kernel = (executor.select_partitions_release_kernel if fused else
                  executor.select_partitions_kernel)
        with on_device(mesh.device):
            return rt_retry.retry_call(
                lambda: kernel(pid_t, pk_t, valid_t, rng_key, l0,
                               n_partitions, selection, dtype),
                retry, what="single-device select_partitions dispatch")

    del job
    return go(*args, **kwargs)


@rt_entry.runtime_entry("sharded_aggregate_arrays",
                        fallback=_fallback_aggregate_arrays)
def sharded_aggregate_arrays(mesh: Mesh, pid, pk, values, valid, min_v,
                             max_v, min_s, max_s, mid, stds: np.ndarray,
                             rng_key, cfg: executor.KernelConfig,
                             secure_tables=None, reshard: str = "auto",
                             dtype: torch.dtype = torch.float32,
                             fused: bool = True,
                             retry: rt_retry.RetryPolicy = None):
    """The dense release over `mesh` (the JAX package's
    sharded_aggregate_arrays, :505): rows in (host numpy, device tensors
    or ShardedColumns, any length), staged by stage_rows_to_mesh, phase 1
    a shard, C21, phase 2 on the gathering device. secure_tables lie there
    too. Returns (n_kept, order, outputs kept-first, flags), as
    executor.aggregate_release_kernel, or with fused=False (outputs, keep,
    flags), as executor.aggregate_kernel. The launches after the staging
    run under retry_call(retry): a retry reuses rng_key, so it replays
    the same release. The runtime entry adds job_id=, elastic=,
    elastic_grow= and min_devices=."""
    shards = stage_rows_to_mesh(mesh, pid, pk, values, valid, reshard,
                                dtype)

    def launch():
        rows_key, _ = executor.release_key_halves(rng_key)
        parts, qrows = [], []
        for s, (pid_s, pk_s, values_s, valid_s) in enumerate(shards):
            with on_device(mesh.devices[s]):
                cols, q = executor.partial_columns(
                    pid_s, pk_s, values_s, valid_s, min_v, max_v, min_s,
                    max_s, mid, threefry.fold_in(rows_key, s), cfg)
            parts.append(cols)
            qrows.append(q)
        cols = _combine_partials(parts, mesh.device, cfg.numeric_mode)
        release = (executor.release_columns if fused else
                   executor.release_dense)
        return release(cols, qrows, min_v, max_v, mid, stds, rng_key, cfg,
                       dtype, secure_tables, combine=_psum_counts(mesh))

    with _collective_launch(mesh), rt_trace.span("dispatch"), \
            on_device(mesh.device):
        return rt_retry.retry_call(launch, retry,
                                   what="sharded aggregation dispatch")


@rt_entry.runtime_entry("sharded_select_partitions",
                        fallback=_fallback_select_partitions)
def sharded_select_partitions(mesh: Mesh, pid, pk, valid, rng_key, l0: int,
                              n_partitions: int,
                              selection: selection_ops.SelectionParams,
                              reshard: str = "auto",
                              dtype: torch.dtype = torch.float32,
                              fused: bool = True,
                              retry: rt_retry.RetryPolicy = None):
    """Standalone partition selection over `mesh` (the JAX package's
    sharded_select_partitions, :459): each shard counts its pairs under
    fold_in(key_l0, shard), C21 sums the counts, the keep decisions and
    their compaction run once under key_sel. Returns (n_kept, order), or
    with fused=False the keep vector bool[P]. retry and the runtime
    entry's knobs as sharded_aggregate_arrays'."""
    shards = stage_rows_to_mesh(mesh, pid, pk, None, valid, reshard)

    def launch():
        key_l0, key_sel = executor.select_key_schedule(rng_key)
        parts = []
        for s, (pid_s, pk_s, _, valid_s) in enumerate(shards):
            with on_device(mesh.devices[s]):
                parts.append(executor.select_partition_counts(
                    pid_s, pk_s, valid_s, threefry.fold_in(key_l0, s), l0,
                    n_partitions, dtype))
        cols = _combine_partials(parts, mesh.device)
        release = (executor.select_release if fused else
                   executor.select_keep)
        return release(cols, selection, key_sel)

    with _collective_launch(mesh), rt_trace.span("dispatch"), \
            on_device(mesh.device):
        return rt_retry.retry_call(launch, retry,
                                   what="sharded select_partitions dispatch")


def sharded_batched_release(mesh: Mesh, shards: Sequence[ShardRows], min_v,
                            max_v, min_s, max_s, mid, stds: np.ndarray,
                            rng_keys, cfg: executor.KernelConfig,
                            secure_tables=None):
    """L dense releases over `mesh` in one launch a stage (the JAX
    package's _sharded_batched_release_kernel, :305): shards[s] holds shard
    s's rows of every lane, [L, cap] (values [L, cap] or [L, cap, V]),
    each lane staged by its own host LPT permutation. Each shard runs
    C1-C3's lane entries under the lanes' shard keys, C21 sums the [L * P]
    columns (vsum [L * P, V]; compensated in numeric_mode="safe"), C4's,
    C9's and C6's lane entries run once, and the percentiles' counts of
    every lane go through one C21 a level before C8's lane entries descend
    once. secure_tables lie on the mesh's first device. Lane l equals the
    meshed release of its rows and key alone."""
    executor._require_tables(cfg, secure_tables)
    n_lanes, lane_rows = shards[0][0].shape[0], shards[0][0].shape[1]
    executor._check_lanes(cfg, n_lanes, lane_rows)
    dtype = shards[0][2].dtype
    with _collective_launch(mesh), rt_trace.span("dispatch"), \
            on_device(mesh.device):
        parts, qrows = [], []
        for s, (pid_s, pk_s, values_s, valid_s) in enumerate(shards):
            with on_device(mesh.devices[s]):
                cols, q = executor.batched_partial_columns(
                    pid_s, pk_s, values_s, valid_s, min_v, max_v, min_s,
                    max_s, mid, rng_keys, cfg, shard=s)
            parts.append(cols)
            qrows.append(q)
        cols = _combine_partials(parts, mesh.device, cfg.numeric_mode)
        return executor.batched_release_columns(
            cols, qrows, min_v, max_v, mid, stds, rng_keys, cfg, n_lanes,
            dtype, secure_tables, combine=_psum_counts(mesh))


def sharded_batched_select_release(mesh: Mesh, shards: Sequence[ShardRows],
                                   rng_keys, l0: int, n_partitions: int,
                                   selection: selection_ops.SelectionParams,
                                   dtype: torch.dtype):
    """L standalone selections over `mesh` (the JAX package's
    _sharded_batched_select_release_kernel, :356), as
    sharded_batched_release. Returns (n_kept int64[L], order
    int64[L, P])."""
    n_lanes = shards[0][0].shape[0]
    with _collective_launch(mesh), rt_trace.span("dispatch"), \
            on_device(mesh.device):
        parts = []
        for s, (pid_s, pk_s, _, valid_s) in enumerate(shards):
            salts, _ = executor.lane_select_keys(rng_keys, shard=s)
            with on_device(mesh.devices[s]):
                parts.append(executor.batched_select_counts(
                    pid_s, pk_s, valid_s, salts, l0, n_partitions, dtype))
        cols = _combine_partials(parts, mesh.device)
        _, key_sel = executor.lane_select_keys(rng_keys)
        return executor.batched_select_release(cols, selection, key_sel,
                                               n_lanes)


def stage_lanes(mesh: Mesh, staged: Sequence[tuple],
                dtype: torch.dtype) -> List[ShardRows]:
    """The lanes' host-staged rows (shard_rows_by_pid of each lane, one
    layout) as one [L, cap] ShardRows a shard, on the shard's device;
    values None where the lanes' values are zero-width (selection)."""
    cap = len(staged[0][0]) // mesh.size
    out = []
    for s, dev in enumerate(mesh.devices):
        part = slice(s * cap, (s + 1) * cap)

        def lanes(j, as_dtype=None):
            stack = np.stack([lane[j][part] for lane in staged])
            return torch.as_tensor(stack).to(device=dev, dtype=as_dtype)

        values = None if staged[0][2].ndim > 1 and \
            staged[0][2].shape[1] == 0 else lanes(2, dtype)
        out.append((lanes(0, torch.int32), lanes(1, torch.int32), values,
                    lanes(3)))
    return out
