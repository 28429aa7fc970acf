"""Megabatched serving: identical-spec jobs as lanes of one release.

Port of pipelinedp_tpu/service/batching.py. Workers executing a job offer
its dense release (executor.ReleaseLaunch, through the per-thread
executor.launch_interceptor) to the service's BatchCoalescer. Within a
short window it groups the releases by their exact fingerprint
(_group_key: the static config, the clipping scalars, the noise stds, the
padded row shape, the device and dtype) and runs each group as ONE
lane-batched release (executor.batched_aggregate_release_kernel /
batched_select_partitions_release_kernel: one launch of each kernel stage
for all lanes). Each lane keeps its job's own base key and its own rows,
so its release equals its solo run's bit for bit; decode, the release
sentinel, the odometer, the ledger charge and the handle then run on the
job's own worker, as a solo run's do. Every spec the dense release runs
coalesces: PERCENTILE, VECTOR_SUM, max_contributions, pre-bounded rows,
secure noise and safe mode as well as the scalar metrics.

The first offer of a fingerprint leads its group: it waits out the
window (or until max_lanes joined, or the coalescer closes), then
dispatches the group on its own thread and hands each lane its slice.
A window that expires with one lane returns None: the job runs its
unchanged solo release.

Differences from the JAX coalescer:
  * No fallback. The JAX coalescer catches any failure of the batched
    dispatch and sends every lane back to its solo launch
    (batching.py:178-203 there). Here a failed build or launch of a lane
    entry fails every lane's job with that error; the ledger settles as
    for any failed job (the grant is forfeit: mechanisms registered). A
    joiner whose leader never posts a result fails the same way.
  * The lane axis is not padded to a power of two (_lane_bucket there
    bounds XLA's executable cache; torch has none): a group of L jobs
    runs L lanes, and the batch_dispatch span's lane_bucket is L.
  * A group is capped below the lane entries' limits
    (executor.batched_lane_capacity: int32 partition keys, the dense
    quantile regime's leaf histograms and VECTOR_SUM's sums, the grid's y
    dimension) as well as by max_lanes.
  * The group key holds what the secure tables are built from (the stds,
    the noise kind, the slots' sensitivities and snap_grid_bits), where
    the JAX key holds only their presence and its dispatch takes the first
    lane's tables. snap_grid_bits is a backend option the key does not
    otherwise hold: so a lane never draws from another job's tables,
    whichever backends its group's jobs came from.

On a meshed backend (_dispatch_meshed, K24c) every lane is staged by the
same host LPT permutation its solo meshed run takes
(sharded.shard_rows_by_pid, on the job's own worker before the
rendezvous, where the JAX leader stages every lane itself), the lanes
whose staged layouts agree run as
one meshed lane-batched release (sharded.sharded_batched_release: the
lane entries a shard, one C21 combine of the [D, L * P] columns, C4 and
C6 once), and a lane whose layout no other lane shares runs solo. The
group key carries the mesh and the reshard mode; a backend forced onto
the device exchange never offers (executor._offerable).

The stacked lanes go to the device as one host-to-device copy a column
(from pinned memory on the card), and the results come back as one copy
an output, split on the host (_split_lanes).
"""

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
from pipelinedp_tpu_torch.runtime import trace as rt_trace
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

# A joiner whose leader never posts (a lost leader thread) fails after
# this bound instead of blocking its worker for ever.
_JOINER_TIMEOUT_S = 600.0


def _group_key(launch: "executor.ReleaseLaunch"):
    """The coalescing fingerprint: two launches share one batched release
    iff their keys are equal. Everything shared goes in, the secure tables
    by what they are built from (launch.tables_key: no read of the device
    tables); the per-lane base key and the row values stay out (the lane
    axis carries them)."""
    if launch.kind == "aggregate":
        return ("aggregate", launch.cfg, launch.scalars,
                np.asarray(launch.stds).tobytes(), launch.pid.shape,
                launch.values.shape, str(launch.device), launch.dtype,
                launch.mesh, launch.reshard, launch.tables_key)
    return ("select", launch.l0, launch.n_partitions, launch.selection,
            launch.pid.shape, str(launch.device), launch.dtype, launch.mesh,
            launch.reshard)


def _lane_cap(launch: "executor.ReleaseLaunch", max_lanes: int) -> int:
    rows = int(launch.pid.shape[0])
    if launch.kind == "aggregate":
        return min(max_lanes, executor.batched_lane_capacity(launch.cfg, rows))
    return min(max_lanes, kernels.lane_capacity(rows, launch.n_partitions))


class _Lane:
    """One job's seat in a batch group."""

    __slots__ = ("launch", "event", "result", "error")

    def __init__(self, launch):
        self.launch = launch
        self.event = threading.Event()
        self.result = None  # None: run solo (a lone lane's window)
        self.error: Optional[BaseException] = None


class _Group:
    """One open batch window: the lanes so far, the 'full' event the
    leader waits on, and the group's lane cap."""

    __slots__ = ("lanes", "full", "closed", "cap")

    def __init__(self, cap: int):
        self.lanes: List[_Lane] = []
        self.full = threading.Event()
        self.closed = False
        self.cap = cap


class BatchCoalescer:
    """The rendezvous and dispatcher. One per DPAggregationService."""

    _GUARDED_BY = guarded_by("_lock", "_groups", "_closing")

    def __init__(self, window_s: float, max_lanes: int):
        self._window_s = float(window_s)
        self._max_lanes = int(max_lanes)
        self._lock = threading.Lock()
        self._groups: Dict[Any, _Group] = {}
        self._closing = False

    def close(self) -> None:
        """Wakes every open window now (service stop): pending groups
        dispatch with the lanes they have, new offers run solo."""
        with self._lock:
            self._closing = True
            groups = list(self._groups.values())
            self._groups.clear()
        for group in groups:
            group.full.set()

    def offer(self, launch) -> Optional[Any]:
        """Called from the executor's release site on the job's worker
        thread. Returns the lane's result, None to run solo, or raises the
        batched release's failure."""
        cap = _lane_cap(launch, self._max_lanes)
        if cap < 2:
            return None
        if launch.mesh is not None:
            # The lane's host permutation runs here, on the job's own
            # worker, before the rendezvous: the leader only stacks.
            launch.staged = _stage_lane(launch)
        key = _group_key(launch)
        lane = _Lane(launch)
        with self._lock:
            if self._closing:
                return None
            group = self._groups.get(key)
            leader = group is None or group.closed
            if leader:
                group = _Group(cap)
                self._groups[key] = group
            group.lanes.append(lane)
            if len(group.lanes) >= group.cap:
                group.closed = True
                if self._groups.get(key) is group:
                    del self._groups[key]
                group.full.set()
        if not leader:
            if not lane.event.wait(_JOINER_TIMEOUT_S):
                raise RuntimeError(
                    f"megabatched release: the group's leader posted no "
                    f"result within {_JOINER_TIMEOUT_S} s")
            return _result_of(lane)
        group.full.wait(self._window_s)
        with self._lock:
            group.closed = True
            if self._groups.get(key) is group:
                del self._groups[key]
            lanes = list(group.lanes)
        if len(lanes) == 1:
            # The window expired with this job alone: its solo release
            # runs unchanged (no batch launch, no batch counters).
            return None
        _dispatch(lanes)
        return _result_of(lane)


def _result_of(lane: _Lane):
    if lane.error is not None:
        raise lane.error
    return lane.result


def _dispatch(lanes: List[_Lane]) -> None:
    """Runs the group as one lane-batched release on the leader's thread
    and posts each lane its slice; a failure is posted to every lane."""
    try:
        launches = [lane.launch for lane in lanes]
        if launches[0].mesh is not None:
            results = _dispatch_meshed(launches)
        elif launches[0].kind == "aggregate":
            results = _dispatch_aggregate(launches)
        else:
            results = _dispatch_select(launches)
        for lane, result in zip(lanes, results):
            lane.result = result
    # Posted to every lane: each lane's job fails with the batched
    # release's error (no fallback to solo).
    except Exception as e:  # noqa: BLE001
        for lane in lanes:
            lane.error = e
    finally:
        for lane in lanes:
            lane.event.set()


def _record_batch(n_lanes: int) -> None:
    rt_telemetry.record("service_batch_launches")
    rt_telemetry.record("service_jobs_batched", n_lanes)
    rt_telemetry.set_gauge("service_batch_occupancy", n_lanes, job_id=None)


def _stack(columns: List[np.ndarray], device: torch.device,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The lanes' host columns stacked [L, n] (converted to dtype on the
    way) and copied to the device once. On the card the stack is written
    straight into pinned memory, so the rows are copied once on the host
    and once to the card."""
    first = torch.from_numpy(columns[0])
    pinned = device.type == "cuda"
    host = torch.empty((len(columns),) + tuple(first.shape),
                       dtype=first.dtype if dtype is None else dtype,
                       pin_memory=pinned)
    for lane, col in enumerate(columns):
        host[lane].copy_(torch.from_numpy(col))
    if not pinned:
        return host.to(device)
    return host.to(device, non_blocking=True)


def _split_lanes(n_lanes: int, n_kept, order, outputs=None,
                 flags=None) -> List[Any]:
    """Copies the stacked results to the host once and splits them into
    each lane's (n_kept, order[, outputs, flags])."""
    n_kept = n_kept.cpu()
    order = order.cpu()
    if outputs is None:
        return [(n_kept[i], order[i]) for i in range(n_lanes)]
    outputs = {name: col.cpu() for name, col in outputs.items()}
    flags = flags.cpu()
    return [(n_kept[i], order[i], {name: col[i] for name, col in
                                   outputs.items()}, flags[i])
            for i in range(n_lanes)]


def _dispatch_aggregate(launches) -> List[Any]:
    """One lane-batched aggregation release for the group."""
    n_lanes = len(launches)
    first = launches[0]
    device = torch.device(first.device)
    pid = _stack([l.pid for l in launches], device, torch.int32)
    pk = _stack([l.pk for l in launches], device, torch.int32)
    values = _stack([l.values for l in launches], device, first.dtype)
    valid = _stack([l.valid for l in launches], device)
    keys = np.stack([np.asarray(l.key, np.uint32) for l in launches])
    min_v, max_v, min_s, max_s, mid = first.scalars
    with rt_trace.span("batch_dispatch", lanes=n_lanes, lane_bucket=n_lanes,
                       kind="aggregate"):
        n_kept, order, outputs, flags = \
            executor.batched_aggregate_release_kernel(
                pid, pk, values, valid, min_v, max_v, min_s, max_s, mid,
                first.stds, keys, first.cfg, first.secure_tables)
        results = _split_lanes(n_lanes, n_kept, order, outputs, flags)
        _record_batch(n_lanes)
    return results


def _dispatch_select(launches) -> List[Any]:
    """One lane-batched standalone-selection release for the group."""
    n_lanes = len(launches)
    first = launches[0]
    device = torch.device(first.device)
    pid = _stack([l.pid for l in launches], device, torch.int32)
    pk = _stack([l.pk for l in launches], device, torch.int32)
    valid = _stack([l.valid for l in launches], device)
    keys = np.stack([np.asarray(l.key, np.uint32) for l in launches])
    with rt_trace.span("batch_dispatch", lanes=n_lanes, lane_bucket=n_lanes,
                       kind="select"):
        n_kept, order = executor.batched_select_partitions_release_kernel(
            pid, pk, valid, keys, first.l0, first.n_partitions,
            first.selection, first.dtype)
        results = _split_lanes(n_lanes, n_kept, order)
        _record_batch(n_lanes)
    return results


def _stage_lane(launch: "executor.ReleaseLaunch"):
    """The lane's rows through the host LPT permutation its solo meshed
    run takes (sharded.shard_rows_by_pid); selection never reads values,
    so it stages a zero-width column, as the solo meshed selection does."""
    from pipelinedp_tpu_torch.parallel import sharded
    values = (launch.values if launch.kind == "aggregate" else
              np.zeros((len(launch.pid), 0)))
    return sharded.shard_rows_by_pid(
        np.asarray(launch.pid), np.asarray(launch.pk), values,
        np.asarray(launch.valid), launch.mesh.size)


def _dispatch_meshed(launches) -> List[Any]:
    """The meshed lane-batched releases of the group (the JAX package's
    _dispatch_meshed, batching.py:290): the lanes, staged by _stage_lane
    on their workers, grouped by staged layout (the per-shard capacity
    depends on the data), each group of two or more run as one meshed
    lane-batched release; a lane alone in its layout gets None and runs
    solo."""
    from pipelinedp_tpu_torch.parallel import sharded

    first = launches[0]
    mesh = first.mesh
    staged = [launch.staged for launch in launches]
    by_layout: Dict[Any, List[int]] = {}
    for i, (spid, _, svalues, _) in enumerate(staged):
        by_layout.setdefault((spid.shape, svalues.shape), []).append(i)
    results: List[Any] = [None] * len(launches)
    for indices in by_layout.values():
        if len(indices) < 2:
            continue
        n_lanes = len(indices)
        shards = sharded.stage_lanes(mesh, [staged[i] for i in indices],
                                     first.dtype)
        keys = np.stack([np.asarray(launches[i].key, np.uint32)
                         for i in indices])
        with rt_trace.span("batch_dispatch", lanes=n_lanes,
                           lane_bucket=n_lanes, kind=first.kind,
                           meshed=True):
            if first.kind == "aggregate":
                min_v, max_v, min_s, max_s, mid = first.scalars
                n_kept, order, outputs, flags = \
                    sharded.sharded_batched_release(
                        mesh, shards, min_v, max_v, min_s, max_s, mid,
                        first.stds, keys, first.cfg, first.secure_tables)
                lane_results = _split_lanes(n_lanes, n_kept, order, outputs,
                                            flags)
            else:
                n_kept, order = sharded.sharded_batched_select_release(
                    mesh, shards, keys, first.l0, first.n_partitions,
                    first.selection, first.dtype)
                lane_results = _split_lanes(n_lanes, n_kept, order)
            _record_batch(n_lanes)
        for lane_pos, i in enumerate(indices):
            results[i] = lane_results[lane_pos]
    return results
