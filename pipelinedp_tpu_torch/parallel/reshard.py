"""Co-locating each privacy id's rows on one shard of the mesh.

Port of pipelinedp_tpu/parallel/reshard.py. Every meshed release needs
all of a privacy id's rows on one shard (contribution bounding is global
per id). stage_rows_to_mesh takes the rows and returns one
(pid, pk, values, valid) tuple a shard, each on its shard's device, every
id's rows on exactly one shard, invalid-padded to one capacity:

  * host numpy rows take the exact load-balanced LPT permutation
    (sharded.shard_rows_by_pid, the JAX package's own) and one upload a
    shard;
  * device-resident rows (the streamed ingest's, or any with
    reshard="device") reshard on the device, device_reshard_rows_by_pid:
      1. the rows are split evenly over the shards (_pad_and_shard: the
         even split of rows_per_shard(n, D) the JAX package's device_put
         makes);
      2. C22 reshard_count on every shard: each row's destination
         dest = hash_mix(u32(pid) * 0x9E3779B9 ^ salt) % D, the [D] send
         counts and each row's stable rank within its destination;
      3. the [D, D] send table (D^2 ints) is the one device-to-host fetch
         (mesh.host_fetch): it gives [max send, max receive, total] as
         :120-122 of the JAX package derive them, the output capacity
         round_capacity(max receive), and every source's offset in every
         destination;
      4. C23 reshard_exchange on every shard writes each valid row to
         offset[s][d] + rank, and the padding past each shard's received
         rows: row for row the JAX package's all_to_all + valid-first
         compaction, with no sort. A destination on another card gets a
         staged slice and a peer copy (collectives.all_to_all).

The capacity cache of the JAX package is kept: the rounded
(cap_send, out_cap) pair of an exchange geometry (the mesh, the padded
per-shard input, the salt, the value shape and dtype) is reused while
the measured loads fit it, so a repeated exchange gives the same shapes
(reshard_capacity_reuse counts the hits). The port needs the send table
for the offsets in any case, so there is no optimistic dispatch to
overlap with the fetch.

Stated difference (ROADMAP.md Queue 3): the JAX package degrades a failed
collective exchange to the host permutation (reshard.py:387-420 there).
The port does not: a failed build, launch or copy of the exchange raises.
The exchange is the device_loss fault's "collective" hook point
(runtime/faults.py, the JAX package's :382): a slot lost there is
device-fatal and raises to the elastic loop (runtime/retry.py), which
rebuilds the mesh and stages the rows again for its geometry.
"""

import collections
import contextlib
import logging
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import collectives
from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
from pipelinedp_tpu_torch.parallel.mesh import (Mesh, ShardedColumn,
                                                host_fetch, on_device,
                                                round_capacity,
                                                rows_per_shard)
from pipelinedp_tpu_torch.runtime import faults as rt_faults
from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
from pipelinedp_tpu_torch.runtime import trace as rt_trace
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

# Fetches at or below this many elements are control-plane sized; the
# transfer guard treats anything larger as row data.
_CONTROL_TABLE_ELEMENTS = 1 << 12

# One shard's rows: (pid int32, pk int32, values or None, valid bool).
ShardRows = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                  torch.Tensor]

def _dest_shard(pid: torch.Tensor, n_shards: int, salt: int) -> torch.Tensor:
    """Destination shard of each row (the JAX package's _dest_shard):
    kernels.dest_shard, a pure function of pid, so all rows of a privacy
    id map to one shard wherever they start."""
    return kernels.dest_shard(pid, n_shards, salt)


def _pad_and_shard(mesh: Mesh, per_shard_cap: int, pid, pk, values,
                   valid) -> List[ShardRows]:
    """Pads the device columns to D * per_shard_cap with invalid rows (pid
    0, pk -1, values 0) and splits them evenly: shard s gets rows
    [s * cap, (s + 1) * cap), on its device (a view where it already
    lies there). ShardedColumns (the pod ingest's) are split again in
    their global row order; a shard already at its place stays where it
    lies, as the JAX package passes an array already in this layout
    through."""
    n_shards = mesh.size
    if isinstance(pid, ShardedColumn):
        cols = [None if col is None else
                mesh_lib.resplit(col, mesh, per_shard_cap, fill).shards
                for col, fill in ((pid, 0), (pk, -1), (values, 0),
                                  (valid, False))]
        return [tuple(None if c is None else c[s] for c in cols)
                for s in range(n_shards)]
    pad = n_shards * per_shard_cap - pid.shape[0]

    def padded(col, fill):
        if col is None or not pad:
            return col
        return torch.cat([col, col.new_full((pad,) + tuple(col.shape[1:]),
                                            fill)])

    cols = (padded(pid, 0), padded(pk, -1), padded(values, 0),
            padded(valid, False))

    def shard(col, s):
        if col is None:
            return None
        part = col[s * per_shard_cap:(s + 1) * per_shard_cap]
        return part.to(mesh.devices[s], non_blocking=True)

    return [tuple(shard(c, s) for c in cols) for s in range(n_shards)]


# Rounded (cap_send, out_cap) pairs per exchange geometry, insertion-
# ordered for FIFO eviction.
_capacity_lock = threading.Lock()
_capacity_cache: "collections.OrderedDict[tuple, Tuple[int, int]]" = \
    collections.OrderedDict()
_CAPACITY_CACHE_MAX = 64
_GUARDED_BY = guarded_by("_capacity_lock", "_capacity_cache")


def reset_capacity_cache() -> None:
    """Drops the cached exchange capacities (test isolation)."""
    with _capacity_lock:
        _capacity_cache.clear()


def _capacity_key(mesh: Mesh, per_in: int, salt: int, values) -> tuple:
    shape = () if values is None else tuple(values.shape[1:])
    dtype = None if values is None else str(values.dtype)
    return (mesh.devices, int(per_in), int(salt), shape, dtype)


def _warn_skew(max_recv: int, total: int, n_shards: int) -> None:
    if total and max_recv * n_shards > 2 * total:
        logging.warning(
            "device reshard: hash-bucketed max shard load %d > 2x mean "
            "(%.0f) — a few privacy ids dominate the row mass, so the "
            "hash balance assumption (load ~ n/D) does not hold for this "
            "input; the hot shard bounds the padded capacity.", max_recv,
            total / n_shards)


def exchange_capacities(table: np.ndarray, key: tuple) -> Tuple[int, int]:
    """(cap_send, out_cap) of an exchange from its [D, D] send table
    (table[s][d]: rows of shard s for shard d): the cached pair while
    [max send, max receive] fit it, else the rounded measured pair."""
    recv = table.sum(axis=0)
    max_send, max_recv, total = (int(table.max()), int(recv.max()),
                                 int(recv.sum()))
    _warn_skew(max_recv, total, table.shape[0])
    with _capacity_lock:
        cached = _capacity_cache.get(key)
        if cached is not None and max_send <= cached[0] and \
                max_recv <= cached[1]:
            rt_telemetry.record("reshard_capacity_reuse")
            return cached
        caps = (round_capacity(max_send), round_capacity(max_recv))
        _capacity_cache[key] = caps
        while len(_capacity_cache) > _CAPACITY_CACHE_MAX:
            _capacity_cache.popitem(last=False)
    return caps


def _empty_rows(device, cap: int, values) -> ShardRows:
    return (torch.empty(cap, dtype=torch.int32, device=device),
            torch.empty(cap, dtype=torch.int32, device=device),
            None if values is None else torch.empty(
                (cap,) + tuple(values.shape[1:]), dtype=values.dtype,
                device=device),
            torch.empty(cap, dtype=torch.bool, device=device))


def _rows_slice(rows: ShardRows, start: int, size: int) -> ShardRows:
    return tuple(None if c is None else c[start:start + size] for c in rows)


def device_reshard_rows_by_pid(mesh: Mesh, pid, pk, values, valid,
                               salt: int = 0) -> List[ShardRows]:
    """Device-native counterpart of sharded.shard_rows_by_pid (the JAX
    package's device_reshard_rows_by_pid): device-resident columns in,
    one (pid, pk, values, valid) a shard out, of out_cap rows each, every
    privacy id's rows on one shard, invalid-padded. No row visits the
    host: the only device-to-host copy is the [D, D] send table."""
    n_shards = mesh.size
    n = pid.shape[0]
    if n_shards == 1:
        return _pad_and_shard(mesh, round_capacity(n), pid, pk, values,
                              valid)
    per_in = rows_per_shard(n, n_shards)
    shards = _pad_and_shard(mesh, per_in, pid, pk, values, valid)
    counted = []
    for dev, (s_pid, _, _, s_valid) in zip(mesh.devices, shards):
        with on_device(dev):
            counted.append(kernels.reshard_count(s_pid, s_valid, n_shards,
                                                 salt))
    table = host_fetch(collectives.gather(
        [counts[:n_shards] for _, _, counts in counted], mesh.device))
    table = table.astype(np.int64)
    _, out_cap = exchange_capacities(
        table, _capacity_key(mesh, per_in, salt, values))
    recv = table.sum(axis=0)
    offsets = np.cumsum(table, axis=0) - table  # [s][d]: rows before s
    outs = [_empty_rows(dev, out_cap, values) for dev in mesh.devices]
    copies = []
    for s, ((s_pid, s_pk, s_values, _), (dest, rank, _)) in enumerate(
            zip(shards, counted)):
        src_dev = mesh.devices[s]
        targets = []
        for d in range(n_shards):
            if mesh.devices[d] == src_dev:
                targets.append(outs[d] + (int(offsets[s, d]),))
            else:
                staged = _empty_rows(src_dev, int(table[s, d]), values)
                targets.append(staged + (0,))
                copies += list(zip(
                    _rows_slice(outs[d], int(offsets[s, d]),
                                int(table[s, d])), staged))
        with on_device(src_dev):
            kernels.reshard_exchange(s_pid, s_pk, s_values, dest, rank,
                                     targets, outs[s] + (int(recv[s]),))
    collectives.all_to_all([(dst, src) for dst, src in copies
                            if dst is not None])
    return outs


def _host_rows(pid, pk, values, valid):
    """Host numpy copies or views of row columns given as numpy, tensors
    or ShardedColumns (their global rows)."""
    def host(col):
        if isinstance(col, ShardedColumn):
            return col.global_rows("cpu").numpy()
        return col.cpu().numpy() if isinstance(col, torch.Tensor) else \
            np.asarray(col)
    return host(pid), host(pk), None if values is None else host(values), \
        host(valid)


def stage_rows_to_mesh(mesh: Mesh, pid, pk, values, valid,
                       reshard: str = "auto",
                       dtype: Optional[torch.dtype] = None
                       ) -> List[ShardRows]:
    """Shared input staging of every meshed entry point: rows in (host
    numpy or device tensors), one pid-co-located ShardRows a shard out.

    reshard:
      * "auto": device-resident tensors and ShardedColumns take the
        device exchange (C22, C23; rows never touch the host), each shard
        of a ShardedColumn counted and sent from where it lies; host
        numpy takes the exact LPT host permutation (it pays one upload
        either way);
      * "host": the host permutation (device rows are fetched first; every
        port mesh is fully addressable);
      * "device": the device exchange (host rows are uploaded to the
        gathering device first, unbalanced).
    values may be None (selection); dtype is the values' working float.
    A failed exchange raises: there is no host fallback.
    """
    input_validators.validate_reshard(reshard, "stage_rows_to_mesh")
    device_resident = isinstance(pid, (torch.Tensor, ShardedColumn))
    use_device = reshard == "device" or (reshard == "auto" and
                                         device_resident)
    if use_device:
        if not device_resident:
            dev = mesh.device
            pid, pk, valid = (torch.as_tensor(pid, dtype=torch.int32).to(dev),
                              torch.as_tensor(pk, dtype=torch.int32).to(dev),
                              torch.as_tensor(valid).to(dev))
            if values is not None:
                values = torch.as_tensor(values).to(dev)
        if values is not None and dtype is not None:
            values = (values.map(lambda t: t.to(dtype))
                      if isinstance(values, ShardedColumn) else
                      values.to(dtype))
        with rt_trace.span("reshard.collective"):
            # A slot lost during the exchange: device-fatal, raised to the
            # elastic loop.
            rt_faults.maybe_fail("device_loss", point="collective")
            return device_reshard_rows_by_pid(mesh, pid, pk, values, valid)
    from pipelinedp_tpu_torch.parallel import sharded
    with rt_trace.span("reshard.host"):
        pid, pk, values, valid = _host_rows(pid, pk, values, valid)
        # Selection has no values: a zero-width column moves nothing.
        spid, spk, svalues, svalid = sharded.shard_rows_by_pid(
            pid, pk, np.zeros((len(pid), 0)) if values is None else values,
            valid, mesh.size)
        cap = len(spid) // mesh.size
        out = []
        for s, dev in enumerate(mesh.devices):
            part = slice(s * cap, (s + 1) * cap)
            out.append((
                torch.as_tensor(spid[part], dtype=torch.int32).to(dev),
                torch.as_tensor(spk[part], dtype=torch.int32).to(dev),
                None if values is None else torch.as_tensor(
                    svalues[part]).to(device=dev, dtype=dtype),
                torch.as_tensor(svalid[part]).to(dev)))
        return out


@contextlib.contextmanager
def forbid_row_fetches(max_elements: int = _CONTROL_TABLE_ELEMENTS):
    """Transfer guard proving rows never leave the device in its scope:
    Tensor.cpu / numpy / tolist and np.asarray of a tensor larger than a
    control table raise unless they run inside mesh.host_fetch. (On the
    CPU a tensor's .numpy() is no copy, so the guard instruments the
    materialization calls themselves, as the JAX package's does.)"""
    cls = torch.Tensor
    originals = {name: getattr(cls, name)
                 for name in ("cpu", "numpy", "tolist", "__array__")}

    def guard(name):
        real = originals[name]

        def guarded(t, *args, **kwargs):
            if t.numel() > max_elements and not getattr(
                    mesh_lib._sanctioned_fetch, "active", False):
                raise AssertionError(
                    f"O(rows) device->host fetch ({name}) of shape "
                    f"{tuple(t.shape)} inside a forbid_row_fetches scope — "
                    f"the device-resident path must not stage rows through "
                    f"the host")
            return real(t, *args, **kwargs)

        return guarded

    for name in originals:
        setattr(cls, name, guard(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(cls, name, fn)
