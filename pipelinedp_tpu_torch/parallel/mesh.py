"""The device mesh of the port: D shard slots driven by one process.

Port of pipelinedp_tpu/parallel/mesh.py. The JAX package's mesh is
single-controller: one process drives D devices through shard_map, and
TPUBackend(mesh=) takes every row on the host and shards it. The port
keeps that model without shard_map. A Mesh is an ordered tuple of D
torch.device shard slots; shard s's rows live on devices[s], the meshed
drivers (parallel/sharded.py) launch every shard's kernels from this one
process, and parallel/collectives.py moves the per-shard tensors between
the slots (the counterparts of lax.psum, all_gather and all_to_all).

Every slot is a Slot: its torch device, a stable id and the index of the
process that owns it, the counterpart of a jax.Device (device.id,
device.process_index). Ids are what the elastic runtime works on
(runtime/faults.py names lost slots by id, join_candidates fills new ids):
a mesh rebuilt over the survivors of a device loss keeps each survivor's
id, and the ids are part of the mesh's equality. Mesh.devices stays the
tuple of torch devices the drivers launch on.

A device may fill several slots. Four slots on cuda:0 make a 4-shard mesh
on one card: the per-shard kernels, the cross-shard combine (C21) and the
exchange (C22, C23) all run for real, and the "copies" between slots are
views. Eight slots on the CPU serve the tests, as the JAX tests' eight
host-platform devices do. On a host with several cards, make_mesh() puts
shard s on cuda:s and the slots' tensors move by peer copy.

A ShardedColumn is the counterpart of a jax.Array row-sharded over the
mesh (NamedSharding(mesh, P(SHARD_AXIS))): D equal-length tensors, shard s
on devices[s], whose global row order is shard 0's rows, then shard 1's,
and so on. The single-process pod ingest (ingest.encode_local_shard_to_mesh)
makes such columns, and the meshed releases stage them where they lie.

The multi-process form (one process per card, torch.distributed) is the
counterpart of the JAX package's runtime/multihost.py and is not ported
(ROADMAP.md Queue 1 step 9): here process_index() is 0 and
process_count() 1. A slot may still name another process (Slot(...,
process_index=1)): device_process, mesh_processes, is_fully_addressable
and cross_process_fraction read it, and probe_live_devices learns such a
slot's liveness through collective_heartbeat (K23c), which runs C21's
int32 entry over one int32 of ones a slot. The cross-process all_reduce
over torch.distributed that it stands for is step 9's; this process
still drives every slot.

The elastic runtime's liveness (probe_live_devices) and scale-up
(join_candidates) live here, as in the JAX package.

host_fetch is the one sanctioned device-to-host fetch of the meshed
paths: control tables of O(D^2) entries (the exchange's send counts),
never rows. reshard.forbid_row_fetches forbids every other host
materialization of a large tensor in its scope, so a test can prove that
device-resident rows reshard without visiting the host. A transient
failure of the fetch is retried with jittered backoff (fetch_retry_scope
sets the budget).
"""

import contextlib
import logging
import random
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

SHARD_AXIS = "shards"
# Shard slots a mesh may have: C23's target table
# (csrc/reshard_exchange.cu, kMaxShards) holds 32; C21's compensated entry
# and C22 take 64.
MAX_SHARDS = 32

Device = Union[str, torch.device]


def _canonical(device) -> torch.device:
    """cuda without an index means the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Slot:
    """One shard slot of a mesh: its torch device, a stable id (the
    counterpart of jax.Device.id) and the process that owns it (of
    jax.Device.process_index; 0 unless named). Equal when all three
    are."""

    __slots__ = ("id", "device", "process_index")

    def __init__(self, id_: int, device: Device, process_index: int = 0):
        self.id = int(id_)
        self.device = _canonical(device)
        self.process_index = int(process_index)

    def _key(self):
        return (self.id, self.device, self.process_index)

    def __eq__(self, other) -> bool:
        return isinstance(other, Slot) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        proc = (f", process {self.process_index}" if self.process_index
                else "")
        return f"Slot({self.id}, {self.device}{proc})"


class Mesh:
    """An ordered tuple of D shard slots (parallel/mesh.Slot). Shard s's
    rows and partial columns live on devices[s] (a device may repeat);
    the replicated release runs on devices[0], the gathering device.

    Built from Slots, which keep their ids, or from devices, which get
    ids in order, the smallest not taken by a Slot given beside them."""

    __slots__ = ("slots", "devices")

    def __init__(self, devices: Sequence[Union[Device, Slot]]):
        devices = list(devices)
        if not 1 <= len(devices) <= MAX_SHARDS:
            raise ValueError(f"a mesh has 1 to {MAX_SHARDS} shard slots, "
                             f"got {len(devices)}")
        taken = {d.id for d in devices if isinstance(d, Slot)}
        slots, next_id = [], 0
        for d in devices:
            if not isinstance(d, Slot):
                while next_id in taken:
                    next_id += 1
                d = Slot(next_id, d)
                next_id += 1
            slots.append(d)
        ids = [s.id for s in slots]
        if len(set(ids)) != len(ids):
            raise ValueError(f"mesh slot ids must be distinct, got {ids}")
        kinds = {s.device.type for s in slots}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"mesh devices must all be cuda or all cpu, "
                             f"got {[str(s.device) for s in slots]}")
        self.slots: Tuple[Slot, ...] = tuple(slots)
        self.devices: Tuple[torch.device, ...] = tuple(
            s.device for s in slots)

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def ids(self) -> Tuple[int, ...]:
        return tuple(s.id for s in self.slots)

    @property
    def device(self) -> torch.device:
        """The gathering device: where the cross-shard combine lands and
        the replicated release runs."""
        return self.devices[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.slots == other.slots

    def __hash__(self) -> int:
        return hash(self.slots)

    def __repr__(self) -> str:
        return f"Mesh({list(self.slots)})"


def on_device(device: torch.device):
    """Makes `device` the current CUDA device for the scope (a no-op for
    the CPU): the kernels launch on the current device's streams, so a
    shard's launches run under its own card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _visible_cuda_slots() -> List[Slot]:
    """One slot on every visible CUDA card, id = the card's index."""
    return [Slot(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence[Union[Device, Slot]]] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """A mesh over `devices` (torch devices or Slots), or over every
    visible CUDA device (the first n_devices of them). Without devices=
    it needs CUDA and raises without it: the port never builds a CPU mesh
    on its own; tests pass devices=["cpu"] * D."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available. The mesh defaults to "
                "every visible CUDA device; pass devices= explicitly (for "
                "example ['cpu'] * 8 for the kernels' plain versions).")
        devices = _visible_cuda_slots()
        if n_devices is not None:
            devices = devices[:n_devices]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices)


class ShardedColumn:
    """A column of rows split over a mesh: shards[s] (one length, dtype and
    row shape for all s) lies on mesh.devices[s], and the global row order
    is the shards' concatenation. n (default: every row) is the global
    length; rows past it are the invalid padding of the even split, as
    the JAX package pads a global array to D equal shards."""

    __slots__ = ("shards", "mesh", "n")

    def __init__(self, shards: Sequence[torch.Tensor], mesh: "Mesh",
                 n: Optional[int] = None):
        shards = tuple(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"ShardedColumn: {len(shards)} shards for a "
                             f"mesh of {mesh.size}")
        first = shards[0]
        for s, (t, dev) in enumerate(zip(shards, mesh.devices)):
            if t.device != dev or t.shape != first.shape or \
                    t.dtype != first.dtype:
                raise ValueError(
                    f"ShardedColumn: shard {s} is {t.dtype}"
                    f"{list(t.shape)} on {t.device}; expected "
                    f"{first.dtype}{list(first.shape)} on {dev}")
        total = mesh.size * first.shape[0]
        n = total if n is None else int(n)
        if not 0 <= n <= total:
            raise ValueError(f"ShardedColumn: {n} rows do not fit {total}")
        self.shards, self.mesh, self.n = shards, mesh, n

    def __len__(self) -> int:
        return self.n

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def map(self, fn) -> "ShardedColumn":
        """fn applied to every shard where it lies (row-wise functions)."""
        return ShardedColumn([fn(t) for t in self.shards], self.mesh, self.n)

    def __ge__(self, other) -> "ShardedColumn":
        return self.map(lambda t: t >= other)

    def global_rows(self, device) -> torch.Tensor:
        """The n global rows as one tensor on `device`."""
        return torch.cat([t.to(device) for t in self.shards])[:self.n]


def resplit(col: ShardedColumn, mesh: "Mesh", per_shard: int, fill,
            n: Optional[int] = None) -> ShardedColumn:
    """col's global rows, padded with `fill` to mesh.size * per_shard and
    split evenly over `mesh` (a global array padded and device_put to the
    even row split, in the JAX package). A target shard that is exactly a
    source shard on its device is that tensor, not a copy. n: the result's
    global length (default len(col))."""
    src_len = col.shards[0].shape[0]
    rest = tuple(col.shards[0].shape[1:])
    out = []
    for t, dev in enumerate(mesh.devices):
        lo, hi = t * per_shard, (t + 1) * per_shard
        pieces, pos = [], lo
        while pos < hi:
            if pos < len(col):
                s, off = divmod(pos, src_len)
                take = min(hi, len(col), (s + 1) * src_len) - pos
                part = col.shards[s]
                if take < src_len:
                    part = part[off:off + take]
                pieces.append(part.to(dev))
                pos += take
            else:
                pieces.append(torch.full((hi - pos,) + rest, fill,
                                         dtype=col.dtype, device=dev))
                pos = hi
        out.append(pieces[0].contiguous() if len(pieces) == 1 else
                   torch.cat(pieces))
    return ShardedColumn(out, mesh, len(col) if n is None else n)


def process_index() -> int:
    """This controller's process index: 0, the port's meshes being
    driven by one process."""
    return 0


def process_count() -> int:
    """Number of controller processes: 1."""
    return 1


def device_process(device) -> int:
    """The process that owns a slot (its process_index; 0 for objects
    without one, torch devices included)."""
    return int(getattr(device, "process_index", 0))


def local_devices(mesh: Mesh) -> List[torch.device]:
    """The devices of the mesh slots this process owns, in mesh order."""
    me = process_index()
    return [s.device for s in mesh.slots if device_process(s) == me]


def is_fully_addressable(mesh: Mesh) -> bool:
    """Every slot belongs to this process."""
    return len(local_devices(mesh)) == mesh.size


def mesh_processes(mesh: Mesh) -> List[int]:
    """Sorted process indices owning the mesh's slots."""
    return sorted({device_process(s) for s in mesh.slots})


def cross_process_fraction(mesh: Mesh) -> float:
    """Fraction of ordered shard pairs whose exchange traffic crosses
    processes."""
    devs = mesh.slots
    d = len(devs)
    if d <= 1:
        return 0.0
    pairs = sum(1 for a in devs for b in devs
                if device_process(a) != device_process(b))
    return pairs / float(d * (d - 1))


def collective_heartbeat(devices: Sequence) -> set:
    """K23c, the remote-liveness oracle of probe_live_devices (the JAX
    package's mesh.py:150, a psum of ones over a mesh of the candidates):
    one int32[1] of ones on each slot's device, gathered onto the first
    slot's device, summed by C21's int32 entry (kernels.heartbeat_sum)
    and fetched as one scalar. Raises unless the sum is D; returns the
    candidate slots.

    Every slot is launched on from this process: the all_reduce over
    torch.distributed that reaches another process's cards is ROADMAP.md
    Queue 1 step 9's. A failed build or launch raises; nothing moves to
    the CPU."""
    from pipelinedp_tpu_torch import kernels  # kernels imports this module
    slots = Mesh(devices).slots
    gathering = slots[0].device
    ones = [torch.ones(1, dtype=torch.int32, device=s.device) for s in slots]
    with on_device(gathering):
        stack = torch.stack([t.to(gathering, non_blocking=True)
                             for t in ones])
        total = int(host_fetch(kernels.heartbeat_sum(stack),
                               max_retries=0)[0])
    if total != len(slots):
        raise RuntimeError(
            f"heartbeat psum returned {total}, expected {len(slots)}")
    return set(slots)


def _slot_device(d) -> torch.device:
    return d.device if isinstance(d, Slot) else torch.device(d)


def probe_live_devices(devices: Sequence, heartbeat=None) -> List:
    """The liveness probe of the elastic runtime (runtime/retry.py): which
    of `devices` (Slots, or objects with an id and a process_index) can
    carry a rebuilt mesh.

    A slot of this process gets the direct proof: a one-element round trip
    on its device (a failed launch or copy marks it lost). Slots of
    another process are learned indirectly: an active fault schedule is
    authoritative (whatever it has not marked lost is alive), otherwise
    collective_heartbeat over the candidates (heartbeat=, for tests) must
    complete, and if it fails every remote slot is treated as lost and
    the failure is logged. Returns the live ones in their order.
    """
    from pipelinedp_tpu_torch.runtime import faults as rt_faults
    lost_ids = rt_faults.injected_lost_device_ids(devices)
    me = process_index()
    remote = [d for d in devices if device_process(d) != me]
    remote_live = set()
    if remote:
        candidates = [d for d in remote
                      if getattr(d, "id", None) not in lost_ids]
        if rt_faults.active() is not None:
            remote_live = set(candidates)
        elif candidates:
            hb = heartbeat if heartbeat is not None else collective_heartbeat
            try:
                remote_live = set(hb(list(devices))) & set(candidates)
            except Exception as e:  # noqa: BLE001 - any heartbeat failure = remote liveness unprovable
                logging.warning(
                    "liveness probe: collective heartbeat over %d devices "
                    "failed (%s: %s) — remote liveness cannot be "
                    "established, treating all %d non-addressable devices "
                    "as lost.", len(devices), type(e).__name__,
                    str(e).splitlines()[0][:160], len(remote))
                remote_live = set()
    live = []
    for d in devices:
        if getattr(d, "id", None) in lost_ids:
            logging.warning(
                "liveness probe: device %s marked lost by the active "
                "fault schedule.", d)
            continue
        if device_process(d) != me:
            if d in remote_live:
                live.append(d)
            continue
        try:
            # max_retries=0: a slot that cannot answer one round trip
            # without retries is not one to rebuild the mesh on.
            host_fetch(torch.zeros(1, dtype=torch.int32,
                                   device=_slot_device(d)), max_retries=0)
        except Exception as e:  # noqa: BLE001 - any failure = dead slot
            logging.warning(
                "liveness probe: device %s failed its probe round trip "
                "(%s: %s) — treating it as lost.", d,
                type(e).__name__, str(e).splitlines()[0][:160])
            continue
        live.append(d)
    return live


def join_candidates(mesh: Mesh, devices: Optional[Sequence] = None,
                    n_devices: Optional[int] = None) -> List:
    """Slots eligible to JOIN `mesh` in an elastic scale-up: an explicit
    list (slots whose id the mesh has are dropped), or enough new slots to
    bring the mesh to `n_devices`, in the port's enumeration order: the
    visible CUDA cards (slot id = card index) or, for a CPU mesh or a mesh
    whose slots share one device, new slots on that device with the
    smallest free ids. The JAX package fills from jax.devices() (ROADMAP.md
    Queue 3 states the difference). Candidates are only nominated here;
    the elastic runtime probes them before rebuilding the mesh."""
    current = {getattr(d, "id", d) for d in mesh.slots}
    if devices is not None:
        return [d for d in devices if getattr(d, "id", d) not in current]
    if n_devices is None:
        return []
    want = int(n_devices) - len(current)
    if want <= 0:
        return []
    shared = set(mesh.devices)
    if len(shared) == 1 and (mesh.device.type == "cpu" or mesh.size > 1):
        out, id_ = [], 0
        while len(out) < want:
            if id_ not in current:
                out.append(Slot(id_, mesh.device))
            id_ += 1
        return out
    if not torch.cuda.is_available():
        return []
    return [s for s in _visible_cuda_slots() if s.id not in current][:want]


def round_capacity(x: int, min_cap: int = 8) -> int:
    """Round up keeping 4 significant bits (<= 1/16 ~ 6.25% slack, 12.5%
    worst-case just above a power of two), as the JAX package pads its
    per-shard capacities."""
    x = max(int(x), min_cap)
    step = 1 << max((x - 1).bit_length() - 4, 3)
    return -(-x // step) * step


def rows_per_shard(n: int, n_shards: int) -> int:
    """Padded per-shard capacity for an even leading-axis split of n rows:
    ceil(n / n_shards) rounded to a bounded-shape capacity."""
    return round_capacity(-(-max(int(n), 1) // n_shards))


# Thread-local marker read by reshard.forbid_row_fetches so the guard can
# tell a sanctioned control-table fetch from a row download.
_sanctioned_fetch = threading.local()

# Thread-local override of host_fetch's retry budget, scoped by the
# drivers' runtime entry from the RetryPolicy.
_fetch_policy = threading.local()
_DEFAULT_FETCH_RETRIES = 2

# Backoff jitter: retries of several processes must not collide on one
# instant. Never touches noise or sampling.
_jitter = random.Random()


@contextlib.contextmanager
def fetch_retry_scope(max_retries: Optional[int]):
    """Scopes a retry budget onto every host_fetch on this thread (None
    leaves the default, 2)."""
    if max_retries is None:
        yield
        return
    prev = getattr(_fetch_policy, "max_retries", None)
    _fetch_policy.max_retries = int(max_retries)
    try:
        yield
    finally:
        _fetch_policy.max_retries = prev


def host_fetch(t, max_retries: Optional[int] = None) -> np.ndarray:
    """The sanctioned small device-to-host fetch for meshed control tables
    (O(D^2) entries, never rows). A sync point: it waits for the kernels
    that wrote the table. Transient failures (runtime/retry.is_transient)
    are retried max_retries times (default: the scoped budget, else 2)
    with jittered exponential backoff, each retry spending the job's
    retry budget; any other failure raises."""
    from pipelinedp_tpu_torch.runtime import retry as rt_retry
    from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
    if max_retries is None:
        max_retries = getattr(_fetch_policy, "max_retries", None)
        if max_retries is None:
            max_retries = _DEFAULT_FETCH_RETRIES
    _sanctioned_fetch.active = True
    try:
        attempt = 0
        while True:
            try:
                return (t.cpu().numpy() if isinstance(t, torch.Tensor) else
                        np.asarray(t))
            except Exception as e:  # noqa: BLE001 - classified below
                if not rt_retry.is_transient(e) or attempt >= max_retries:
                    raise
                rt_retry.consume_retry_budget("host_fetch")
                delay = min(0.05 * 2**attempt, 1.0) * (0.5 +
                                                       0.5 * _jitter.random())
                attempt += 1
                rt_telemetry.record("host_fetch_retries")
                logging.warning(
                    "control-table host fetch failed transiently (%s); "
                    "retry %d/%d in %.2fs", type(e).__name__, attempt,
                    max_retries, delay)
                time.sleep(delay)
    finally:
        _sanctioned_fetch.active = False
