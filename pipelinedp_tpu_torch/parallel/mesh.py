"""The device mesh of the port: D shard slots driven by one process.

Port of pipelinedp_tpu/parallel/mesh.py. The JAX package's mesh is
single-controller: one process drives D devices through shard_map, and
TPUBackend(mesh=) takes every row on the host and shards it. The port
keeps that model without shard_map. A Mesh is an ordered tuple of D
torch.device shard slots; shard s's rows live on devices[s], the meshed
drivers (parallel/sharded.py) launch every shard's kernels from this one
process, and parallel/collectives.py moves the per-shard tensors between
the slots (the counterparts of lax.psum, all_gather and all_to_all).

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
(ROADMAP.md Queue 1 step 9): here process_index() is 0, process_count()
1, device_process() 0, and every mesh is fully addressable.

host_fetch is the one sanctioned device-to-host fetch of the meshed
paths: control tables of O(D^2) entries (the exchange's send counts),
never rows. reshard.forbid_row_fetches forbids every other host
materialization of a large tensor in its scope, so a test can prove that
device-resident rows reshard without visiting the host.
"""

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

SHARD_AXIS = "shards"
# Shard slots a mesh may have: C23's target table
# (csrc/reshard_exchange.cu, kMaxShards) holds 32; C21's compensated entry
# and C22 take 64.
MAX_SHARDS = 32

Device = Union[str, torch.device]


class Mesh:
    """An ordered tuple of D torch.device shard slots (a device may
    repeat). Shard s's rows and partial columns live on devices[s]; the
    replicated release runs on devices[0], the gathering device."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[Device]):
        devs = tuple(torch.device(d) for d in devices)
        if not 1 <= len(devs) <= MAX_SHARDS:
            raise ValueError(f"a mesh has 1 to {MAX_SHARDS} shard slots, "
                             f"got {len(devs)}")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"mesh devices must all be cuda or all cpu, "
                             f"got {[str(d) for d in devs]}")
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device("cuda", d.index if d.index is not None else
                         torch.cuda.current_device())
            if d.type == "cuda" else d for d in devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The gathering device: where the cross-shard combine lands and
        the replicated release runs."""
        return self.devices[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def on_device(device: torch.device):
    """Makes `device` the current CUDA device for the scope (a no-op for
    the CPU): the kernels launch on the current device's streams, so a
    shard's launches run under its own card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def make_mesh(devices: Optional[Sequence[Device]] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """A mesh over `devices`, or over every visible CUDA device (the first
    n_devices of them). Without devices= it needs CUDA and raises without
    it: the port never builds a CPU mesh on its own; tests pass
    devices=["cpu"] * D."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available. The mesh defaults to "
                "every visible CUDA device; pass devices= explicitly (for "
                "example ['cpu'] * 8 for the kernels' plain versions).")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
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
    single-controller."""
    return 0


def process_count() -> int:
    """Number of controller processes: 1."""
    return 1


def device_process(device) -> int:
    """The process that owns a device: 0."""
    del device
    return 0


def local_devices(mesh: Mesh):
    """The mesh devices this process addresses, in mesh order: all."""
    return list(mesh.devices)


def is_fully_addressable(mesh: Mesh) -> bool:
    """Every slot belongs to this process."""
    return len(local_devices(mesh)) == mesh.size


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


def host_fetch(t: torch.Tensor) -> np.ndarray:
    """The sanctioned small device-to-host fetch for meshed control tables
    (O(D^2) entries, never rows). A sync point: it waits for the kernels
    that wrote the table."""
    _sanctioned_fetch.active = True
    try:
        return t.cpu().numpy()
    finally:
        _sanctioned_fetch.active = False
