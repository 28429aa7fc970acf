"""Very large partition spaces: the blocked partition-axis route.

Port of pipelinedp_tpu/parallel/large_p.py for one device. Dense [0, P)
columns are right up to P ~ 10^6; at P = 10^7..10^9 (the reference's
unbounded-key shuffle regime, ``pipeline_dp/pipeline_backend.py:339-352``)
the release runs over the partition axis in blocks of C partitions:

  1. **Bound once** (pass 1): contribution bounding is a row-space
     computation (executor.bounded_row_columns: C1, C5, C2), then one C5
     sort by kept partition. The sorted stream (skey2, perm) holds the
     kept rows in ascending partition order and the dropped rows, whose
     key2 is the n_partitions sentinel, at its tail.
  2. **Bin by partition block**: block b owns partitions [b*C, (b+1)*C);
     C10 (block_window_offsets, the boundaries made in the kernel) finds
     every block's row window in the stream. The last boundary is clamped
     to the range's end, so the sentinel rows fall in no window and the
     last offset is the survivor count.
  3. **Finalize per block**: C3's windowed entry reduces the block's rows
     to dense [C] columns (partition = skey2 - base), C4 selects and
     noises them under the block's own key, C7/C8 run its quantile trees
     and C9 its vector sums, and C6 sorts kept partitions to the front.
     Blocks are independent: selection and noise are pointwise over
     partitions.
  4. **Drain**: only each block's (n_kept, flag word) gate and its O(kept)
     ids and values are copied to the host, into pinned memory without
     blocking; at most PIPELINE_DEPTH blocks are in flight.

Two row-staging regimes, switched on whether the rows fit one chunk:

  * **Device-resident** (n <= row_chunk): pass 1 runs once and every
    block reads its window through perm.
  * **Host-staged** (n > row_chunk): rows are split into chunks on
    privacy-id boundaries (_chunk_ends), each chunk is bounded and sorted
    on the card, C11 (gather_rows) gathers its k survivors' columns, only
    those O(kept) rows cross to the host, and the host merges the chunks
    with one stable argsort and uploads the merged stream once; blocks
    then read it in order (perm None).

Random keys follow the JAX package's blocked functions, not the dense
route: rows_key, final_key = split(rng_key); pass 1 under
fold_in(rows_key, 0) (or fold_in(rows_key, ci) for host-staged chunk ci);
block j of a range under _block_noise_key(final_key, generation, j),
which finalize splits into (key_sel, key_noise), with the block's
quantile trees under fold_in(block_key, 7919). Standalone selection
splits rng_key into (key_l0, key_sel) and draws block j's keep decisions
with the block key itself.

Over a device mesh (aggregate_blocked_sharded,
select_partitions_blocked_sharded; the JAX package's meshed variants,
K23a): stage_rows_to_mesh puts every privacy id's rows on one shard, pass
1 runs on each shard under fold_in(rows_key, shard), one C10 launch a
distinct device finds the block windows of its shards' streams, and the
[D, n_blocks + 1] offsets table is the one fetch that scales with the
blocks. Each block reduces every shard's own window (C3's windowed
entry), one C21 launch sums the D partial columns onto the mesh's first
device, and the release (C4, C7 / C8 with each level's counts summed by
C21, C9, C6) runs there once. A D = 1 mesh releases what the unmeshed
route releases, bit for bit.

Failure semantics (runtime/retry.py, runtime/faults.py, runtime/entry.py;
the JAX package's, for every driver here): each block's launches run
under retry.retry_call (transient failures re-launch the same closure, so
the same block key); a transient failure at the block's host sync
re-dispatches the block under the same key; an OOM (after the earlier
in-flight blocks are consumed) becomes BlockOOMError, and
retry.run_with_degradation halves the block capacity and re-plans the
rest of the range under the next generation of _block_noise_key. Every
driver enters through runtime_entry (job health scope, retry budgets);
with elastic=True or elastic_grow=True the meshed two run in the elastic
loop, which re-enters them on a rebuilt mesh after a device loss or a
join, and at one slot runs the unsharded driver on that slot's device.
Not ported yet (ROADMAP.md Queue 1 step 4): the block journal (journal=,
the replay of consumed blocks), the watchdog (timeout_s=, watchdog=) and
the overlapped drainer (overlap=); they raise NotImplementedError.
"""

import dataclasses
import functools
import logging
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.device_encode import round_capacity
from pipelinedp_tpu_torch.ops import threefry
from pipelinedp_tpu_torch.parallel import collectives
from pipelinedp_tpu_torch.parallel import sharded
from pipelinedp_tpu_torch.parallel.mesh import (Mesh, ShardedColumn,
                                                host_fetch, on_device)
from pipelinedp_tpu_torch.parallel.reshard import stage_rows_to_mesh
from pipelinedp_tpu_torch.runtime import entry as rt_entry
from pipelinedp_tpu_torch.runtime import faults as rt_faults
from pipelinedp_tpu_torch.runtime import retry as rt_retry
from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
# Blocks in flight at once: each pins its O(C) outputs on the device until
# the host has read its gate; the streamed ingest's staging window shares
# the depth.
from pipelinedp_tpu_torch.runtime.pipeline import PIPELINE_DEPTH

# Key lane of OOM-re-planned block generations: a block key is a pure
# function of (final_key, plan generation, block index), so a re-planned
# block (another partition geometry) never reuses a consumed key.
_REPLAN_KEY_LANE = 0x7265706C  # 'repl'


def _block_noise_key(final_key, generation: int, block: int) -> np.ndarray:
    """The key of block `block` of plan generation `generation`
    (large_p.py:110-117 of the JAX package)."""
    if generation == 0:
        return threefry.fold_in(final_key, block)
    return threefry.fold_in(
        threefry.fold_in(final_key, _REPLAN_KEY_LANE + generation), block)


def _chunk_ends(pid_sorted: np.ndarray, row_chunk: int) -> np.ndarray:
    """Chunk end offsets, each extended to the next privacy-id boundary:
    a privacy id's rows stay in one chunk, since L0 bounding is global per
    id (large_p.py:230 of the JAX package)."""
    n = len(pid_sorted)
    ends = []
    start = 0
    while start < n:
        end = min(start + row_chunk, n)
        if end < n:
            end = int(np.searchsorted(pid_sorted, pid_sorted[end - 1],
                                      side="right"))
        if end - start > 2 * row_chunk:
            logging.warning(
                "large_p: a single privacy id spans %d rows (> 2x row_chunk="
                "%d); its chunk cannot be split without breaking per-id "
                "contribution bounding. Device memory for this chunk scales "
                "with that id's row count.", end - start, row_chunk)
        ends.append(end)
        start = end
    return np.asarray(ends)


@dataclasses.dataclass
class _Stream:
    """Pass 1's rows in ascending kept-partition order (the dropped rows'
    n_partitions sentinel at the tail). perm maps a sorted row to its
    bounded row, whose pair_start and columns it indexes, and the value of
    bounded row r is values[row_perm[r]]; perm None (the host-staged
    stream) means every array is already in sorted order."""
    skey2: torch.Tensor
    perm: Optional[torch.Tensor]
    pair_start: torch.Tensor
    cols: Dict[str, torch.Tensor]
    row_perm: Optional[torch.Tensor] = None
    values: Optional[torch.Tensor] = None

    def window(self, lo: int, hi: int):
        """(skey2, perm, pair_start, cols, (row_perm, values)) of sorted
        rows [lo, hi), as C3's and C7's windowed entries take them."""
        if self.perm is not None:
            return (self.skey2[lo:hi], self.perm[lo:hi], self.pair_start,
                    self.cols, (self.row_perm, self.values))
        return (self.skey2[lo:hi], None, self.pair_start[lo:hi],
                {name: col[lo:hi] for name, col in self.cols.items()},
                (None, None if self.values is None else self.values[lo:hi]))


class _HostCopy:
    """A device tensor on its way to the host: on a CUDA tensor a copy into
    pinned memory that does not block, done once the CUDA event recorded
    after it has passed; on the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def wait(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host


class _StagedDrain:
    """O(kept) result copies started when a block is consumed and read
    once, after the dispatch loop: the copies overlap each other and the
    blocks still computing."""

    def __init__(self):
        self._staged = []

    def stage(self, target: list, t: torch.Tensor, transform=None) -> None:
        self._staged.append((target, _HostCopy(t), transform))

    def materialize(self) -> None:
        for target, copy, transform in self._staged:
            host = copy.wait().numpy()
            target.append(transform(host) if transform else host)
        self._staged.clear()


@dataclasses.dataclass
class _BlockResult:
    """One dispatched block: its gate on the way to the host, the kept-
    first order and output columns on the device."""
    gate: _HostCopy
    order: torch.Tensor
    outputs: Dict[str, torch.Tensor]


def _dispatch_blocks(block_iter, consume,
                     max_in_flight: int = PIPELINE_DEPTH,
                     retry_policy: Optional[rt_retry.RetryPolicy] = None
                     ) -> int:
    """Issues every block of block_iter ((j, make) pairs, make() launching
    block j and re-invokable: it derives its own block key) with at most
    max_in_flight dispatched and not yet consumed; consume(j, result)
    reads block j's gate and stages its drain, oldest first (the JAX
    package's _dispatch_blocks, :299).

    Each dispatch runs under retry.retry_call. Before consume, the block's
    gate copy is waited on, the sync point where an asynchronous launch
    failure surfaces; a transient failure there re-dispatches the block
    under the same key. An OOM-classified failure (or an exhausted
    deadline) at dispatch or at the sync becomes BlockOOMError(j) once
    every earlier in-flight block is consumed, so the caller re-plans from
    block j. Returns the number of blocks dispatched."""
    policy = retry_policy or rt_retry.DEFAULT_POLICY
    pending = deque()
    n_dispatched = 0

    def start(j, make):
        result = rt_retry.retry_call(make, policy, block=j)
        rt_telemetry.record("release_dispatches", block=j)
        return result

    def consume_one(j, result, make):
        attempt = 0
        while True:
            try:
                rt_faults.maybe_fail("consume", j)
                result.gate.wait()
                break
            except Exception as e:  # noqa: BLE001 - classified below
                if (not rt_retry.is_transient(e) or
                        attempt >= policy.max_retries):
                    raise
                delay = policy.delay(attempt)
                attempt += 1
                if rt_retry.is_timeout(e):
                    rt_telemetry.record("block_timeouts", block=j)
                rt_telemetry.record("block_retries", block=j)
                logging.warning(
                    "block %d failed at its sync point (%s); re-dispatching "
                    "under the same block key (retry %d/%d in %.2fs) — "
                    "noise is bit-identical, no second release", j,
                    type(e).__name__, attempt, policy.max_retries, delay)
                time.sleep(delay)
                result = start(j, make)
        consume(j, result)

    def degradable(err):
        return rt_retry.is_oom(err) or rt_retry.is_timeout(err)

    def consume_or_oom(j, result, make):
        try:
            consume_one(j, result, make)
        except Exception as err:  # noqa: BLE001 - degradable -> BlockOOMError, the rest re-raise
            if degradable(err):
                raise rt_retry.BlockOOMError(j, err) from err
            raise

    for j, make in block_iter:
        n_dispatched += 1
        try:
            result = start(j, make)
        except Exception as err:  # noqa: BLE001 - classified after the in-flight drain
            # Consume the earlier in-flight blocks first, so a re-plan
            # continues from this block. A secondary failure must not
            # mask the original error.
            try:
                while pending:
                    consume_one(*pending.popleft())
            except Exception:  # noqa: BLE001 - the original error wins
                logging.exception(
                    "draining in-flight blocks after a dispatch failure "
                    "itself failed; earlier results may be incomplete")
            if degradable(err):
                raise rt_retry.BlockOOMError(j, err) from err
            raise
        pending.append((j, result, make))
        if len(pending) >= max_in_flight:
            consume_or_oom(*pending.popleft())
    while pending:
        consume_or_oom(*pending.popleft())
    return n_dispatched


def _placement(pid, values, device, dtype) -> Tuple[torch.device,
                                                    torch.dtype]:
    """The device (given, else the inputs', else cuda) and working float
    dtype (_working_dtype) of a run."""
    if device is None:
        device = (pid.device if isinstance(pid, torch.Tensor) else
                  torch.device("cuda"))
    return torch.device(device), _working_dtype(values, dtype)


def _working_dtype(values, dtype: Optional[torch.dtype]) -> torch.dtype:
    """dtype if given, else the values' float dtype, else float32."""
    if dtype is not None:
        return dtype
    return (values.dtype if isinstance(values, torch.Tensor) and
            values.is_floating_point() else torch.float32)


def _to_host(a) -> Optional[np.ndarray]:
    if a is None or isinstance(a, np.ndarray):
        return a
    if isinstance(a, ShardedColumn):
        return a.global_rows("cpu").numpy()
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _padded(a, cap: int, fill, device, dtype) -> torch.Tensor:
    """Column `a` on the device as dtype, padded to cap rows with fill (a
    ShardedColumn in its global row order)."""
    if isinstance(a, ShardedColumn):
        a = a.global_rows(device)
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    t = t.to(device=device, dtype=dtype)
    if t.shape[0] < cap:
        t = torch.cat([t, torch.full((cap - t.shape[0],) + tuple(t.shape[1:]),
                                     fill, dtype=dtype, device=device)])
    return t.contiguous()


def _device_rows(pid, pk, values, valid, device, dtype):
    """The rows on the device, padded to round_capacity(n) with invalid
    rows, as the JAX package's pass 1 pads them (values None: none)."""
    cap = round_capacity(len(pid))
    return (_padded(pid, cap, 0, device, torch.int32),
            _padded(pk, cap, 0, device, torch.int32),
            None if values is None else _padded(values, cap, 0, device,
                                                dtype),
            _padded(valid, cap, False, device, torch.bool))


def _bound_compact(pid, pk, values, valid, scalars, key,
                   cfg: executor.KernelConfig) -> _Stream:
    """Pass 1 on the device: bounding (C1, C5, C2), then C5 by kept
    partition (large_p.py:120-153 of the JAX package)."""
    key2, pair_start, cols, (row_perm, vals) = executor.bounded_row_columns(
        pid, pk, values, valid, *scalars, key, cfg)
    perm, skey2 = kernels.radix_sort([key2], sorted_top=True)
    return _Stream(skey2, perm, pair_start, cols, row_perm, vals)


def _survivors(stream: _Stream, n_partitions: int, want_values: bool):
    """The kept rows of one chunk's stream, on the host: skey2, and
    pair_start, the columns and (want_values) the value rows gathered by
    C11 through perm (and row_perm), O(kept) bytes in all."""
    bound = torch.tensor([n_partitions], dtype=torch.int32,
                         device=stream.skey2.device)
    k = int(kernels.block_offsets(stream.skey2, bound)[0])
    idx = stream.perm[:k]
    names = list(stream.cols)
    columns = [stream.pair_start] + [stream.cols[m] for m in names]
    if want_values and stream.row_perm is not None:
        columns.append(stream.row_perm)
    got = kernels.gather_rows(idx, columns)
    values = None
    if want_values:
        vidx = got[-1] if stream.row_perm is not None else idx
        values = kernels.gather_rows(vidx, [stream.values])[0].cpu().numpy()
    return (stream.skey2[:k].cpu().numpy(), got[0].cpu().numpy(),
            {m: got[1 + j].cpu().numpy() for j, m in enumerate(names)},
            values)


def _bound_and_compact_host_staged(pid, pk, values, valid, scalars,
                                   rows_key, cfg: executor.KernelConfig,
                                   row_chunk: int, device,
                                   dtype) -> _Stream:
    """n > row_chunk: pass 1 chunk by chunk on privacy-id boundaries, each
    chunk's survivors staged on the host, merged by one stable argsort and
    uploaded once (large_p.py:647-692 of the JAX package)."""
    pid, pk, values, valid = (_to_host(pid), _to_host(pk), _to_host(values),
                              _to_host(valid))
    order = np.argsort(pid, kind="stable")
    pid_s, pk_s, values_s, valid_s = (pid[order], pk[order], values[order],
                                      valid[order])
    want_values = bool(cfg.quantiles or cfg.vector_size)
    parts = []
    start = 0
    for ci, end in enumerate(_chunk_ends(pid_s, row_chunk)):
        sl = slice(start, end)
        rows = _device_rows(pid_s[sl], pk_s[sl], values_s[sl], valid_s[sl],
                            device, dtype)
        stream = _bound_compact(*rows, scalars,
                                threefry.fold_in(rows_key, ci), cfg)
        parts.append(_survivors(stream, cfg.n_partitions, want_values))
        start = end
    skey2 = np.concatenate([p[0] for p in parts])
    order2 = np.argsort(skey2, kind="stable")

    def merged(chunks, torch_dtype):
        return torch.as_tensor(np.concatenate(chunks)[order2]).to(
            device=device, dtype=torch_dtype)

    cols = {m: merged([p[2][m] for p in parts], dtype) for m in parts[0][2]}
    return _Stream(
        merged([skey2], torch.int32), None,
        merged([p[1] for p in parts], torch.bool), cols,
        values=(merged([p[3] for p in parts], dtype) if want_values else
                None))


def _offsets(stream: _Stream, base: int, capacity: int, n_blocks: int,
             end: int) -> np.ndarray:
    """The row windows of the range's blocks (C10's block_window_offsets:
    the boundaries made on the device), on the host. The last boundary is
    clamped to `end`: the sentinel key2 = n_partitions lies in no window,
    whatever P % capacity."""
    return kernels.block_window_offsets(
        [stream.skey2], base, capacity, n_blocks, end)[0].cpu().numpy()


def _block(stream: _Stream, lo: int, hi: int, b_base: int, key, min_v,
           max_v, mid, stds: np.ndarray, cfg: executor.KernelConfig,
           secure_tables, dtype: torch.dtype) -> _BlockResult:
    """Finalizes partitions [b_base, b_base + cfg.n_partitions) from sorted
    rows [lo, hi) (large_p.py:156-212 of the JAX package): C3's windowed
    entry, then _release_block."""
    skey2, perm, pair_start, cols, vrows = stream.window(lo, hi)
    dense = _window_columns(skey2, perm, pair_start, cols, vrows, b_base,
                            cfg, dtype)
    dense["row_count"] = dense["pid_count"]
    return _release_block(dense, ((perm, skey2), vrows), None, b_base, key,
                          min_v, max_v, mid, stds, cfg, secure_tables, dtype)


def _window_columns(skey2, perm, pair_start, cols, vrows, b_base: int,
                    cfg: executor.KernelConfig, dtype: torch.dtype):
    """The block's dense [C] columns from one window (C3's windowed
    entry; compensated in numeric_mode="safe")."""
    return kernels.reduce_partitions(
        skey2, perm, pair_start, cols, cfg.n_partitions, dtype,
        vrows if cfg.vector_size else None,
        compensated=cfg.numeric_mode == "safe", base=b_base)


def _release_block(dense, qrows, combine, b_base: int, key, min_v, max_v,
                   mid, stds: np.ndarray, cfg: executor.KernelConfig,
                   secure_tables, dtype: torch.dtype) -> _BlockResult:
    """A block's release from its (combined) dense columns: C4 under the
    block key, C7/C8 (PERCENTILE) under fold_in(key, 7919) over qrows
    (one window's ((perm, skey2), vrows), or on a mesh a sequence a shard
    each, with combine summing their counts), C9 (VECTOR_SUM), then C6."""
    outputs, keep, flags = executor.finalize(dense, min_v, mid, stds, key,
                                             cfg, secure_tables)
    if cfg.quantiles:
        outputs.update(executor.quantile_outputs(
            *qrows, min_v, max_v, stds, threefry.fold_in(key, 7919), keep,
            flags, cfg, dtype, secure_tables, base=b_base, combine=combine))
    n_kept, order, outputs = kernels.compact_kept(keep, outputs)
    gate = _HostCopy(torch.stack([n_kept.reshape(()).to(torch.int64),
                                  flags.reshape(()).to(torch.int64)]))
    return _BlockResult(gate, order, outputs)


def _selection_block(stream: _Stream, lo: int, hi: int, b_base: int,
                     c_actual: int, key, selection,
                     dtype: torch.dtype) -> _BlockResult:
    """Keep decisions for partitions [b_base, b_base + c_actual) from the
    kept-pair rows [lo, hi) (large_p.py:1008-1047 of the JAX package):
    C3's windowed pid_count, C4 with an empty plan drawing under the block
    key itself, C6."""
    skey2, perm, pair_start, _, _ = stream.window(lo, hi)
    cols = kernels.reduce_partitions(skey2, perm, pair_start, {}, c_actual,
                                     dtype, base=b_base)
    n_kept, order = executor.select_release(cols, selection, key)
    return _BlockResult(_HostCopy(n_kept.reshape(1)), order, {})


def _add_time(phase_times: Optional[dict], name: str, since: float) -> None:
    if phase_times is not None:
        phase_times[name] = (phase_times.get(name, 0.0) +
                             time.perf_counter() - since)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _n_blocks(base: int, capacity: int, end: int) -> int:
    return -(-(end - base) // capacity) if end > base else 0


def _select_range(n_partitions: int, capacity0: int, offsets_of, launch,
                  key_sel, retry: Optional[rt_retry.RetryPolicy] = None
                  ) -> np.ndarray:
    """Pass 2 of a blocked selection over [0, n_partitions), in
    run_range(base, capacity, generation, end) ranges driven by
    retry.run_with_degradation (first range (0, capacity0, 0, P)):
    offsets_of(base, capacity, generation, n_blocks, end) gives the
    blocks' windows in the S streams as int64[S, n_blocks + 1];
    launch(lo[S], hi[S], b_base, c_actual, key) dispatches one block with
    a kept pair in some window, under its block key. Returns the kept
    ids, int64 ascending."""
    kept_ids: List[np.ndarray] = []
    drain = _StagedDrain()

    def run_range(base, capacity, generation, end):
        n_blocks = _n_blocks(base, capacity, end)
        offsets = offsets_of(base, capacity, generation, n_blocks, end)

        def consume(j, result):
            k = int(result.gate.wait()[0])
            if k:
                drain.stage(kept_ids, result.order[:k],
                            lambda h, b=base + j * capacity:
                            h.astype(np.int64) + b)

        def block_iter():
            for j in range(n_blocks):
                lo, hi = offsets[:, j], offsets[:, j + 1]
                if not (hi - lo).any():
                    # No kept pair: every partition's keep probability is
                    # 0, so the block provably emits nothing.
                    continue
                b_base = base + j * capacity
                yield j, functools.partial(
                    launch, lo, hi, b_base, min(capacity, end - b_base),
                    _block_noise_key(key_sel, generation, j))

        _dispatch_blocks(block_iter(), consume, retry_policy=retry)

    rt_retry.run_with_degradation(run_range, n_partitions, capacity0)
    drain.materialize()
    # Blocks are consumed in order and each block's kept ids come
    # ascending (C6 is stable): the concatenation is ascending.
    return (np.concatenate(kept_ids) if kept_ids else
            np.zeros(0, np.int64))


def _aggregate_range(cfg: executor.KernelConfig, capacity0: int, offsets_of,
                     launch, final_key, context: str,
                     phase_times: Optional[dict],
                     retry: Optional[rt_retry.RetryPolicy] = None
                     ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Pass 2 of a blocked aggregation over [0, cfg.n_partitions), in
    run_range ranges driven by retry.run_with_degradation (first range
    (0, capacity0, 0, P)): offsets_of as _select_range's;
    launch(lo[S], hi[S], b_base, key, cfg_block) dispatches one block.
    Each block's flag word is checked (numeric.check_release, context
    naming the block) before any of its values is kept. phase_times
    gains block_offsets, p2_dispatch, p2_sync_wait, p2_drain,
    p2_blocks_total and blocks_dispatched. Returns (kept ids int64
    ascending, {metric: array})."""
    output_names = [name for e in cfg.plan for name in e.outputs]
    kept_ids: List[np.ndarray] = []
    kept_outputs: Dict[str, List[np.ndarray]] = {m: [] for m in output_names}
    drain = _StagedDrain()
    n_dispatched = 0

    def run_range(base, capacity, generation, end):
        nonlocal n_dispatched
        to = time.perf_counter()
        n_blocks = _n_blocks(base, capacity, end)
        offsets = offsets_of(base, capacity, generation, n_blocks, end)
        _add_time(phase_times, "block_offsets", to)

        def consume(j, result):
            b_base = base + j * capacity
            ts = time.perf_counter()
            gate = result.gate.wait()
            _add_time(phase_times, "p2_sync_wait", ts)
            ta = time.perf_counter()
            k, flag_word = int(gate[0]), int(gate[1]) & 0xFFFFFFFF
            # Fail closed before any of the block's values is kept.
            numeric.check_release(flag_word, result.outputs,
                                  context=f"{context} (base {b_base})",
                                  numeric_mode=cfg.numeric_mode)
            if k:
                drain.stage(kept_ids, result.order[:k],
                            lambda h, b=b_base: h.astype(np.int64) + b)
                for name, col in result.outputs.items():
                    drain.stage(kept_outputs[name], col[:k])
            _add_time(phase_times, "p2_drain", ta)

        def dispatch(j, b_base, c_actual):
            td = time.perf_counter()
            result = launch(offsets[:, j], offsets[:, j + 1], b_base,
                            _block_noise_key(final_key, generation, j),
                            dataclasses.replace(cfg, n_partitions=c_actual))
            _add_time(phase_times, "p2_dispatch", td)
            return result

        def block_iter():
            for j in range(n_blocks):
                if cfg.private_selection and \
                        not (offsets[:, j + 1] - offsets[:, j]).any():
                    # Private selection keeps a row-less partition with
                    # probability 0: the block provably emits nothing.
                    # Public partitions are released, rows or not.
                    continue
                b_base = base + j * capacity
                yield j, functools.partial(dispatch, j, b_base,
                                           min(capacity, end - b_base))

        n_dispatched += _dispatch_blocks(block_iter(), consume,
                                         retry_policy=retry)

    t2 = time.perf_counter()
    rt_retry.run_with_degradation(run_range, cfg.n_partitions, capacity0)
    td = time.perf_counter()
    drain.materialize()
    if phase_times is not None:
        _add_time(phase_times, "p2_drain", td)
        phase_times["p2_blocks_total"] = time.perf_counter() - t2
        phase_times["blocks_dispatched"] = n_dispatched
    # Blocks are consumed in ascending order and each emits its kept
    # partitions ascending (C6 is stable): the concatenation is ascending.
    kept = (np.concatenate(kept_ids) if kept_ids else
            np.zeros(0, np.int64))
    return kept, {
        name: (np.concatenate(chunks) if chunks else np.zeros(0))
        for name, chunks in kept_outputs.items()
    }


@rt_entry.runtime_entry("select_partitions_blocked")
def select_partitions_blocked(pid, pk, valid, rng_key, l0: int,
                              n_partitions: int, selection, *,
                              block_partitions: int = 1 << 20,
                              device=None,
                              dtype: Optional[torch.dtype] = None,
                              retry: Optional[rt_retry.RetryPolicy] = None
                              ) -> np.ndarray:
    """Standalone DP partition selection over a huge partition space.

    The semantics of executor.select_partitions_release_kernel, but no
    [P] vector ever exists: pass 1 (executor.select_kept_pair_stream)
    sorts the L0-sampled pairs' rows by partition, and each block of
    block_partitions partitions with a kept pair draws its keep decisions
    and sends only its kept ids to the host. device / dtype: where the
    kernels run and the float width of the keep probabilities (defaults
    as _placement). retry: the RetryPolicy of the block dispatches
    (default retry.DEFAULT_POLICY); the runtime entry also takes job_id=.
    Returns kept_partition_ids int64[M], ascending.
    """
    P = n_partitions
    key_l0, key_sel = executor.select_key_schedule(rng_key)
    device, dtype = _placement(pid, None, device, dtype)
    pid_t, pk_t, _, valid_t = _device_rows(pid, pk, None, valid, device,
                                           dtype)
    skey2, perm, pair_start = executor.select_kept_pair_stream(
        pid_t, pk_t, valid_t, key_l0, l0, P)
    stream = _Stream(skey2, perm, pair_start, {})
    return _select_range(
        P, min(block_partitions, P),
        lambda base, capacity, _gen, n_blocks, end: _offsets(
            stream, base, capacity, n_blocks, end)[None],
        lambda lo, hi, b_base, c_actual, key: _selection_block(
            stream, int(lo[0]), int(hi[0]), b_base, c_actual, key,
            selection, dtype),
        key_sel, retry)


@rt_entry.runtime_entry("aggregate_blocked")
def aggregate_blocked(pid, pk, values, valid, min_v, max_v, min_s, max_s,
                      mid, stds, rng_key, cfg: executor.KernelConfig, *,
                      block_partitions: int = 1 << 20,
                      row_chunk: int = 1 << 24,
                      secure_tables=None,
                      phase_times: Optional[dict] = None,
                      device=None,
                      dtype: Optional[torch.dtype] = None,
                      retry: Optional[rt_retry.RetryPolicy] = None
                      ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """DP aggregation over an arbitrarily large partition space.

    The semantics of executor.aggregate_release_kernel, percentiles and
    vector sums included, with the partition axis processed in blocks of
    block_partitions and only kept partitions returned. Inputs are host
    arrays or tensors; n <= row_chunk rows run pass 1 once on the device,
    more go through the host-staged regime. secure_tables: (thr, gran) of
    executor.build_secure_tables, required when cfg.secure. device /
    dtype: where the kernels run and the working float width (defaults as
    _placement). retry: the RetryPolicy of the block dispatches; the
    runtime entry also takes job_id=.

    phase_times: optional dict filled with wall seconds by phase, as the
    JAX package's aggregate_blocked (p1_bound_compact, block_offsets,
    p2_blocks_total, p2_sync_wait, p2_drain, blocks_dispatched, total),
    plus p2_dispatch, the host's time issuing the blocks (key derivation
    and launches). It adds one device synchronisation after pass 1.

    Returns (kept_partition_ids int64[M] ascending, {metric: array[M]}).
    """
    t0 = time.perf_counter()
    device, dtype = _placement(pid, values, device, dtype)
    P = cfg.n_partitions
    n = len(pid)
    if values is None:
        values = np.zeros(n)
    stds = np.asarray(stds, dtype=np.float64)
    rows_key, final_key = executor.release_key_halves(rng_key)
    scalars = (min_v, max_v, min_s, max_s, mid)

    # Pass 1: bound the rows, sort the survivors by partition.
    if n <= row_chunk:
        stream = _bound_compact(
            *_device_rows(pid, pk, values, valid, device, dtype), scalars,
            threefry.fold_in(rows_key, 0), cfg)
    else:
        stream = _bound_and_compact_host_staged(
            pid, pk, values, valid, scalars, rows_key, cfg, row_chunk,
            device, dtype)
    if phase_times is not None:
        _sync(device)
        phase_times["p1_bound_compact"] = time.perf_counter() - t0

    # Pass 2: bin the stream by partition block, finalize each block.
    out = _aggregate_range(
        cfg, min(block_partitions, P),
        lambda base, capacity, _gen, n_blocks, end: _offsets(
            stream, base, capacity, n_blocks, end)[None],
        lambda lo, hi, b_base, key, cfg_block: _block(
            stream, int(lo[0]), int(hi[0]), b_base, key, min_v, max_v, mid,
            stds, cfg_block, secure_tables, dtype),
        final_key, "blocked release", phase_times, retry)
    if phase_times is not None:
        phase_times["total"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Over a device mesh (K23a)


def _sharded_block_offsets(mesh: Mesh, streams: Sequence[_Stream], base: int,
                           capacity: int, n_blocks: int,
                           end: int) -> np.ndarray:
    """The row windows of the range's blocks on every shard (the JAX
    package's _sharded_block_offsets, :785), the last boundary clamped to
    `end` as _offsets clamps it: one C10 launch (block_window_offsets)
    over the streams of each distinct device of the mesh, the tables
    gathered onto the mesh's first device and fetched as one
    int64[D, n_blocks + 1] table in shard order (its all_gather and
    host_fetch). On a mesh whose slots share a card that is one launch
    and nothing uploaded."""
    by_device: Dict[torch.device, List[int]] = {}
    for s, dev in enumerate(mesh.devices):
        by_device.setdefault(dev, []).append(s)
    tables, order = [], []
    for dev, shards in by_device.items():
        with on_device(dev):
            tables.append(kernels.block_window_offsets(
                [streams[s].skey2 for s in shards], base, capacity,
                n_blocks, end).to(mesh.device, non_blocking=True))
        order += shards
    table = host_fetch(tables[0] if len(tables) == 1 else
                       torch.cat(tables))
    if order != sorted(order):
        table = table[np.argsort(order)]
    return table


def _sharded_bound_compact(mesh: Mesh, shards, scalars, rows_key,
                           cfg: executor.KernelConfig, capacity: int,
                           n_blocks: int) -> Tuple[List[_Stream],
                                                   np.ndarray]:
    """Pass 1 over the mesh (the JAX package's _sharded_bound_compact,
    :696): every shard's rows bounded and sorted by kept partition
    (_bound_compact: C1, C5, C2, C5) on its device under
    fold_in(rows_key, shard), then the offsets table of the first
    n_blocks blocks of `capacity` partitions. Returns (one _Stream a
    shard, each on its device; the int64[D, n_blocks + 1] table)."""
    streams = []
    for s, rows in enumerate(shards):
        with on_device(mesh.devices[s]):
            streams.append(_bound_compact(*rows, scalars,
                                          threefry.fold_in(rows_key, s), cfg))
    return streams, _sharded_block_offsets(mesh, streams, 0, capacity,
                                           n_blocks, cfg.n_partitions)


def _sharded_block(mesh: Mesh, streams: Sequence[_Stream], lo: np.ndarray,
                   hi: np.ndarray, b_base: int, key, min_v, max_v, mid,
                   stds: np.ndarray, cfg: executor.KernelConfig,
                   secure_tables, dtype: torch.dtype,
                   phase_times: Optional[dict] = None) -> _BlockResult:
    """One block over the mesh (the JAX package's _sharded_block_kernel,
    :743): C3's windowed entry on every shard over its window
    [lo[s], hi[s]), one C21 launch summing the D partial columns onto the
    mesh's first device (compensated in numeric_mode="safe"), and the
    release there once (_release_block; each quantile level's counts
    summed by C21). phase_times["p2_combine"]: the host's time issuing
    the combine."""
    windows = [stream.window(int(a), int(b))
               for stream, a, b in zip(streams, lo, hi)]
    parts = []
    for dev, (skey2, perm, pair_start, cols, vrows) in zip(mesh.devices,
                                                            windows):
        with on_device(dev):
            parts.append(_window_columns(skey2, perm, pair_start, cols,
                                         vrows, b_base, cfg, dtype))
    tc = time.perf_counter()
    dense = sharded._combine_partials(parts, mesh.device, cfg.numeric_mode)
    _add_time(phase_times, "p2_combine", tc)
    qrows = ([(w[1], w[0]) for w in windows], [w[4] for w in windows])
    return _release_block(dense, qrows, sharded._psum_counts(mesh), b_base,
                          key, min_v, max_v, mid, stds, cfg, secure_tables,
                          dtype)


def _sharded_select_compact(mesh: Mesh, shards, key_l0, l0: int,
                            n_partitions: int, capacity: int,
                            n_blocks: int) -> Tuple[List[_Stream],
                                                    np.ndarray]:
    """Selection pass 1 over the mesh (the JAX package's
    _sharded_select_compact, :1052): executor.select_kept_pair_stream on
    every shard under fold_in(key_l0, shard), then the offsets table, as
    _sharded_bound_compact."""
    streams = []
    for s, (pid_s, pk_s, _, valid_s) in enumerate(shards):
        with on_device(mesh.devices[s]):
            skey2, perm, pair_start = executor.select_kept_pair_stream(
                pid_s, pk_s, valid_s, threefry.fold_in(key_l0, s), l0,
                n_partitions)
        streams.append(_Stream(skey2, perm, pair_start, {}))
    return streams, _sharded_block_offsets(mesh, streams, 0, capacity,
                                           n_blocks, n_partitions)


def _sharded_selection_block(mesh: Mesh, streams: Sequence[_Stream],
                             lo: np.ndarray, hi: np.ndarray, b_base: int,
                             c_actual: int, key, selection,
                             dtype: torch.dtype) -> _BlockResult:
    """Keep decisions of one block over the mesh (the JAX package's
    _sharded_selection_block, :1089): every shard's windowed pid counts
    (C3, no columns), one int32 C21 launch summing them, and
    executor.select_release once under the block key (C4 with an empty
    plan, C6)."""
    counts = []
    for dev, stream, a, b in zip(mesh.devices, streams, lo, hi):
        skey2, perm, pair_start, _, _ = stream.window(int(a), int(b))
        with on_device(dev):
            cols = kernels.reduce_partitions(skey2, perm, pair_start, {},
                                             c_actual, dtype, base=b_base)
            counts.append(cols["pid_count"].to(torch.int32))
    total = collectives.psum(counts, mesh.device).to(dtype)
    n_kept, order = executor.select_release(
        {"count": total, "pid_count": total}, selection, key)
    return _BlockResult(_HostCopy(n_kept.reshape(1)), order, {})


def _meshed_offsets(mesh: Mesh, streams: Sequence[_Stream], capacity0: int,
                    offsets0: np.ndarray):
    """offsets_of of a meshed driver: generation 0 starts at base 0 with
    capacity C0, so pass 1's table is the plan's; a re-plan (another
    generation or capacity) runs C10 over the shards again."""
    def offsets_of(base, capacity, generation, n_blocks, end):
        if generation == 0 and capacity == capacity0:
            return offsets0
        return _sharded_block_offsets(mesh, streams, base, capacity,
                                      n_blocks, end)
    return offsets_of


def _fallback_blocked_aggregate(mesh: Mesh, args, kwargs, job):
    """Elastic floor of aggregate_blocked_sharded: the unsharded blocked
    driver on the surviving slot's device. Both split rng_key alike and
    derive the same block keys, and a one-shard pass 1 runs under
    fold_in(rows_key, 0) as the single-chunk unsharded one does."""
    kw = {k: v for k, v in kwargs.items() if k != "reshard"}
    return aggregate_blocked(*args[1:], job_id=job, device=mesh.device,
                             **kw)


def _fallback_blocked_select(mesh: Mesh, args, kwargs, job):
    """Elastic floor of select_partitions_blocked_sharded (see
    _fallback_blocked_aggregate)."""
    kw = {k: v for k, v in kwargs.items() if k != "reshard"}
    return select_partitions_blocked(*args[1:], job_id=job,
                                     device=mesh.device, **kw)


@rt_entry.runtime_entry("aggregate_blocked_sharded",
                        fallback=_fallback_blocked_aggregate)
def aggregate_blocked_sharded(mesh: Mesh, pid, pk, values, valid, min_v,
                              max_v, min_s, max_s, mid, stds, rng_key,
                              cfg: executor.KernelConfig, *,
                              block_partitions: int = 1 << 20,
                              secure_tables=None, reshard: str = "auto",
                              phase_times: Optional[dict] = None,
                              dtype: Optional[torch.dtype] = None,
                              retry: Optional[rt_retry.RetryPolicy] = None
                              ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """aggregate_blocked over a device mesh (the JAX package's
    aggregate_blocked_sharded, :823).

    Rows in (host numpy or device tensors) are staged by
    stage_rows_to_mesh under `reshard` ("auto": device-resident columns
    take the exchange, C22 / C23; host rows the LPT permutation). Pass 1
    runs a shard at a time (_sharded_bound_compact), and each block of
    block_partitions partitions reduces every shard's window, combines
    them with one C21 launch and releases on the mesh's first device
    (_sharded_block), where secure_tables lie. dtype: the working float
    (default as _placement). retry: the RetryPolicy of the block
    dispatches. The runtime entry adds job_id=, elastic=, elastic_grow=
    and min_devices=: with elastic a device loss re-enters here on a mesh
    of the surviving slots, and at one slot aggregate_blocked runs on its
    device (the same release: block keys do not depend on the mesh).

    phase_times: as aggregate_blocked's, plus staging (the reshard) and
    p2_combine (the host's time issuing the per-block C21, inside
    p2_dispatch). It adds a device synchronisation after the staging and
    one after pass 1.

    Returns (kept_partition_ids int64[M] ascending, {metric: array[M]}).
    """
    t0 = time.perf_counter()
    dtype = _working_dtype(values, dtype)
    P = cfg.n_partitions
    if values is None:
        values = np.zeros(len(pid))
    stds = np.asarray(stds, dtype=np.float64)
    rows_key, final_key = executor.release_key_halves(rng_key)
    capacity0 = min(block_partitions, P)
    shards = stage_rows_to_mesh(mesh, pid, pk, values, valid, reshard, dtype)
    if phase_times is not None:
        for dev in set(mesh.devices):
            _sync(dev)
        phase_times["staging"] = time.perf_counter() - t0
    with sharded._collective_launch(mesh), on_device(mesh.device):
        t1 = time.perf_counter()
        streams, offsets0 = _sharded_bound_compact(
            mesh, shards, (min_v, max_v, min_s, max_s, mid), rows_key, cfg,
            capacity0, _n_blocks(0, capacity0, P))
        if phase_times is not None:
            phase_times["p1_bound_compact"] = time.perf_counter() - t1
        out = _aggregate_range(
            cfg, capacity0,
            _meshed_offsets(mesh, streams, capacity0, offsets0),
            lambda lo, hi, b_base, key, cfg_block: _sharded_block(
                mesh, streams, lo, hi, b_base, key, min_v, max_v, mid, stds,
                cfg_block, secure_tables, dtype, phase_times),
            final_key, "blocked meshed release", phase_times, retry)
    if phase_times is not None:
        phase_times["total"] = time.perf_counter() - t0
    return out


@rt_entry.runtime_entry("select_partitions_blocked_sharded",
                        fallback=_fallback_blocked_select)
def select_partitions_blocked_sharded(mesh: Mesh, pid, pk, valid, rng_key,
                                      l0: int, n_partitions: int, selection,
                                      *, block_partitions: int = 1 << 20,
                                      reshard: str = "auto",
                                      dtype: Optional[torch.dtype] = None,
                                      retry: Optional[
                                          rt_retry.RetryPolicy] = None
                                      ) -> np.ndarray:
    """select_partitions_blocked over a device mesh (the JAX package's
    select_partitions_blocked_sharded, :1118): rows staged without values
    (stage_rows_to_mesh), each shard's kept-pair stream
    (_sharded_select_compact), and for each block with a kept pair on
    some shard one int32 C21 launch and the keep decisions on the mesh's
    first device (_sharded_selection_block). dtype: the float width of
    the keep probabilities (default float32). retry and the runtime
    entry's knobs as aggregate_blocked_sharded's. Returns
    kept_partition_ids int64[M], ascending."""
    P = n_partitions
    dtype = dtype or torch.float32
    key_l0, key_sel = executor.select_key_schedule(rng_key)
    capacity0 = min(block_partitions, P)
    shards = stage_rows_to_mesh(mesh, pid, pk, None, valid, reshard)
    with sharded._collective_launch(mesh), on_device(mesh.device):
        streams, offsets0 = _sharded_select_compact(
            mesh, shards, key_l0, l0, P, capacity0,
            _n_blocks(0, capacity0, P))
        return _select_range(
            P, capacity0,
            _meshed_offsets(mesh, streams, capacity0, offsets0),
            lambda lo, hi, b_base, c_actual, key: _sharded_selection_block(
                mesh, streams, lo, hi, b_base, c_actual, key, selection,
                dtype),
            key_sel, retry)
