"""Streamed ingest: overlapped host encode -> device row buffers.

Port of the single-device part of pipelinedp_tpu/runtime/pipeline.py, the
pieces that let DPEngine.aggregate / select_partitions take a stream of
column chunks instead of one Python collection:

  * **ChunkSource** marks an iterable of ``(pid_raw, pk_raw, values)``
    column chunks as streamed input; the executor encodes it through
    ``ingest.stream_encode_columns`` under the backend's ``encode_threads``
    / ``pipeline_depth`` / ``encode_mode`` knobs.
  * **map_overlapped**: chunk k+1 encodes on a small host thread pool
    while chunk k lands on the device. At most ``PIPELINE_DEPTH`` chunks
    are in flight (a semaphore: a slow consumer stops the producer), and
    results come back in input order, so the sequential vocabulary merge
    sees the chunks as a serial loop would.
  * **DeviceRowAccumulator**: encoded chunks land in persistent device
    buffers sized to power-of-two row buckets (``executor.row_bucket``).
    On the card the rows travel from pinned host memory by an
    asynchronous copy on a side stream, and C14 (kernels.fill_tail,
    kernels.grow_rows) writes the pad tail and grows the buffers;
    ``finalize()`` returns buffers equal to ``executor.pad_rows`` over the
    concatenated rows, so streamed and serial input feed the kernels the
    same arrays and release the same noise.

Left out here, with ROADMAP.md Queue 1 item 13 (the runtime): the fault
injection, telemetry, trace spans and byte accounting of the JAX module
(its :64-67, :401-419, :428) and the watchdog guards of the staging waits;
a stalled producer or worker blocks the consumer.
"""

import os
import queue
import threading
from concurrent import futures
from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch import kernels

# One depth for every async pipeline of the port: the blocked drivers keep
# at most this many blocks in flight (parallel/large_p.py imports it) and
# the streamed ingest at most this many encoded chunks in its window, so
# host and device memory hold O(depth) intermediates, never O(stream).
PIPELINE_DEPTH = 8

# Rows the accumulator stages on the host before one device append: a
# stream of small chunks lands in a handful of copies instead of one per
# chunk, with the same final buffers. 0 appends chunk by chunk.
APPEND_BATCH_ROWS = 1 << 16


def default_encode_threads() -> int:
    """The encode pool's size when the backend leaves it unset: enough
    workers to overlap encode with the device, at most 4 (numpy's sorts
    release the GIL)."""
    return max(1, min(4, os.cpu_count() or 1))


class ChunkSource:
    """Marks an iterable of ``(pid_raw, pk_raw, values)`` column chunks as
    streamed input for ``DPEngine.aggregate`` / ``select_partitions``.

    nonfinite: the NaN/Inf value policy of every chunk ("error" | "drop"),
        as in ``ingest.stream_encode_columns``.
    encode_mode: "host" | "hash_device" | None. None defers to the
        backend's ``encode_mode``. "hash_device" hashes keys on the host
        and assigns the codes on the device (device_encode.py), decoding
        partition keys only at the DP-selected indices.

    A list (or another re-iterable) of chunks lets the hash route fall
    back to the exact host encoder after a detected hash collision; a
    one-shot iterator raises instead.
    """

    def __init__(self, chunks: Iterable, nonfinite: str = "error",
                 encode_mode: Optional[str] = None):
        if nonfinite not in ("error", "drop"):
            raise ValueError(
                f"nonfinite must be error|drop, got {nonfinite!r}")
        if encode_mode is not None:
            input_validators.validate_encode_mode(encode_mode, "ChunkSource")
        self.chunks = chunks
        self.nonfinite = nonfinite
        self.encode_mode = encode_mode


def _validate_window(encode_threads: int, depth: int) -> None:
    if not isinstance(encode_threads, int) or isinstance(
            encode_threads, bool) or encode_threads < 1:
        raise ValueError(f"encode_threads must be an integer >= 1 inside "
                         f"the pipeline, got {encode_threads!r}")
    if not isinstance(depth, int) or isinstance(depth, bool) or depth < 1:
        raise ValueError(
            f"pipeline_depth must be an integer >= 1, got {depth!r}")


def map_overlapped(items: Iterable, fn, encode_threads: int,
                   depth: Optional[int] = None) -> Iterator[Any]:
    """Ordered overlapped map: yields ``fn(item)`` in input order while up
    to ``depth`` items are in flight across ``encode_threads`` workers.

    A feeder thread pulls from ``items`` and submits tasks, blocking on a
    depth-bounded semaphore (backpressure). Results are consumed in
    submission order. A worker's exception re-raises in the consumer as
    its original type when its item's turn comes; an exception of the
    iterator itself re-raises likewise.
    """
    depth = PIPELINE_DEPTH if depth is None else depth
    _validate_window(encode_threads, depth)
    q: "queue.Queue" = queue.Queue()
    slots = threading.BoundedSemaphore(depth)
    stop = threading.Event()
    pool = futures.ThreadPoolExecutor(max_workers=encode_threads,
                                      thread_name_prefix="pdp-encode")

    def feed():
        try:
            for item in items:
                while not slots.acquire(timeout=0.05):
                    if stop.is_set():
                        return
                if stop.is_set():
                    slots.release()
                    return
                q.put(("chunk", pool.submit(fn, item)))
            q.put(("end", None))
        except BaseException as e:  # noqa: BLE001 - a producer failure must surface in the consumer, not die on the feeder thread
            q.put(("producer_error", e))

    feeder = threading.Thread(target=feed, name="pdp-pipeline-feed",
                              daemon=True)
    feeder.start()
    try:
        while True:
            tag, payload = q.get()
            if tag == "end":
                return
            if tag == "producer_error":
                raise payload
            try:
                result = payload.result()
            finally:
                slots.release()
            yield result
    finally:
        stop.set()
        pool.shutdown(wait=False, cancel_futures=True)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def upload_rows(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                stream) -> None:
    """The host-to-device copies of one append: each pinned source into its
    buffer rows, on `stream`, without blocking the host."""
    with torch.cuda.stream(stream):
        for dst, src in zip(dsts, srcs):
            dst.copy_(src, non_blocking=True)


class _PinnedRing:
    """Pinned host buffers the chunk copies start from, used in turn. A
    buffer is refilled only after the copy that read it has finished (the
    CUDA event recorded after that copy)."""

    def __init__(self, n_slots: int = 2):
        self._slots = [{"bufs": None, "event": None} for _ in range(n_slots)]
        self._next = 0

    def stage(self, arrays: Sequence[np.ndarray]):
        """The arrays copied into the next slot's pinned buffers: (pinned
        views, slot); the caller records the copy's event into the slot."""
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot["event"] is not None:
            slot["event"].synchronize()
        n = len(arrays[0])
        bufs = slot["bufs"]
        srcs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if bufs is None or any(b.shape[0] < n or b.dtype != s.dtype or
                               b.shape[1:] != s.shape[1:]
                               for b, s in zip(bufs, srcs)):
            cap = _pow2_at_least(n)
            bufs = [torch.empty((cap,) + tuple(s.shape[1:]), dtype=s.dtype,
                                pin_memory=True) for s in srcs]
            slot["bufs"] = bufs
        views = [b[:n] for b in bufs]
        for view, src in zip(views, srcs):
            view.copy_(src)
        return views, slot

    def wait(self) -> None:
        for slot in self._slots:
            if slot["event"] is not None:
                slot["event"].synchronize()


class DeviceRowAccumulator:
    """Row columns appended chunk by chunk into device buffers.

    Two modes with equal results:

      * **donating** (the card's default): persistent (pid, pk, values)
        buffers of power-of-two row capacity. The first append allocates
        row_bucket(n) rows and C14 fills the tail past its rows with the
        pad values; an append that does not fit grows the buffers to the
        next power of two (C14 grow, the new tail at the pad values); the
        rows themselves are copied from pinned host memory on a side
        stream straight into their place, and the compute stream waits on
        that copy's event before any kernel reads the rows. Rows past the
        appended ones therefore always hold the pad values.
      * **staged** (the CPU's default): chunks stay separate tensors and
        ``finalize`` concatenates them once and pads.

    ``fills`` are the pad values of the three columns: executor.pad_rows'
    (pid 0, pk -1, values 0) on the host-encoded route; on the hash route
    the uint32 sentinel's bit pattern (-1 in int32 lanes), so a pad row
    never aliases a real key hash. ``finalize()`` returns buffers of
    ``executor.row_bucket(n_rows)`` rows, equal to ``executor.pad_rows``
    over the concatenated chunk rows.
    """

    def __init__(self, device, donate: Optional[bool] = None,
                 fills: tuple = (0, -1, 0), batch_rows: int = 0):
        self.device = torch.device(device)
        self.donating = (self.device.type == "cuda"
                         if donate is None else bool(donate))
        self.fills = tuple(fills)
        # batch_rows > 0: numpy chunks stage on the host until this many
        # rows accumulate, then land as one append (same final buffers).
        self.batch_rows = int(batch_rows)
        self._batch = []  # host-staged (pid, pk, values) chunk slices
        self._batch_n = 0
        self._n = 0  # real rows appended
        self._bufs = None  # donating mode: [pid, pk, values]
        self._staged = []  # staged mode: [pid, pk, values] tensors
        self._ring = None  # pinned staging of the card's copies
        self._side = None  # the copies' stream

    @property
    def n_rows(self) -> int:
        return self._n + self._batch_n

    def append(self, pid, pk, values, n_real: int) -> None:
        """Appends one encoded chunk: host arrays whose first n_real rows are
        real (rows past them are ignored)."""
        if n_real == 0:
            return
        if self.batch_rows and isinstance(pid, np.ndarray):
            self._batch.append((pid[:n_real], pk[:n_real], values[:n_real]))
            self._batch_n += n_real
            if self._batch_n >= self.batch_rows:
                self._flush_batch()
            return
        self._flush_batch()
        self._append_now([pid[:n_real], pk[:n_real], values[:n_real]],
                         n_real)

    def _flush_batch(self) -> None:
        """Lands the host-staged batch as one append (no-op when empty)."""
        if not self._batch:
            return
        n = self._batch_n
        columns = [parts[0] if len(parts) == 1 else np.concatenate(parts)
                   for parts in zip(*self._batch)]
        self._batch = []
        self._batch_n = 0
        self._append_now(columns, n)

    def _append_now(self, columns, n: int) -> None:
        if not self.donating:
            self._staged.append([torch.as_tensor(np.array(c)).to(self.device)
                                 if isinstance(c, np.ndarray) else
                                 c.to(self.device) for c in columns])
            self._n += n
            return
        if self._bufs is None:
            from pipelinedp_tpu_torch import executor
            cap = executor.row_bucket(n)
            self._bufs = [
                torch.empty((cap,) + tuple(c.shape[1:]),
                            dtype=torch.from_numpy(np.asarray(c[:0])).dtype,
                            device=self.device) for c in columns]
            self._copy_rows(columns, 0, n)
            kernels.fill_tail(self._bufs, n, self.fills)
            self._n = n
            return
        need = self._n + n
        if need > self._bufs[0].shape[0]:
            self._bufs = kernels.grow_rows(self._bufs, _pow2_at_least(need),
                                           self.fills)
        self._copy_rows(columns, self._n, n)
        self._n = need

    def _copy_rows(self, columns, offset: int, n: int) -> None:
        """Host rows into buffer rows [offset, offset + n)."""
        dsts = [b[offset:offset + n] for b in self._bufs]
        if self.device.type != "cuda":
            for dst, c in zip(dsts, columns):
                dst.copy_(torch.as_tensor(np.asarray(c)))
            return
        if self._ring is None:
            self._ring = _PinnedRing()
            self._side = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        srcs, slot = self._ring.stage(columns)
        # The copy may land in memory the compute stream freed and
        # reallocated: it starts after the compute stream's work so far.
        self._side.wait_stream(compute)
        upload_rows(dsts, srcs, self._side)
        event = torch.cuda.Event()
        event.record(self._side)
        slot["event"] = event
        compute.wait_event(event)
        for b in self._bufs:
            b.record_stream(self._side)

    def finalize(self):
        """(pid, pk, values) device buffers of row_bucket(n_rows) rows, the
        arrays executor.pad_rows gives for the concatenated rows; None when
        nothing was appended."""
        self._flush_batch()
        if self._n == 0:
            return None
        from pipelinedp_tpu_torch import executor
        target = executor.row_bucket(self._n)
        if self.donating:
            if self._ring is not None:
                # The pinned buffers may go once their copies are done.
                self._ring.wait()
            # A small tail chunk's bucket can overshoot the total's bucket
            # by one step; the slice restores the pad_rows shape.
            return tuple(b[:target] for b in self._bufs)
        pad = target - self._n
        out = []
        for j, fill in enumerate(self.fills):
            parts = [cols[j] for cols in self._staged]
            if pad:
                parts.append(torch.full((pad,) + tuple(parts[0].shape[1:]),
                                        fill, dtype=parts[0].dtype,
                                        device=self.device))
            out.append(torch.cat(parts))
        return tuple(out)
