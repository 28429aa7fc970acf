"""Chunked, overlapped host -> device ingest.

Port of the single-process part of pipelinedp_tpu/ingest.py (numpy only:
the port's machine has no pandas, so every branch the JAX module takes
without pandas is the one copied here, but for the hash of object key
columns, which follows its pandas branch: see hash_key_column_pair). ``stream_encode_columns`` turns a
stream of ``(pid_raw, pk_raw, values)`` column chunks into an EncodedData
whose columns already lie on the device, padded to the executor.pad_rows
row bucket:

  * encode_mode="host": each chunk's keys are factorized on the encode
    pool (chunk_factorize), the global vocabulary is stitched in stream
    order on the consumer (ChunkedVocabEncoder.merge), and the code
    columns land in the device row buffers (runtime/pipeline.py). The
    codes are those of one columnar.factorize over the concatenation.
  * encode_mode="hash_device": workers only hash keys to two 64-bit
    lanes; the raw hash rows land in the buffers, and the codes are
    assigned on the device (device_encode.py: C12 factorize on the card,
    C13 lookup on the CPU), the same codes as the host route.

Values are converted to the working float dtype on the host, before the
copy, and non-finite values are rejected or dropped per chunk.

The shard encoders of the JAX module (:982-1581) follow: encode_shard and
merge_shards (a host encodes its own shard, the coordinator merges the
vocabularies), and encode_local_shard_to_mesh, the pod ingest, in one
process: the rows land as ShardedColumns over a mesh (parallel/mesh.py),
each shard's rows on its device, in both encode modes (hash_device codes
from device_encode.mesh_factorize_codes, C24). An injected exchange=
simulates the other processes of a pod; the collective byte exchange over
torch.distributed is ROADMAP.md Queue 1 step 9.
"""

import dataclasses
import functools
from collections import Counter as collections_counter
import hashlib
import logging
import pickle
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import device_encode
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
from pipelinedp_tpu_torch.parallel.mesh import ShardedColumn
from pipelinedp_tpu_torch.runtime import pipeline as rt_pipeline
from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
from pipelinedp_tpu_torch.runtime import trace as rt_trace

_NAN_KEY = columnar._NAN_KEY
_dict_key = columnar._canonical_key


def _kind_group(dtype) -> str:
    """Coarse dtype family for the sorted-vocab compatibility check."""
    if dtype.kind in "biuf":
        return "num"
    if dtype.kind in "SU":
        return "str"
    return "obj"


def chunk_factorize(raw) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk-local factorization: (int32 codes, uniques in first-occurrence
    order). The order-independent half of ChunkedVocabEncoder.encode, pure
    and thread-safe, so the encode pool runs it per chunk while the
    consumer merges in stream order. columnar.factorize already yields
    first-occurrence order on every branch."""
    codes, uniques = columnar.factorize(columnar._as_key_array(raw))
    return codes.astype(np.int32), np.asarray(uniques)


class ChunkedVocabEncoder:
    """Incremental first-occurrence vocabulary encoding across chunks.

    Feeding chunks in order yields exactly the codes columnar.factorize
    assigns to the concatenation, including NaN unification (all NaN keys
    share one code, kept out of the sorted vocabulary where comparisons
    would misplace it) and cross-chunk dtype promotion (a later chunk with
    a wider string or finer numeric dtype widens the stored vocabulary).
    Per chunk: a vectorized remap of the chunk's uniques against a sorted
    copy of the vocabulary (searchsorted + insert). Key types numpy cannot
    order fall back to a per-unique dict loop.
    """

    def __init__(self):
        self._sorted_vocab = None  # sorted non-NaN uniques
        self._sorted_codes = None  # global code of each sorted entry
        self._nan_code: Optional[int] = None  # shared code for NaN keys
        self._next_code = 0  # total codes assigned on the sorted path
        self._dict: Optional[dict] = None  # unorderable-key last resort

    def encode(self, raw) -> np.ndarray:
        return self.merge(*chunk_factorize(raw))

    def merge(self, codes: np.ndarray, uniques: np.ndarray) -> np.ndarray:
        """Remaps one chunk's local codes (uniques in first-occurrence
        order, from chunk_factorize) into the global vocabulary."""
        if self._dict is not None:
            return self._remap_dict(codes, uniques)
        try:
            return self._remap_sorted(codes, uniques)
        except TypeError:  # unorderable mixed-type keys
            self._spill_to_dict()
            return self._remap_dict(codes, uniques)

    def _remap_sorted(self, codes: np.ndarray,
                      uniques: np.ndarray) -> np.ndarray:
        n_u = len(uniques)
        if self._sorted_vocab is None:
            self._sorted_vocab = np.empty(0, uniques.dtype)
            self._sorted_codes = np.empty(0, np.int64)
        elif len(self._sorted_vocab):
            # Mixed number/string chunks spill to the dict path (where 1.5
            # and '1.5' stay distinct keys): numpy would otherwise
            # stringify numbers through dtype promotion.
            a = _kind_group(self._sorted_vocab.dtype)
            b = _kind_group(uniques.dtype)
            if "obj" not in (a, b) and a != b:
                raise TypeError(
                    f"cannot mix {a} and {b} keys in the sorted vocab")
        # NaN never matches itself under searchsorted / ==: NaN keys keep
        # one dedicated code outside the sorted array.
        if uniques.dtype.kind == "f":
            is_nan = np.isnan(uniques)
        elif uniques.dtype.kind == "O" and n_u:
            is_nan = np.fromiter(
                (_dict_key(k) is _NAN_KEY for k in uniques), bool, count=n_u)
        else:
            is_nan = np.zeros(n_u, bool)
        nan_idx = np.nonzero(is_nan)[0]
        remap = np.empty(n_u, np.int64)
        known = np.zeros(n_u, bool)
        if len(nan_idx) and self._nan_code is not None:
            known[nan_idx] = True
            remap[nan_idx] = self._nan_code
        reg_idx = np.nonzero(~is_nan)[0]
        u = uniques[reg_idx]
        n_vocab = len(self._sorted_vocab)
        if n_vocab and len(u):
            pos = columnar.searchsorted_queries(self._sorted_vocab,
                                                u)  # may TypeError
            pos_c = np.minimum(pos, n_vocab - 1)
            found = (pos < n_vocab) & (self._sorted_vocab[pos_c] == u)
            known[reg_idx[found]] = True
            remap[reg_idx[found]] = self._sorted_codes[pos_c[found]]
        # New codes in the chunk's first-occurrence order: the order one
        # global factorize would meet them.
        assign_new = ~known
        nan_is_new = bool(len(nan_idx)) and self._nan_code is None
        if nan_is_new:
            assign_new[nan_idx[1:]] = False
        new_idx = np.nonzero(assign_new)[0]
        remap[new_idx] = self._next_code + np.arange(len(new_idx))
        new_nan_code = None
        if nan_is_new:
            new_nan_code = int(remap[nan_idx[0]])
            remap[nan_idx] = new_nan_code
        new_reg = new_idx[~is_nan[new_idx]]
        if len(new_reg):
            new_u, new_c = uniques[new_reg], remap[new_reg]
            # Widen first: np.insert would cast new keys to the stored
            # dtype (truncating '<U5' into a '<U2' vocab).
            dt = np.promote_types(self._sorted_vocab.dtype,
                                  new_u.dtype)  # may TypeError
            if dt != new_u.dtype:
                new_u = new_u.astype(dt)
            no = np.argsort(new_u, kind="stable")  # may TypeError
            new_u, new_c = new_u[no], new_c[no]
            vocab = self._sorted_vocab
            if dt != vocab.dtype:
                vocab = vocab.astype(dt)
            ins = np.searchsorted(vocab, new_u)  # may TypeError
            # Every TypeError-prone step is done: commit (a raise above
            # leaves the encoder as it was for the dict spill).
            self._sorted_vocab = np.insert(vocab, ins, new_u)
            self._sorted_codes = np.insert(self._sorted_codes, ins, new_c)
        self._next_code += len(new_idx)
        if nan_is_new:
            self._nan_code = new_nan_code
        return remap[codes].astype(np.int32)

    def _spill_to_dict(self) -> None:
        """Moves the sorted-vocab state into the dict fallback when a chunk
        brings keys numpy cannot order."""
        self._dict = {}
        if self._sorted_vocab is not None:
            for key, code in zip(self._sorted_vocab, self._sorted_codes):
                self._dict[key] = int(code)
            if self._nan_code is not None:
                self._dict[_NAN_KEY] = self._nan_code
            self._sorted_vocab = self._sorted_codes = None

    def _remap_dict(self, codes: np.ndarray,
                    uniques: np.ndarray) -> np.ndarray:
        remap = np.empty(len(uniques), np.int64)
        for j, key in enumerate(uniques):
            remap[j] = self._dict.setdefault(_dict_key(key), len(self._dict))
        return remap[codes].astype(np.int32)

    @property
    def vocabulary(self) -> Sequence[Any]:
        if self._sorted_vocab is not None:
            dt = self._sorted_vocab.dtype
            if self._nan_code is not None:
                if dt.kind in "biu":
                    dt = np.promote_types(dt, np.float64)
                elif dt.kind != "f":
                    # A string vocab cannot hold a float NaN (promotion
                    # would store the string 'nan').
                    dt = np.dtype(object)
            out = np.empty(self._next_code, dtype=dt)
            out[self._sorted_codes] = self._sorted_vocab
            if self._nan_code is not None:
                out[self._nan_code] = np.nan
            return out
        if self._dict:
            vocab = np.empty(len(self._dict), dtype=object)
            for key, code in self._dict.items():
                vocab[code] = np.nan if key is _NAN_KEY else key
            return vocab
        return np.empty(0, dtype=object)

    def __len__(self) -> int:
        if self._sorted_vocab is not None:
            return self._next_code
        return len(self._dict or ())


@dataclasses.dataclass
class _PreparedChunk:
    """One chunk's encode-pool output: chunk-local codes and uniques
    (first-occurrence order) awaiting the sequential merge, and the rows a
    non-finite value drops."""
    pid_codes: np.ndarray
    pid_uniques: np.ndarray
    pk_codes: np.ndarray  # final codes when publicly encoded
    pk_uniques: Optional[np.ndarray]  # None when publicly encoded
    values: np.ndarray
    dropped: Optional[np.ndarray]  # bool[n], or None: every row kept

    @property
    def n_rows(self) -> int:
        return len(self.pid_codes)


def _invalidate(bad, values, value_dtype):
    """Values of the rows `bad` marks (nonfinite="drop") zeroed."""
    mask = bad if values.ndim == 1 else bad[:, None]
    return np.where(mask, 0.0, values).astype(value_dtype)


def _prepare_chunk(chunk, partition_vocab, nonfinite,
                   value_dtype) -> _PreparedChunk:
    """Order-independent host encode of one chunk (on the encode pool):
    factorize the keys, validate the values. A dropped row keeps its
    chunk-local pk code until the merge has mapped it: the JAX package
    marks it -1 before its merge, which then reads code -1 as the chunk's
    last unique (ROADMAP.md Queue 3)."""
    pid_raw, pk_raw, values = chunk
    pid_codes, pid_uniques = chunk_factorize(pid_raw)
    if partition_vocab is not None:
        pk_codes = columnar.encode_with_vocab(
            columnar._as_key_array(pk_raw), partition_vocab)
        pk_uniques = None
    else:
        pk_codes, pk_uniques = chunk_factorize(pk_raw)
    values = np.asarray(values, dtype=value_dtype)
    bad = columnar.nonfinite_value_rows(values, nonfinite)
    if bad is not None:
        values = _invalidate(bad, values, value_dtype)
    return _PreparedChunk(pid_codes, pid_uniques, pk_codes, pk_uniques,
                          values, bad)


# --- Hash-keyed encode (the host half of encode_mode="hash_device") --------
#
# Chunk workers only hash raw keys to uint64 on two independent lanes (lane
# 1 exists so the collision detector can tell "same key twice" from "two
# keys, one hash"), record each chunk's unique pairs for the detector and
# the deferred decode table, and canonicalize keys so hash identity follows
# the host encoder's key equality (every NaN one key; 3 and 3.0 one key).

_HASH_PD_KEYS = ("pdp_tpu_hash_ln0", "pdp_tpu_hash_ln1")
_HASH_SENTINEL64 = np.uint64((1 << 64) - 1)


def _splitmix64(x: np.ndarray, lane: int) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 bit patterns: a
    bijection on 64 bits, so fixed-width numeric keys never collide.
    Lane-salted by an input xor."""
    x = x ^ np.uint64((0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F)[lane])
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _stable_hash_elements(raw: np.ndarray, lane: int) -> np.ndarray:
    """Per-element stable hash of keys no vectorized path handles (mixed or
    composite object keys): blake2b, deterministic across processes;
    numbers canonicalize through float64 so 3, 3.0 and True == 1 unify as
    dict keys do."""
    salt = _HASH_PD_KEYS[lane].encode()
    out = np.empty(len(raw), np.uint64)
    for i, key in enumerate(raw):
        canon = _dict_key(key)
        if canon is _NAN_KEY:
            payload = b"\x00nan"
        elif isinstance(canon, (bool, int, float, np.bool_, np.integer,
                                np.floating)) and \
                float(canon) == canon and abs(float(canon)) < 2.0**53:
            payload = b"\x01" + repr(float(canon)).encode()
        else:
            try:
                payload = pickle.dumps(canon, protocol=4)
            except Exception:  # noqa: BLE001 - an unpicklable key hashes by repr; it must not stop the ingest
                payload = repr(canon).encode()
        digest = hashlib.blake2b(payload, digest_size=8, key=salt).digest()
        out[i] = np.frombuffer(digest, np.uint64)[0]
    return out


def _canonical_numeric(raw: np.ndarray) -> np.ndarray:
    """Numeric keys canonicalized for hashing: float64 when every value is
    exact there (so int 3 and float 3.0 hash alike), int64 bit patterns
    otherwise; every NaN the one canonical NaN, -0.0 as +0.0."""
    if raw.dtype.kind in "biu":
        as_f = raw.astype(np.float64)
        if bool((np.abs(as_f) < 2.0**53).all()):
            return as_f + 0.0
        return raw.astype(np.int64).view(np.float64)
    x = raw.astype(np.float64)
    x = np.where(np.isnan(x), np.float64("nan"), x)
    return x + 0.0


_FNV_OFFSETS = (np.uint64(0xCBF29CE484222325),
                np.uint64(0x9AE16A3B2F90404F))
_FNV_PRIME = np.uint64(0x100000001B3)


def _vector_hash_fixed_width(
        raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Both hash lanes of a fixed-width 'U'/'S' key column in one pass over
    the character matrix: vectorized FNV-1a over the code units, finished
    with the splitmix64 bijection."""
    n = len(raw)
    raw = np.ascontiguousarray(raw)
    if raw.dtype.kind == "U":
        width = raw.dtype.itemsize // 4
        mat = raw.view(np.uint32).reshape(n, width) if width else None
    else:
        width = raw.dtype.itemsize
        mat = raw.view(np.uint8).reshape(n, width) if width else None
    h0 = np.full(n, _FNV_OFFSETS[0])
    h1 = np.full(n, _FNV_OFFSETS[1])
    if mat is not None:
        for j in range(mat.shape[1]):
            col = mat[:, j].astype(np.uint64)
            # Zero code units (the fixed-width padding) leave the hash
            # alone: a key hashes alike whatever width its array has. The
            # position salt keeps interior characters order-sensitive.
            live = col != 0
            step0 = (h0 ^ (col + np.uint64(0x9E3779B9 * (j + 1)))) * \
                _FNV_PRIME
            step1 = (h1 ^ (col + np.uint64(0xC2B2AE35 * (j + 2)))) * \
                _FNV_PRIME
            h0 = np.where(live, step0, h0)
            h1 = np.where(live, step1, h1)
    return _splitmix64(h0, 0), _splitmix64(h1, 1)


def _object_key_kind(raw: np.ndarray) -> str:
    """What pandas.api.types.infer_dtype(raw, skipna=False) says of an
    object key column, for the kinds the hash vectorizes ("string",
    "integer", "boolean", "floating", "mixed-integer-float"; "integer-na"
    and "mixed" otherwise)."""
    n_str = n_int = n_bool = n_float = n_nan = 0
    for key in raw:
        if isinstance(key, str):
            n_str += 1
        elif isinstance(key, (bool, np.bool_)):
            n_bool += 1
        elif isinstance(key, (int, np.integer)):
            n_int += 1
        elif isinstance(key, (float, np.floating)):
            n_float += 1
            n_nan += key != key
        else:
            return "mixed"
    n = len(raw)
    for count, kind in ((n_str, "string"), (n_int, "integer"),
                        (n_bool, "boolean"), (n_float, "floating")):
        if count == n:
            return kind
    if n_int + n_float == n:
        return "integer-na" if n_nan == n_float else "mixed-integer-float"
    return "mixed"


def hash_key_column_pair(raw) -> Tuple[np.ndarray, np.ndarray]:
    """Both deterministic uint64 hash lanes of a key column.

    Lane 0 is the identity the device factorize groups by; lane 1 an
    independent family that only feeds the collision detector. Stable
    across processes (splitmix64, vectorized FNV or blake2b, never
    Python's salted hash()), with the uint64 maximum remapped away so the
    device pad sentinel is unreachable from data. Numeric keys
    canonicalize through float64 and every NaN is one key.

    An object column of one key type (strings, integers, booleans,
    floats) hashes as the fixed-width column of that type, as the JAX
    package's pandas branch does: a key then hashes alike whether its
    chunk came as a list or as a numpy array. Its branch without pandas
    hashes such a column element by element, and so gives one key two
    hashes, and a privacy id two ids, across such chunks (ROADMAP.md Queue
    3). Other object columns hash element by element.
    """
    raw = columnar._as_key_array(raw)
    if len(raw) == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    kind = raw.dtype.kind
    if kind == "O":
        inferred = _object_key_kind(raw)
        if inferred == "string":
            raw, kind = raw.astype(np.str_), "U"
        elif inferred in ("integer", "boolean"):
            raw = raw.astype(np.int64 if inferred == "integer" else bool)
            kind = raw.dtype.kind
        elif inferred in ("floating", "mixed-integer-float"):
            raw, kind = raw.astype(np.float64), "f"
    if kind in "biuf":
        bits = _canonical_numeric(raw).view(np.uint64)
        pair = (_splitmix64(bits, 0), _splitmix64(bits, 1))
    elif kind in "SU":
        pair = _vector_hash_fixed_width(raw)
    else:
        pair = (_stable_hash_elements(raw, 0), _stable_hash_elements(raw, 1))
    top = _HASH_SENTINEL64 - np.uint64(1)
    return (np.where(pair[0] == _HASH_SENTINEL64, top, pair[0]),
            np.where(pair[1] == _HASH_SENTINEL64, top, pair[1]))


def hash_key_column(raw, lane: int = 0) -> np.ndarray:
    """One lane of hash_key_column_pair."""
    return hash_key_column_pair(raw)[lane]


def _hash_uniques(h1: np.ndarray, h2: np.ndarray, raw):
    """Chunk-local distinct (h1, h2) pairs, one representative raw key a
    pair (its first occurrence) and that occurrence's chunk position.

    One unstable sort by h1; a run's first occurrence is its smallest row.
    A run holding two h2 (a collision inside the chunk) takes the JAX
    package's (h1, h2) lexsort instead, so the merge sees every pair."""
    if len(h1) == 0:
        empty = np.empty(0, np.uint64)
        return empty, empty, (raw[:0] if raw is not None else None), \
            np.empty(0, np.int64)
    order = np.argsort(h1)
    s1 = h1[order]
    new = np.empty(len(s1), bool)
    new[0] = True
    np.not_equal(s1[1:], s1[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    s2 = h2[order]
    if not (np.minimum.reduceat(s2, starts) ==
            np.maximum.reduceat(s2, starts)).all():
        return _hash_uniques_lexsort(h1, h2, raw)
    first = np.minimum.reduceat(order, starts)
    return s1[starts], h2[first], (raw[first] if raw is not None else
                                   None), first.astype(np.int64)


def _hash_uniques_lexsort(h1: np.ndarray, h2: np.ndarray, raw):
    """_hash_uniques by the JAX package's (h1, h2) lexsort: every distinct
    pair, collisions included."""
    order = np.lexsort((h2, h1))
    s1, s2 = h1[order], h2[order]
    new = np.empty(len(s1), bool)
    new[0] = True
    new[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    # lexsort is stable: within a pair's run the row indices ascend.
    first = order[new]
    return s1[new], s2[new], (raw[first] if raw is not None else None), \
        first.astype(np.int64)


@dataclasses.dataclass
class _HashChunk:
    """One chunk's hash-encode output: (n, 3) uint32 hash rows [hash_hi,
    hash_lo, valid] for the accumulator, plus the chunk-local unique
    triples the consumer keeps for collision detection and decode."""
    pid_hash: np.ndarray  # (n, 3) uint32
    pid_u1: np.ndarray
    pid_u2: np.ndarray
    pid_pos: np.ndarray  # chunk-local first positions
    pk_col: np.ndarray  # (n, 3) uint32, or int32[n] when publicly encoded
    pk_u1: Optional[np.ndarray]
    pk_u2: Optional[np.ndarray]
    pk_keys: Optional[np.ndarray]
    pk_pos: Optional[np.ndarray]
    values: np.ndarray

    @property
    def n_rows(self) -> int:
        return len(self.pid_hash)


def _prepare_hash_chunk(chunk, partition_vocab, nonfinite,
                        value_dtype) -> _HashChunk:
    """Hash-mode chunk worker (no shared state): hash both key columns on
    two lanes, record the chunk's unique pairs, validate the values."""
    pid_raw, pk_raw, values = chunk
    pid_raw = columnar._as_key_array(pid_raw)
    pid_h1, pid_h2 = hash_key_column_pair(pid_raw)
    pid_u1, pid_u2, _, pid_pos = _hash_uniques(pid_h1, pid_h2, None)
    if partition_vocab is not None:
        pk_col = columnar.encode_with_vocab(
            columnar._as_key_array(pk_raw), partition_vocab)
        pk_u1 = pk_u2 = pk_keys = pk_pos = None
    else:
        pk_raw = columnar._as_key_array(pk_raw)
        pk_h1, pk_h2 = hash_key_column_pair(pk_raw)
        pk_u1, pk_u2, pk_keys, pk_pos = _hash_uniques(pk_h1, pk_h2, pk_raw)
    values = np.asarray(values, dtype=value_dtype)
    bad = columnar.nonfinite_value_rows(values, nonfinite)
    pk_valid = None
    if bad is not None:
        # The host route's invalid marks: the row leaves its partition
        # (pk code -1), but both key columns keep their real hashes, since
        # the host encoder factorizes the raw columns before rows are
        # invalidated (a key seen only on dropped rows keeps its slot).
        if partition_vocab is not None:
            pk_col = np.where(bad, np.int32(-1), pk_col).astype(np.int32)
        else:
            pk_valid = ~bad
        values = _invalidate(bad, values, value_dtype)
    if partition_vocab is None:
        pk_col = device_encode.pack_hash_rows(pk_h1, pk_valid)
    return _HashChunk(device_encode.pack_hash_rows(pid_h1), pid_u1, pid_u2,
                      pid_pos, pk_col, pk_u1, pk_u2, pk_keys, pk_pos, values)


def _int32_lanes(a: np.ndarray) -> np.ndarray:
    """uint32 hash rows as the int32 bit patterns the port's tensors hold
    (int32 columns pass through)."""
    return a.view(np.int32) if a.dtype == np.uint32 else a


def stream_encode_columns(
        chunks: Iterable[Tuple[Sequence[Any], Sequence[Any],
                               Sequence[float]]],
        public_partitions: Optional[Sequence[Any]] = None,
        nonfinite: str = "error",
        encode_threads: int = 0,
        pipeline_depth: Optional[int] = None,
        encode_mode: str = "host",
        device="cuda",
        dtype: torch.dtype = torch.float32) -> columnar.EncodedData:
    """Encodes (pid_raw, pk_raw, values) column chunks into device-resident
    columns, each chunk's copy overlapping the next chunk's encode.

    encode_threads=0 encodes the chunks in one loop; encode_threads >= 1
    runs the chunk encode on that many host threads through
    runtime/pipeline.map_overlapped (window ``pipeline_depth``, default
    PIPELINE_DEPTH), the sequential merge and the device appends on the
    consumer. Both give the same columns: pid / pk int32 and values in
    `dtype` on `device`, padded to executor.row_bucket(n) rows with
    executor.pad_rows' pad values, so the kernels see what the serial
    encode of the same rows gives them.

    Non-finite values are rejected per chunk (nonfinite="error") or dropped
    with a warning (nonfinite="drop", the rows marked invalid).

    encode_mode="hash_device" hashes keys on the host and assigns the
    codes on the device (device_encode.py); the partition vocabulary is
    then a HashVocab that decodes only the kept partitions. A detected
    64-bit hash collision falls back to encode_mode="host" for a
    re-iterable source, or raises HashCollisionError for a one-shot
    iterator.
    """
    if encode_mode not in ("host", "hash_device"):
        raise ValueError(f"encode_mode must be host|hash_device, "
                         f"got {encode_mode!r}")
    device = torch.device(device)
    value_dtype = _value_dtype(dtype)
    window = dict(encode_threads=encode_threads,
                  pipeline_depth=pipeline_depth)
    if encode_mode == "hash_device":
        return _stream_encode_hash_device(chunks, public_partitions,
                                          nonfinite, device, value_dtype,
                                          dtype, **window)
    partition_vocab = (list(dict.fromkeys(public_partitions))
                       if public_partitions is not None else None)
    pid_enc = ChunkedVocabEncoder()
    pk_enc = ChunkedVocabEncoder()
    acc = rt_pipeline.DeviceRowAccumulator(
        device, batch_rows=rt_pipeline.APPEND_BATCH_ROWS)
    worker = functools.partial(_prepare_chunk,
                               partition_vocab=partition_vocab,
                               nonfinite=nonfinite, value_dtype=value_dtype)
    for prep in _prepared(chunks, worker, **window):
        # The sequential merge in stream order: the serial encode's codes.
        pid = pid_enc.merge(prep.pid_codes, prep.pid_uniques)
        pk = (prep.pk_codes if partition_vocab is not None else
              pk_enc.merge(prep.pk_codes, prep.pk_uniques))
        if prep.dropped is not None:
            pk = np.where(prep.dropped, np.int32(-1), pk).astype(np.int32)
        acc.append(pid, pk, prep.values, len(pid))
    pid, pk, values = _finalized(acc, device, dtype)
    return columnar.EncodedData(
        pid=pid, pk=pk, values=values,
        partition_vocab=(partition_vocab if partition_vocab is not None else
                         pk_enc.vocabulary),
        n_privacy_ids=len(pid_enc),
        public_encoded=public_partitions is not None)


def _prepared(chunks, worker, encode_threads: int,
              pipeline_depth: Optional[int]):
    """The workers' outputs in stream order: the encode pool's
    (encode_threads >= 1) or one loop's."""
    if encode_threads:
        return rt_pipeline.map_overlapped(chunks, worker, encode_threads,
                                          pipeline_depth)
    return map(worker, chunks)


def _finalized(acc, device, dtype):
    """The accumulator's padded buffers, or the empty stream's columns."""
    bufs = acc.finalize()
    if bufs is None:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return empty, empty, torch.zeros(0, dtype=dtype, device=device)
    return bufs


def _stream_encode_hash_device(chunks, public_partitions, nonfinite, device,
                               value_dtype, dtype, encode_threads: int,
                               pipeline_depth: Optional[int]
                               ) -> columnar.EncodedData:
    """The encode_mode="hash_device" body of stream_encode_columns: workers
    hash, raw (n, 3) hash rows accumulate in the device buffers, the
    consumer keeps the per-chunk uniques without merging, and the codes
    come from one device pass per key column at the end. The collision
    check runs over the uniques before any device code is used."""
    public = public_partitions is not None
    partition_vocab = (list(dict.fromkeys(public_partitions))
                       if public else None)
    # Re-iterability decides the collision fallback before the stream is
    # consumed.
    reiterable = iter(chunks) is not chunks
    # The uint32 sentinel's bit pattern in the int32 lanes (the public pk
    # column holds codes: -1 is its pad too).
    acc = rt_pipeline.DeviceRowAccumulator(
        device, fills=(-1, -1, 0), batch_rows=rt_pipeline.APPEND_BATCH_ROWS)
    pid_u1, pid_u2, pid_pos = [], [], []
    pk_u1, pk_u2, pk_keys, pk_pos = [], [], [], []
    worker = functools.partial(_prepare_hash_chunk,
                               partition_vocab=partition_vocab,
                               nonfinite=nonfinite, value_dtype=value_dtype)
    n_rows = 0
    for prep in _prepared(chunks, worker, encode_threads, pipeline_depth):
        pid_u1.append(prep.pid_u1)
        pid_u2.append(prep.pid_u2)
        # Chunk positions -> stream positions (chunks arrive in order).
        pid_pos.append(prep.pid_pos + n_rows)
        if not public:
            pk_u1.append(prep.pk_u1)
            pk_u2.append(prep.pk_u2)
            pk_keys.append(prep.pk_keys)
            pk_pos.append(prep.pk_pos + n_rows)
        n_rows += prep.n_rows
        acc.append(_int32_lanes(prep.pid_hash), _int32_lanes(prep.pk_col),
                   prep.values, prep.n_rows)
    try:
        pid_table = device_encode.merge_hash_uniques(
            pid_u1, pid_u2, None, pid_pos, what="privacy-id")
        pk_table = (None if public else device_encode.merge_hash_uniques(
            pk_u1, pk_u2, pk_keys, pk_pos, what="partition"))
    except device_encode.HashCollisionError as err:
        logging.warning(
            "hash-device encode detected a 64-bit key-hash collision (%s); "
            "%s", err,
            "falling back to the exact host encoder." if reiterable else
            "the chunk source is a one-shot iterator, so the exact-encoder "
            "fallback cannot re-read it.")
        if not reiterable:
            raise device_encode.HashCollisionError(
                f"{err} — and the chunk source is a one-shot iterator, so "
                f"the exact host-encoder fallback cannot re-read it. Pass a "
                f"re-iterable source (list / factory) or "
                f"encode_mode='host'.") from err
        return stream_encode_columns(
            chunks, public_partitions=public_partitions, nonfinite=nonfinite,
            encode_threads=encode_threads, pipeline_depth=pipeline_depth,
            encode_mode="host", device=device, dtype=dtype)
    bufs = acc.finalize()
    if bufs is None:
        return _hash_empty_encoded(public, device, dtype, partition_vocab)
    return _finalize_hash_codes(*bufs, public, partition_vocab, pid_table,
                                pk_table)


def _hash_empty_encoded(public: bool, device, dtype,
                        partition_vocab) -> columnar.EncodedData:
    """Empty-stream encoding of the hash route (as the host route's)."""
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    if public:
        vocab = partition_vocab
    else:
        nohash = np.empty(0, np.uint64)
        vocab = device_encode.HashVocab(0, nohash, np.empty(0, object),
                                        hash_by_code_host=nohash)
    return columnar.EncodedData(pid=empty, pk=empty,
                                values=torch.zeros(0, dtype=dtype,
                                                   device=device),
                                partition_vocab=vocab, n_privacy_ids=0,
                                public_encoded=public)


def _finalize_hash_codes(pid_hash, pk_col, values, public: bool,
                         partition_vocab, pid_table,
                         pk_table) -> columnar.EncodedData:
    """The device codes and the deferred-decode vocabulary of the hash
    route: C12 factorize on the card (its table sized by the host-merged
    distinct counts), C13 lookup against the host-merged tables on the CPU
    (device_encode.prefers_lookup_codes); the same codes either way. The
    device's distinct counts must equal the host merge's: a mismatch (or
    C12's -1, a table too small for the count it was given) raises, with
    no retry and no fallback."""
    device = pid_hash.device
    lookup = device_encode.prefers_lookup_codes(device)
    n_pid = pid_table[2]
    if lookup:
        pid_codes = kernels.lookup_codes(
            pid_hash, *device_encode.build_lookup_table(
                pid_table[0], pid_table[3], device))
        counts = [n_pid]
    else:
        pid_codes, n_pid_dev = kernels.factorize_codes(pid_hash,
                                                       n_distinct=n_pid)
        counts = [n_pid_dev]
    if public:
        vocab = partition_vocab
        pk = pk_col
    else:
        s1, keys, n_pk, pos = pk_table
        if lookup:
            pk = kernels.lookup_codes(
                pk_col, *device_encode.build_lookup_table(s1, pos, device))
        else:
            pk, n_pk_dev = kernels.factorize_codes(pk_col, n_distinct=n_pk)
            counts.append(n_pk_dev)
        # The code order (global first occurrence) follows from the chunk
        # uniques' positions: decoding copies nothing from the device.
        vocab = device_encode.HashVocab(
            n_pk, s1, keys, hash_by_code_host=s1[np.argsort(pos,
                                                            kind="stable")])
    if not lookup:
        # One copy of the device counts.
        counts = torch.stack(counts).cpu().tolist()
        host = [("privacy-id", n_pid)] + ([] if public else
                                          [("partition", n_pk)])
        for (what, host_n), dev_n in zip(host, counts):
            if dev_n == -1:
                raise RuntimeError(
                    f"device factorize of the {what} hashes overflowed its "
                    f"table, sized for the {host_n} distinct hashes of the "
                    f"host unique merge (internal invariant)")
            if dev_n != host_n:
                raise RuntimeError(
                    f"device factorize found {dev_n} distinct {what} hashes "
                    f"but the host unique merge found {host_n} (internal "
                    f"invariant)")
    # Pad rows code to -1; the pad_rows convention is pid 0.
    return columnar.EncodedData(pid=pid_codes.clamp(min=0), pk=pk,
                                values=values, partition_vocab=vocab,
                                n_privacy_ids=int(counts[0]),
                                public_encoded=public)


# --- Shard encode and merge ------------------------------------------------
#
# Each host parses and vocab-encodes its contiguous shard of the input on
# its own (encode_shard: numpy, no device), the per-host vocabularies are
# merged with one pass of the same incremental encoder
# (merge_host_vocabularies: the returned codes are each host's local ->
# global remap), and each host remaps and uploads only its own rows. With
# hosts owning contiguous shards in stream order, the merged codes are
# those of one factorize of the whole stream.


def _value_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@dataclasses.dataclass
class ShardEncoding:
    """One host's locally encoded shard: int32 code columns and the local
    vocabularies they index (numpy only, so it pickles)."""
    pid: np.ndarray
    pk: np.ndarray
    values: np.ndarray
    pid_vocab: np.ndarray
    pk_vocab: Optional[np.ndarray]  # None when pk was publicly encoded


def encode_shard(
        chunks: Iterable[Tuple[Sequence[Any], Sequence[Any],
                               Sequence[float]]],
        public_partitions: Optional[Sequence[Any]] = None,
        nonfinite: str = "error") -> ShardEncoding:
    """Host-local chunked encoding of one input shard (no device work), the
    JAX package's encode_shard: the parse and factorize of
    stream_encode_columns, with the same per-chunk non-finite policy.
    Values stay float64."""
    pid_enc = ChunkedVocabEncoder()
    pk_enc = ChunkedVocabEncoder()
    partition_vocab = None
    if public_partitions is not None:
        partition_vocab = list(dict.fromkeys(public_partitions))
    pids, pks, vals = [], [], []
    for pid_raw, pk_raw, values in chunks:
        pids.append(pid_enc.encode(pid_raw))
        if partition_vocab is not None:
            pks.append(
                columnar.encode_with_vocab(columnar._as_key_array(pk_raw),
                                           partition_vocab))
        else:
            pks.append(pk_enc.encode(pk_raw))
        values = np.asarray(values, dtype=np.float64)
        bad = columnar.nonfinite_value_rows(values, nonfinite)
        if bad is not None:
            pks[-1] = np.where(bad, np.int32(-1), pks[-1]).astype(np.int32)
            values = _invalidate(bad, values, np.float64)
        vals.append(values)
    empty = np.zeros(0, np.int32)
    return ShardEncoding(
        pid=np.concatenate(pids) if pids else empty,
        pk=np.concatenate(pks) if pks else empty,
        values=(np.concatenate(vals) if vals else np.zeros(0)),
        pid_vocab=np.asarray(pid_enc.vocabulary),
        pk_vocab=(None if partition_vocab is not None else np.asarray(
            pk_enc.vocabulary)))


def merge_host_vocabularies(
        vocabs: Sequence[Sequence[Any]]) -> Tuple[np.ndarray,
                                                  List[np.ndarray]]:
    """Per-host vocabularies merged into one global first-occurrence
    vocabulary (host order = stream order): host h's vocabulary fed as one
    chunk of the incremental encoder returns the global code of each of
    its local codes, the remap global_code = remap[local_code]. Returns
    (global_vocabulary, [remap int32 per host])."""
    enc = ChunkedVocabEncoder()
    remaps = []
    for vocab in vocabs:
        vocab = columnar._as_key_array(vocab)
        remaps.append(
            enc.encode(vocab) if len(vocab) else np.zeros(0, np.int32))
    return np.asarray(enc.vocabulary), remaps


def _remap_pk(remap: np.ndarray, pk: np.ndarray) -> np.ndarray:
    """Local partition codes to global ones; a dropped row's -1 stays -1.
    The JAX package indexes remap[pk] directly, which reads -1 as the
    shard's last unique and puts a dropped row back in that partition
    (ROADMAP.md Queue 3; its hash mode and the serial encode keep it
    out)."""
    if not len(pk):
        return pk
    return np.where(pk >= 0, remap[np.maximum(pk, 0)], -1).astype(np.int32)


def _check_shard_publicity(shards, public: bool) -> None:
    for s in shards:
        if public and s.pk_vocab is not None:
            raise ValueError(
                "shard was encoded without public partitions but "
                "merge_shards was called with them — the shard's pk codes "
                "index its private vocabulary, not the public one")
        if not public and s.pk_vocab is None:
            raise ValueError(
                "shard was encoded with public partitions but merge_shards "
                "was called without them")


def merge_shards(shards: Sequence[ShardEncoding],
                 public_partitions: Optional[Sequence[Any]] = None, *,
                 device, dtype: torch.dtype = torch.float32
                 ) -> columnar.EncodedData:
    """Coordinator step: per-host shard encodings merged into one
    EncodedData on `device` (the caller's: there is no default), values in
    `dtype`. Each shard's rows are remapped with its O(local uniques)
    remap vector and copied shard by shard (the JAX package's
    merge_shards)."""
    device = torch.device(device)
    public = public_partitions is not None
    _check_shard_publicity(shards, public)
    pid_vocab, pid_remaps = merge_host_vocabularies(
        [s.pid_vocab for s in shards])
    if public:
        partition_vocab = list(dict.fromkeys(public_partitions))
        pk_remaps = None
    else:
        partition_vocab, pk_remaps = merge_host_vocabularies(
            [s.pk_vocab for s in shards])
    value_dtype = _value_dtype(dtype)
    dev_pid, dev_pk, dev_vals = [], [], []
    for h, s in enumerate(shards):
        dev_pid.append(torch.from_numpy(
            pid_remaps[h][s.pid].astype(np.int32)).to(device))
        pk = s.pk if public else _remap_pk(pk_remaps[h], s.pk)
        dev_pk.append(torch.from_numpy(
            np.asarray(pk, np.int32)).to(device))
        dev_vals.append(torch.from_numpy(
            np.asarray(s.values, value_dtype)).to(device))
    if not dev_pid:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        dev_pid, dev_pk = [empty], [empty]
        dev_vals = [torch.zeros(0, dtype=dtype, device=device)]
    return columnar.EncodedData(
        pid=torch.cat(dev_pid), pk=torch.cat(dev_pk),
        values=torch.cat(dev_vals), partition_vocab=partition_vocab,
        n_privacy_ids=len(pid_vocab), public_encoded=public)


# --- The pod ingest ----------------------------------------------------------
#
# Each pod process runs encode_shard over its own chunks, the per-process
# vocabularies (O(uniques)) are exchanged once, every process derives the
# same global vocabulary and remaps (merge_host_vocabularies is
# deterministic in process order), and each process uploads only its
# remapped shard to its devices of the mesh. The port drives one process
# (process_count() == 1): the exchange is the identity, or an injected
# exchange= that simulates a pod.


@dataclasses.dataclass
class _ShardMeta:
    """What the vocabulary exchange moves: local vocabularies (numpy,
    picklable) and the process's row count."""
    n_rows: int
    pid_vocab: np.ndarray
    pk_vocab: Optional[np.ndarray]


def merge_shard_metas(metas: Sequence[_ShardMeta], public: bool
                      ) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]],
                                 np.ndarray, Sequence[Any]]:
    """The global merge every process runs alike: (pid remaps, pk remaps or
    None, global pid vocabulary, partition vocabulary)."""
    pid_vocab, pid_remaps = merge_host_vocabularies(
        [m.pid_vocab for m in metas])
    if public:
        return pid_remaps, None, pid_vocab, []
    pk_vocab, pk_remaps = merge_host_vocabularies(
        [m.pk_vocab for m in metas])
    return pid_remaps, pk_remaps, pid_vocab, pk_vocab


def _padded_local_rows(shard: ShardEncoding, pid_remap: np.ndarray,
                       pk_remap: Optional[np.ndarray], cap: int,
                       value_dtype) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """One process's remapped rows padded to its device capacity with the
    invalid marks (pid 0, pk -1: EncodedData.valid False). A row dropped
    for a non-finite value keeps pk -1 through the remap (_remap_pk)."""
    pid = (pid_remap[shard.pid] if len(shard.pid) else
           shard.pid).astype(np.int32)
    pk = shard.pk if pk_remap is None else _remap_pk(pk_remap, shard.pk)
    pk = np.asarray(pk, np.int32)
    values = np.asarray(shard.values, dtype=value_dtype)
    pad = cap - len(pid)
    if pad:
        pid = np.concatenate([pid, np.zeros(pad, np.int32)])
        pk = np.concatenate([pk, np.full(pad, -1, np.int32)])
        values = np.concatenate(
            [values, np.zeros((pad,) + values.shape[1:], values.dtype)])
    return pid, pk, values


def _pod_row_capacity(n_rows_by_process, mesh) -> Tuple[int, bool]:
    """One per-device row capacity every pod process derives alike from the
    exchanged row counts and the mesh: the largest per-device row load,
    capacity-rounded. Returns (per_device_capacity, simulated); simulated
    marks an injected exchange's pod inside one process, where the
    simulated processes split the devices evenly."""
    n_dev = mesh.size
    devs_of = collections_counter(
        mesh_lib.device_process(d) for d in mesh.devices)
    simulated = (mesh_lib.process_count() == 1 and
                 len(n_rows_by_process) > 1)
    per_dev = 1
    for p, n_rows in enumerate(n_rows_by_process):
        if simulated:
            n_p = max(n_dev // len(n_rows_by_process), 1)
        else:
            n_p = devs_of.get(p, 0)
        if n_rows and not n_p:
            raise ValueError(
                f"process {p} encoded {n_rows} rows but owns no device of "
                f"the mesh — every ingesting process must hold a mesh "
                f"slice to upload to")
        if n_p:
            per_dev = max(per_dev, -(-n_rows // n_p))
    return mesh_lib.round_capacity(per_dev), simulated


def _exchanged_metas(meta, exchange, encode_mode: str):
    """The exchange's metas in process order, this process's among them."""
    if exchange is None:
        if mesh_lib.process_count() != 1:
            raise NotImplementedError(
                "encode_local_shard_to_mesh: the collective byte exchange "
                "of a multi-process pod (torch.distributed) is not ported; "
                "one process runs the pod ingest, or an injected exchange= "
                "simulates the others")
        exchange = lambda payload: [payload]  # noqa: E731 - one process
    with rt_trace.span("ingest.vocab_exchange", encode=encode_mode) as sp:
        payload = pickle.dumps(meta)
        sp.set(bytes=len(payload))
        metas = [pickle.loads(p) for p in exchange(payload)]
    my_p = mesh_lib.process_index()
    if not 0 <= my_p < len(metas):
        raise ValueError(
            f"vocabulary exchange returned {len(metas)} shard metas but "
            f"this is process {my_p} — every pod process must participate "
            f"exactly once")
    return metas, exchange


def _to_mesh(col: np.ndarray, mesh, cap: int,
             dtype: Optional[torch.dtype] = None) -> ShardedColumn:
    """This process's padded rows (mesh.size * cap) as a ShardedColumn:
    shard s's cap rows copied to mesh.devices[s]."""
    t = torch.from_numpy(np.ascontiguousarray(col))
    return ShardedColumn([t[s * cap:(s + 1) * cap].to(device=dev, dtype=dtype)
                          for s, dev in enumerate(mesh.devices)], mesh)


def encode_local_shard_to_mesh(
        chunks: Iterable[Tuple[Sequence[Any], Sequence[Any],
                               Sequence[float]]],
        mesh,
        public_partitions: Optional[Sequence[Any]] = None,
        nonfinite: str = "error",
        exchange=None,
        encode_mode: str = "host",
        dtype: torch.dtype = torch.float32) -> columnar.EncodedData:
    """Pod-scale ingest: this process encodes only its own input shard (the
    JAX package's encode_local_shard_to_mesh).

    encode_shard runs over `chunks`; the per-process vocabularies and row
    counts are exchanged (`exchange(payload_bytes) -> [payload_bytes per
    process]`; default the identity of one process, injectable to simulate
    a pod), merged into the global vocabulary every process derives alike,
    and the local rows are remapped, padded to one per-device capacity
    (pk -1: invalid) and copied to the mesh: the EncodedData's columns are
    ShardedColumns, shard s's rows on mesh.devices[s], values in `dtype`.
    Process order is stream order, so the codes equal a serial
    stream_encode_columns over the whole stream.

    encode_mode="hash_device" only hashes the shard: the exchange carries
    O(uniques) collision and decode metadata, and the codes come from the
    mesh factorize on the devices (device_encode.mesh_factorize_codes).
    """
    if encode_mode not in ("host", "hash_device"):
        raise ValueError(f"encode_mode must be host|hash_device, "
                         f"got {encode_mode!r}")
    if encode_mode == "hash_device":
        return _encode_local_shard_hash(chunks, mesh, public_partitions,
                                        nonfinite, exchange, dtype)
    public = public_partitions is not None
    with rt_trace.span("ingest.local_shard") as sp:
        shard = encode_shard(chunks, public_partitions, nonfinite)
        sp.set(rows=int(len(shard.pid)))
    meta = _ShardMeta(n_rows=int(len(shard.pid)),
                      pid_vocab=np.asarray(shard.pid_vocab),
                      pk_vocab=(None if shard.pk_vocab is None else
                                np.asarray(shard.pk_vocab)))
    metas, _ = _exchanged_metas(meta, exchange, "host")
    my_p = mesh_lib.process_index()
    pid_remaps, pk_remaps, pid_vocab, pk_vocab = merge_shard_metas(
        metas, public)
    partition_vocab = (list(dict.fromkeys(public_partitions)) if public
                       else pk_vocab)
    cap, _ = _pod_row_capacity([m.n_rows for m in metas], mesh)
    local_rows = cap * len(mesh_lib.local_devices(mesh))
    pid, pk, values = _padded_local_rows(
        shard, pid_remaps[my_p],
        None if pk_remaps is None else pk_remaps[my_p], local_rows,
        _value_dtype(dtype))
    return columnar.EncodedData(
        pid=_to_mesh(pid, mesh, cap), pk=_to_mesh(pk, mesh, cap),
        values=_to_mesh(values, mesh, cap), partition_vocab=partition_vocab,
        n_privacy_ids=len(pid_vocab), public_encoded=public)


# --- The pod ingest in encode_mode="hash_device" ---------------------------


@dataclasses.dataclass
class _HashShardMeta:
    """What the hash-mode exchange moves: the row count and O(uniques) hash
    metadata (both key columns' collision lanes, the partition uniques'
    first positions and raw keys, from which every process derives the
    decode table). Codes come from the device factorize."""
    n_rows: int
    pid_u1: np.ndarray
    pid_u2: np.ndarray
    pk_u1: Optional[np.ndarray]
    pk_u2: Optional[np.ndarray]
    pk_keys: Optional[np.ndarray]
    pk_pos: Optional[np.ndarray]  # shard-local first positions


@dataclasses.dataclass
class _HashShardEncoding:
    """One process's hash-encoded shard: (n, 3) uint32 hash rows (or int32
    pk codes when publicly encoded), values and its exchange meta."""
    pid_hash: np.ndarray
    pk_col: np.ndarray
    values: np.ndarray
    meta: _HashShardMeta


def _hash_encode_shard(chunks, public_partitions, nonfinite: str,
                       value_dtype=np.float64) -> _HashShardEncoding:
    """Host-local hash encode of one input shard (no device work): chunk
    hashing, the chunk uniques with shard-local first positions, no merge
    (the JAX package's _hash_encode_shard)."""
    partition_vocab = None
    if public_partitions is not None:
        partition_vocab = list(dict.fromkeys(public_partitions))
    pid_cols, pk_cols, vals = [], [], []
    pid_u1, pid_u2 = [], []
    pk_u1, pk_u2, pk_keys, pk_pos = [], [], [], []
    offset = 0
    for chunk in chunks:
        prep = _prepare_hash_chunk(chunk, partition_vocab, nonfinite,
                                   value_dtype)
        pid_u1.append(prep.pid_u1)
        pid_u2.append(prep.pid_u2)
        if partition_vocab is None:
            pk_u1.append(prep.pk_u1)
            pk_u2.append(prep.pk_u2)
            pk_keys.append(prep.pk_keys)
            pk_pos.append(prep.pk_pos + offset)
        pid_cols.append(prep.pid_hash)
        pk_cols.append(prep.pk_col)
        vals.append(prep.values)
        offset += prep.n_rows
    public = partition_vocab is not None
    empty_hash = np.empty((0, 3), np.uint32)
    pid_hash = np.concatenate(pid_cols) if pid_cols else empty_hash
    if pk_cols:
        pk_col = np.concatenate(pk_cols)
    else:
        pk_col = np.empty(0, np.int32) if public else empty_hash
    values = np.concatenate(vals) if vals else np.zeros(0, value_dtype)
    meta = _HashShardMeta(
        n_rows=int(len(pid_hash)),
        pid_u1=_concat_u64(pid_u1), pid_u2=_concat_u64(pid_u2),
        pk_u1=None if public else _concat_u64(pk_u1),
        pk_u2=None if public else _concat_u64(pk_u2),
        pk_keys=None if public else (np.concatenate(pk_keys)
                                     if pk_keys else np.empty(0, object)),
        pk_pos=None if public else (np.concatenate(pk_pos)
                                    if pk_pos else np.empty(0, np.int64)))
    return _HashShardEncoding(pid_hash, pk_col, values, meta)


def _concat_u64(arrays) -> np.ndarray:
    arrays = [a for a in arrays if len(a)]
    return np.concatenate(arrays) if arrays else np.empty(0, np.uint64)


def _pad_rows_to(col: np.ndarray, cap: int, fill, dtype) -> np.ndarray:
    out = np.full((cap,) + col.shape[1:], fill, dtype)
    out[:len(col)] = col
    return out


def _encode_local_shard_hash(chunks, mesh, public_partitions, nonfinite,
                             exchange, dtype) -> columnar.EncodedData:
    """The encode_mode="hash_device" body of encode_local_shard_to_mesh (the
    JAX package's _encode_local_shard_hash): this process only hashes its
    shard, the exchange moves O(uniques) collision and decode metadata,
    the padded hash rows go to the mesh and the codes come from the mesh
    factorize (C24). A detected collision, derived alike by every process
    from the same metas, falls back to the host encoder for a re-iterable
    source and raises for a one-shot iterator."""
    public = public_partitions is not None
    reiterable = iter(chunks) is not chunks
    value_dtype = _value_dtype(dtype)
    with rt_trace.span("ingest.local_shard", encode="hash_device") as sp:
        shard = _hash_encode_shard(chunks, public_partitions, nonfinite,
                                   value_dtype)
        sp.set(rows=shard.meta.n_rows)
        rt_telemetry.record("pipeline_device_encode_chunks")
    metas, exchange = _exchanged_metas(shard.meta, exchange, "hash_device")
    # The collision gate: the same on every process (same metas), so the
    # fallback decision cannot diverge across the pod.
    try:
        _, _, n_pid_global, _ = device_encode.merge_hash_uniques(
            [m.pid_u1 for m in metas], [m.pid_u2 for m in metas],
            what="privacy-id")
        pk_table = None
        if not public:
            # Shard-local first positions become global by each process's
            # stream offset.
            offsets = np.cumsum([0] + [m.n_rows for m in metas[:-1]])
            pk_table = device_encode.merge_hash_uniques(
                [m.pk_u1 for m in metas], [m.pk_u2 for m in metas],
                [m.pk_keys for m in metas],
                [m.pk_pos + off for m, off in zip(metas, offsets)],
                what="partition")
    except device_encode.HashCollisionError as err:
        rt_telemetry.record("ingest_hash_collisions")
        logging.warning(
            "hash-device pod ingest detected a 64-bit key-hash collision "
            "(%s); every process falls back to the exact host encoder "
            "together.", err)
        if not reiterable:
            raise device_encode.HashCollisionError(
                f"{err} — and the chunk source is a one-shot iterator, so "
                f"the exact host-encoder fallback cannot re-read it. Pass a "
                f"re-iterable source or encode_mode='host'.") from err
        return encode_local_shard_to_mesh(
            chunks, mesh, public_partitions=public_partitions,
            nonfinite=nonfinite, exchange=exchange, encode_mode="host",
            dtype=dtype)
    cap, simulated = _pod_row_capacity([m.n_rows for m in metas], mesh)
    local_rows = cap * len(mesh_lib.local_devices(mesh))
    sent32 = int(device_encode._U32_MAX)
    pid_local = _pad_rows_to(shard.pid_hash, local_rows, sent32, np.uint32)
    if public:
        pk_local = _pad_rows_to(shard.pk_col, local_rows, -1, np.int32)
    else:
        pk_local = _pad_rows_to(shard.pk_col, local_rows, sent32, np.uint32)
    values_local = _pad_rows_to(shard.values, local_rows, 0, value_dtype)
    # The host merges' distinct counts size the factorize's tables (with
    # a simulated exchange they count the whole pod: an upper bound).
    pid_codes, _ = device_encode.mesh_factorize_codes(
        mesh, _to_mesh(_int32_lanes(pid_local), mesh, cap),
        n_distinct=int(n_pid_global))
    if public:
        pk = _to_mesh(pk_local, mesh, cap)
        vocab = list(dict.fromkeys(public_partitions))
    else:
        pk, n_pk_dev = device_encode.mesh_factorize_codes(
            mesh, _to_mesh(_int32_lanes(pk_local), mesh, cap),
            n_distinct=int(pk_table[2]))
        if not simulated and n_pk_dev != pk_table[2]:
            raise RuntimeError(
                f"device mesh factorize found {n_pk_dev} distinct partition "
                f"hashes but the exchanged metas merge to {pk_table[2]} "
                f"(internal invariant)")
        # The code order (global first occurrence) follows from the
        # exchanged positions, so the decode table covers codes whose rows
        # live on other processes too.
        s1, keys, n_pk, pos = pk_table
        vocab = device_encode.HashVocab(
            n_pk, s1, keys, hash_by_code_host=s1[np.argsort(pos,
                                                            kind="stable")])
    return columnar.EncodedData(
        pid=pid_codes.map(lambda t: t.clamp(min=0)), pk=pk,
        values=_to_mesh(values_local, mesh, cap), partition_vocab=vocab,
        n_privacy_ids=int(n_pid_global), public_encoded=public)
