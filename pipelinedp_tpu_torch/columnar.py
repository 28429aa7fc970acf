"""Host-side columnar encoding: Python rows -> struct-of-arrays.

Port of pipelinedp_tpu/columnar.py. The kernels operate on columns:
    pid:    int32[n]  contiguous privacy-unit ids (vocab-encoded)
    pk:     int32[n]  partition ids in [0, n_partitions); -1 = dropped row
    values: float64[n] scalar contribution values

The host keeps the partition vocabulary (partition id <-> original key).
Callers that already hold raw columns use ``encode_columns`` and skip the
per-row extractor calls. Vocabulary codes follow first occurrence without
pandas (numpy only), so the same seed releases the same partitions here
and in the JAX package.
"""

import logging
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from pipelinedp_tpu_torch.data_extractors import DataExtractors


@dataclass
class EncodedData:
    """Columnar dataset + decode vocabularies.

    The columns are host arrays, or tensors on the device when the
    streamed ingest made them (ingest.stream_encode_columns: already padded
    to the executor's row bucket, values in the working dtype, `valid`
    computed where they lie)."""
    pid: np.ndarray  # int32[n]
    pk: np.ndarray  # int32[n], -1 marks rows in no (public) partition
    # float64[n] (or float64[n, d] for vector values); None when encoded
    # for partition selection, which never reads values.
    values: Optional[np.ndarray]
    # partition id -> original partition key (list or ndarray, or a
    # device_encode.HashVocab decoding only the kept ids)
    partition_vocab: Sequence[Any]
    n_privacy_ids: int
    # True when pk was encoded against a FIXED public-partition vocabulary
    # (rows elsewhere already dropped): such data must be aggregated WITH
    # those public partitions, never under private selection.
    public_encoded: bool = False

    @property
    def n_rows(self) -> int:
        return len(self.pid)

    @property
    def n_partitions(self) -> int:
        return len(self.partition_vocab)

    @property
    def valid(self) -> np.ndarray:
        return self.pk >= 0


def _as_key_array(x) -> np.ndarray:
    """1-D key array; composite keys (tuples) stay single object elements."""
    if isinstance(x, np.ndarray) and x.ndim == 1:
        return x
    x = list(x)
    arr = np.fromiter(x, dtype=object, count=len(x))
    return arr


_NAN_KEY = object()  # canonical dict key for NaN (NaN != NaN breaks lookup)


def _canonical_key(key):
    """NaN keys canonicalize to one sentinel: every float('nan') object is
    distinct under ==, so a raw dict would give each its own code."""
    try:
        if key != key:  # NaN is the only self-unequal value
            return _NAN_KEY
    except Exception:  # noqa: BLE001 - exotic user __ne__ may raise anything; treat as an ordinary (non-NaN) key
        pass
    return key


def _object_array_has_nan(raw: np.ndarray) -> bool:
    return any(_canonical_key(key) is _NAN_KEY for key in raw)


def factorize(raw: np.ndarray) -> Tuple[np.ndarray, Sequence[Any]]:
    """First-occurrence-order integer encoding of a key column.

    Returns (codes int32[n], vocabulary array). The codes equal those of
    the JAX package's pandas.factorize route (first occurrence order), so
    a seed keys the same partitions on a machine without pandas. None/NaN
    are ordinary keys, and all NaN keys share one code. Key types numpy
    cannot order fall back to a Python dict loop.
    """
    if raw.dtype.kind in "biuSU" or (raw.dtype.kind == "f" and
                                     not bool(np.isnan(raw).any())):
        return _factorize_sorted(raw)
    try:
        uniques, first, inverse = np.unique(raw, return_index=True,
                                            return_inverse=True)
        if raw.dtype.hasobject and _object_array_has_nan(uniques):
            # NaN comparisons scramble an object sort: equal keys can land
            # non-adjacent and get two codes.
            raise TypeError("NaN among object keys")
    except TypeError:  # unorderable mixed-type keys (or object NaN)
        return _factorize_dict(raw)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank[inverse.reshape(-1)].astype(np.int32), uniques[order]


def _factorize_sorted(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """factorize of a NaN-free fixed-width column by one unstable sort:
    each run of equal keys takes its smallest row as first occurrence (the
    value there is the unique), and the runs are ranked by it."""
    n = len(raw)
    if n == 0:
        return np.empty(0, np.int32), raw[:0]
    order = np.argsort(raw)
    s = raw[order]
    new = np.empty(n, bool)
    new[0] = True
    np.not_equal(s[1:], s[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    first = np.minimum.reduceat(order, starts)
    by_first = np.argsort(first)
    rank = np.empty(len(starts), np.int32)
    rank[by_first] = np.arange(len(starts), dtype=np.int32)
    codes = np.empty(n, np.int32)
    codes[order] = rank[np.cumsum(new) - 1]
    return codes, raw[first[by_first]]


def searchsorted_queries(sorted_keys: np.ndarray, queries: np.ndarray,
                         side: str = "left") -> np.ndarray:
    """np.searchsorted of queries in any order, searched in sorted order
    (several times faster than searching a shuffled array)."""
    order = np.argsort(queries)
    out = np.empty(len(queries), np.int64)
    out[order] = np.searchsorted(sorted_keys, queries[order], side=side)
    return out


def _factorize_dict(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    vocab: dict = {}
    first_keys = []
    codes = np.empty(len(raw), dtype=np.int32)
    for i, key in enumerate(raw):
        canon = _canonical_key(key)
        code = vocab.setdefault(canon, len(vocab))
        if code == len(first_keys):
            first_keys.append(key)  # original object, incl. real NaN
        codes[i] = code
    out = np.empty(len(first_keys), dtype=object)
    for j, key in enumerate(first_keys):
        out[j] = key  # per-element: composite keys stay one object
    return codes, out


def nonfinite_value_rows(values: np.ndarray,
                         policy: str = "error",
                         where: str = "values") -> Optional[np.ndarray]:
    """Validates the VALUE column against NaN/Inf at ingest.

    A NaN or Inf in the value column survives clipping (clip propagates
    non-finite inputs) and silently poisons every sum, mean and variance
    its partition releases — so non-finite values must be dealt with at
    the ingest boundary, explicitly:

      * policy="error" (default): raise ValueError naming the count.
      * policy="drop": return the offending row mask (the caller marks
        those rows invalid) and log one warning with the count.

    Returns None when every value is finite (or the dtype cannot hold a
    non-finite value); otherwise the bool row mask of offending rows.
    Vector-valued rows are offending when ANY coordinate is non-finite.
    """
    if policy not in ("error", "drop"):
        raise ValueError(f"nonfinite policy must be error|drop, "
                         f"got {policy!r}")
    values = np.asarray(values)
    if values.dtype.kind not in "fc":
        return None  # integer/bool values are always finite
    finite = np.isfinite(values)
    if values.ndim > 1:
        finite = finite.all(axis=tuple(range(1, values.ndim)))
    n_bad = int(finite.size - finite.sum())
    if n_bad == 0:
        return None
    if policy == "error":
        raise ValueError(
            f"{n_bad} non-finite entr{'y' if n_bad == 1 else 'ies'} "
            f"(NaN/Inf) in the {where} column: a non-finite value survives "
            f"clipping and silently poisons its partition's aggregates. "
            f"Fix the input, or pass nonfinite='drop' to drop those rows "
            f"with a warning.")
    logging.warning(
        "dropping %d row(s) with non-finite %s (nonfinite='drop'): "
        "NaN/Inf would survive clipping and poison the affected "
        "partitions' aggregates.", n_bad, where)
    return ~finite


def encode_with_vocab(raw: np.ndarray, vocab: Sequence[Any]) -> np.ndarray:
    """Integer-encodes a key column against a FIXED vocabulary; -1 = absent.

    A numeric or string column against a vocabulary of the same dtype kind
    takes one sort of the vocabulary and a binary search (the speed of the
    JAX package's pandas get_indexer); other keys, and a vocabulary holding
    NaN, a dict lookup with NaN keys unified."""
    codes = _encode_with_sorted_vocab(raw, vocab)
    if codes is not None:
        return codes
    lookup = {_canonical_key(key): i for i, key in enumerate(vocab)}
    return np.fromiter((lookup.get(_canonical_key(k), -1) for k in raw),
                       dtype=np.int32,
                       count=len(raw))


def _encode_with_sorted_vocab(raw: np.ndarray,
                              vocab: Sequence[Any]) -> Optional[np.ndarray]:
    """encode_with_vocab by searchsorted where numpy's equality is the dict
    lookup's (one dtype kind on both sides, no NaN in a float vocabulary);
    None elsewhere. A key the vocabulary holds twice takes its last index,
    as in the dict."""
    if not isinstance(raw, np.ndarray) or raw.ndim != 1 or not len(vocab):
        return None
    v = np.asarray(vocab)
    kind = raw.dtype.kind
    if v.ndim != 1 or v.dtype.kind != kind or kind not in "biufSU":
        return None
    if kind == "f" and bool(np.isnan(v).any()):
        return None
    order = np.argsort(v, kind="stable")
    sv = v[order]
    pos = searchsorted_queries(sv, raw, side="right") - 1
    at = np.maximum(pos, 0)
    return np.where((pos >= 0) & (sv[at] == raw), order[at],
                    -1).astype(np.int32)


def encode_columns(
        pid_raw: Sequence[Any],
        pk_raw: Sequence[Any],
        values: Optional[Sequence[float]],
        public_partitions: Optional[Sequence[Any]] = None,
        nonfinite: str = "error") -> EncodedData:
    """Vectorized encoding of raw key/value COLUMNS (no per-row Python).

    This is the bulk-ingest entry point: file readers hand over whole
    columns (numpy arrays of keys/values) and every vocabulary assignment
    runs as one hash-factorization pass. Non-finite VALUES are rejected
    here (nonfinite="error", the default) or dropped with a warning
    (nonfinite="drop") — see nonfinite_value_rows. values=None encodes
    keys only (partition selection).
    """
    pid_raw = _as_key_array(pid_raw)
    pk_raw = _as_key_array(pk_raw)
    pid, pid_vocab = factorize(pid_raw)
    if public_partitions is not None:
        partition_vocab = list(dict.fromkeys(public_partitions))
        pk = encode_with_vocab(pk_raw, partition_vocab)
    else:
        pk, partition_vocab = factorize(pk_raw)
    if values is not None:
        values = np.asarray(values, dtype=np.float64)
    bad = None if values is None else nonfinite_value_rows(values,
                                                           nonfinite)
    if bad is not None:
        # Dropped rows are marked invalid the same way rows outside the
        # public partitions are: pk = -1 (EncodedData.valid reads pk >= 0).
        pk = np.where(bad, np.int32(-1), pk).astype(np.int32)
        # Zero out the dropped rows' values too: invalid rows never reach
        # a reduction, but a NaN payload must not survive into any
        # downstream array arithmetic either.
        mask = bad if values.ndim == 1 else bad[:, None]
        values = np.where(mask, 0.0, values)
    return EncodedData(pid=pid,
                       pk=pk,
                       values=values,
                       partition_vocab=partition_vocab,
                       n_privacy_ids=len(pid_vocab),
                       public_encoded=public_partitions is not None)


def encode(col,
           data_extractors: DataExtractors,
           public_partitions: Optional[Sequence[Any]] = None,
           with_values: bool = True) -> EncodedData:
    """Extracts and integer-encodes (privacy_id, partition_key, value) rows.

    With public partitions, the partition vocabulary is fixed to them and
    rows in other partitions are marked invalid (pk = -1) — the columnar
    analogue of DPEngine._drop_partitions + _add_empty_public_partitions
    (empty public partitions exist as all-zero columns). with_values=False
    (partition selection) calls no value extractor and keeps no values.
    """
    if isinstance(col, EncodedData):
        # Pre-encoded input (encode_columns): extractors are not consulted;
        # with public partitions the caller must have encoded against that
        # same vocabulary.
        if (public_partitions is not None and
                list(dict.fromkeys(public_partitions)) != list(
                    col.partition_vocab)):
            raise ValueError(
                "Pre-encoded input must be encoded against the same public "
                "partitions passed to aggregate() (columnar."
                "encode_columns(..., public_partitions=...)).")
        if public_partitions is None and col.public_encoded:
            raise ValueError(
                "This input was encoded against a fixed public-partition "
                "vocabulary (rows elsewhere were already dropped); "
                "aggregating it under private partition selection would "
                "silently lose them. Pass the same public_partitions, or "
                "re-encode without them.")
        return col
    pid_extractor = data_extractors.privacy_id_extractor or (lambda row: 0)
    pk_extractor = data_extractors.partition_extractor
    value_extractor = data_extractors.value_extractor or (lambda row: 0.0)
    if not isinstance(col, (list, tuple, np.ndarray)):
        col = list(col)
    # Per-row extractor calls are the only remaining Python loop; all
    # vocabulary work is vectorized in encode_columns.
    pid_raw = [pid_extractor(row) for row in col]
    pk_raw = [pk_extractor(row) for row in col]
    values = ([value_extractor(row) for row in col] if with_values else
              None)
    return encode_columns(pid_raw, pk_raw, values, public_partitions)
