"""On-device hash factorization: the device half of hash-keyed ingest.

Port of the single-device part of pipelinedp_tpu/device_encode.py (its
factorize_codes and lookup_codes are kernels.py's C12 and C13). In
encode_mode="hash_device" the chunk workers only hash raw keys to two
64-bit lanes (ingest.hash_key_column_pair), the raw hash rows stream to
the device through the row accumulator, and the dense integer codes are
assigned there:

  * ``kernels.factorize_codes`` (C12) gives every row the first-occurrence
    rank of its hash without sorting: a hash table on the card keeps each
    distinct hash's first row (sized by the distinct count the host merge
    already holds), and a scan of those rows in row order ranks them.
    These are the codes the host encoder assigns to the concatenated
    stream, so the hash-encoded kernel inputs equal the host-encoded ones
    and release the same noise (absent 128-bit collisions, which the
    detector below catches);
  * ``kernels.lookup_codes`` (C13) gives the same codes by searching each
    row's hash in the table the host already merged from the chunks'
    uniques (build_lookup_table).

Hashes travel as (n, 3) int32 rows holding the bit patterns of the JAX
package's uint32 lanes [hash_hi, hash_lo, valid] (torch has no general
uint32 arithmetic); both hash lanes at 0xffffffff mark a pad row.

Decode is deferred: ``HashVocab`` holds the hash-sorted (hash -> raw key)
table assembled from the chunk workers' per-chunk uniques and looks keys up
only for the partitions the DP selection kept.

Collision safety: workers hash every key on two independent 64-bit lanes;
``merge_hash_uniques`` checks, over the uniques only, that no primary hash
maps to two secondary hashes. A detected collision raises
``HashCollisionError`` and the ingest falls back to the exact host encoder
when the chunk source can be read again.

The meshed form (the JAX module's unique-cap and mesh factorize,
:302-418; K23b) is ``mesh_factorize_codes``: row-sharded hash rows
(parallel/mesh.ShardedColumn) get the same first-occurrence codes, each
shard's uniques going to the gathering device once, O(uniques), never
rows (C12's hash table in place of any sort: kernels.mesh_local_uniques,
mesh_merge_ranks, C24's mesh_remap_rows). The single-process pod ingest
(ingest.encode_local_shard_to_mesh, encode_mode="hash_device") runs it;
its multi-process form is ROADMAP.md Queue 1 step 9.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import collectives
from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
from pipelinedp_tpu_torch.parallel.mesh import ShardedColumn, on_device

# Invalid/pad marker: both uint32 lanes at their maximum. The host hash
# remaps a real key hashing to uint64-max down by one, so the sentinel is
# unreachable from data (ingest.hash_key_column_pair).
_U32_MAX = np.uint32(0xFFFFFFFF)


class HashCollisionError(ValueError):
    """Two distinct raw keys collided on the primary 64-bit key hash.

    Raised by the hash-device ingest mode when its detector trips; the
    ingest catches it and falls back to the exact host encoder when the
    chunk source is re-iterable.
    """


def round_capacity(x: int, min_cap: int = 8) -> int:
    """Round up keeping 4 significant bits (at most 6.25% slack, 12.5% just
    above a power of two): the JAX package's capacity rounding
    (parallel/mesh.py:296), shared by the lookup table and the blocked
    route's pass-1 rows."""
    x = max(int(x), min_cap)
    step = 1 << max((x - 1).bit_length() - 4, 3)
    return -(-x // step) * step


def pack_hash_rows(h: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> np.ndarray:
    """uint64[n] -> (n, 3) uint32 rows [hash_hi, hash_lo, valid].

    The valid lane keeps the two invalidity notions apart: a pad/sentinel
    row never enters the vocabulary, while a real key on an invalid row
    (dropped for a non-finite value) still claims its vocabulary slot, as
    in the host encoder, but codes to -1 like the host's pk mark.
    """
    out = np.empty((len(h), 3), np.uint32)
    out[:, 0] = (h >> np.uint64(32)).astype(np.uint32)
    out[:, 1] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 2] = 1 if valid is None else valid.astype(np.uint32)
    return out


def _concat(arrays: Sequence[np.ndarray], dtype=None) -> np.ndarray:
    arrays = [a for a in arrays if len(a)]
    if not arrays:
        return np.empty(0, dtype or np.uint64)
    if len(arrays) == 1:
        return arrays[0]
    return np.concatenate(arrays)


def merge_hash_uniques(
        h1_chunks: Sequence[np.ndarray],
        h2_chunks: Sequence[np.ndarray],
        key_chunks: Optional[Sequence[np.ndarray]] = None,
        pos_chunks: Optional[Sequence[np.ndarray]] = None,
        what: str = "key",
) -> Tuple[np.ndarray, Optional[np.ndarray], int, Optional[np.ndarray]]:
    """Merges per-chunk unique (h1, h2[, key][, pos]) tuples.

    Over the chunks' uniques (never rows): dedupes by (h1, h2) pair,
    checks that every primary hash maps to exactly one secondary hash (two
    secondaries = two distinct raw keys collided on h1 ->
    HashCollisionError), and returns ``(sorted_unique_h1, keys_or_None,
    n_unique, first_pos_or_None)``: the hash-sorted decode table, with
    each hash's first-occurrence key and, when positions are given, its
    smallest stream position, from which the code order follows.

    The ingest's chunks come in stream order with each hash once a chunk,
    so one stable sort by h1 leaves each hash's entries in position order
    and its first the smallest position. Where that does not hold, or two
    secondaries meet, the JAX package's (pos, h2, h1) lexsort decides.
    """
    h1 = _concat(h1_chunks)
    h2 = _concat(h2_chunks)
    keys = (_concat(key_chunks, dtype=object)
            if key_chunks is not None else None)
    pos = (_concat(pos_chunks, dtype=np.int64)
           if pos_chunks is not None else None)
    if len(h1) == 0:
        return (h1, (keys if keys is None else keys[:0]), 0,
                (pos if pos is None else pos[:0]))
    order = np.argsort(h1, kind="stable")
    s1, s2 = h1[order], h2[order]
    new1 = np.empty(len(s1), bool)
    new1[0] = True
    np.not_equal(s1[1:], s1[:-1], out=new1[1:])
    same = ~new1[1:]
    spos = None if pos is None else pos[order]
    if (same & (s2[1:] != s2[:-1])).any() or (
            spos is not None and (same & (spos[1:] < spos[:-1])).any()):
        return _merge_lexsort(h1, h2, keys, pos, what)
    first = order[new1]
    return (s1[new1], None if keys is None else keys[first],
            int(new1.sum()), None if spos is None else spos[new1])


def _merge_lexsort(h1, h2, keys, pos, what: str):
    """merge_hash_uniques by the JAX package's lexsort: the result, or
    HashCollisionError naming one offender and the colliding pair count."""
    sort_keys = (h2, h1) if pos is None else (pos, h2, h1)
    order = np.lexsort(sort_keys)
    s1, s2 = h1[order], h2[order]
    new1 = np.empty(len(s1), bool)
    new1[0] = True
    np.not_equal(s1[1:], s1[:-1], out=new1[1:])
    pair_new = new1.copy()
    pair_new[1:] |= s2[1:] != s2[:-1]
    n_h1 = int(new1.sum())
    n_pairs = int(pair_new.sum())
    if n_pairs != n_h1:
        # Name one offender: a pair start that is not an h1 start means
        # its h1 already appeared with another h2.
        bad = np.nonzero(pair_new & ~new1)[0][0]
        raise HashCollisionError(
            f"uint64 hash collision among {what} keys: primary hash "
            f"{int(s1[bad])} maps to (at least) two distinct raw keys "
            f"(secondary lanes {int(s2[bad - 1])} != {int(s2[bad])}) — "
            f"{n_pairs - n_h1} colliding pair(s) total")
    return (s1[new1], None if keys is None else keys[order][new1], n_h1,
            None if pos is None else pos[order][new1])


def prefers_lookup_codes(device: torch.device) -> bool:
    """Which code-assignment kernel fits the device, as the JAX package
    decides: the self-contained factorize (C12) on the card, the lookup
    against the host-merged table (C13) on the CPU, where a sort of every
    row loses to a binary search. Both give the same codes."""
    return torch.device(device).type == "cpu"


def build_lookup_table(sorted_hashes: np.ndarray, first_pos: np.ndarray,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lookup kernel's operands from the merged unique table, on
    `device`: (hash lanes int32[Vcap, 2], the uint32 bit patterns;
    first-occurrence code of each hash-sorted entry int32[Vcap]),
    sentinel-padded to a rounded capacity (codes -1 there)."""
    v = len(sorted_hashes)
    cap = round_capacity(v)
    lanes = np.full((cap, 2), _U32_MAX, np.uint32)
    lanes[:v, 0] = (sorted_hashes >> np.uint64(32)).astype(np.uint32)
    lanes[:v, 1] = (sorted_hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    codes = np.full(cap, -1, np.int32)
    order = np.argsort(first_pos, kind="stable")
    codes[order] = np.arange(v, dtype=np.int32)
    return (torch.from_numpy(lanes.view(np.int32)).to(device),
            torch.from_numpy(codes).to(device))


# ---------------------------------------------------------------------------
# The mesh factorize (K23b)


def _as_sharded(mesh: "mesh_lib.Mesh", hashes) -> ShardedColumn:
    """Hash rows as a ShardedColumn over `mesh`: as given, or a tensor
    split evenly (its length a multiple of the mesh size), as shard_map
    splits a global array."""
    if isinstance(hashes, ShardedColumn):
        if hashes.mesh != mesh:
            raise ValueError(f"mesh_factorize: hash rows sharded over "
                             f"{hashes.mesh}, not {mesh}")
        return hashes
    n = hashes.shape[0]
    if n % mesh.size:
        raise ValueError(f"mesh_factorize: {n} rows do not split evenly "
                         f"over {mesh.size} shards")
    local = n // mesh.size
    return ShardedColumn([hashes[s * local:(s + 1) * local].to(dev)
                          for s, dev in enumerate(mesh.devices)], mesh)


def _local_runs(mesh: "mesh_lib.Mesh", hashes: ShardedColumn,
                n_distinct: Optional[int]) -> list:
    """The local phase on every shard where it lies: (lcode, n_new, heads)
    a shard (kernels.mesh_local_uniques: C12's table, no sort), one run
    serving both the unique-cap count and the factorize."""
    runs = []
    for rows, dev in zip(hashes.shards, mesh.devices):
        with on_device(dev):
            runs.append(kernels.mesh_local_uniques(rows, n_distinct))
    return runs


def _check_count(what: str, count: int, n_distinct: Optional[int]) -> None:
    """A distinct count of the factorize: -1 (a table sized by a hint too
    small to hold the hashes) or a count above the hint raises, with no
    retry and no fallback."""
    if count < 0:
        raise RuntimeError(
            f"mesh_factorize: {what}'s table, sized for n_distinct="
            f"{n_distinct}, cannot hold its distinct hashes; the count hint "
            f"must be at least the number of distinct hashes")
    if n_distinct is not None and count > n_distinct:
        raise RuntimeError(
            f"mesh_factorize: {what} holds {count} distinct hashes, more "
            f"than n_distinct={n_distinct}; the count hint must be at least "
            f"the number of distinct hashes")


def _check_positions(mesh: "mesh_lib.Mesh", local: int,
                     uniq_cap: int = 0) -> None:
    """Global positions and the gathered table index int32: raises past
    2^31, never falls back."""
    if mesh.size * local >= 1 << 31 or mesh.size * uniq_cap >= 1 << 31:
        raise ValueError(
            f"mesh_factorize: {mesh.size} shards x {local} rows (unique "
            f"capacity {uniq_cap}) exceed the int32 positions of the "
            f"factorize (2^31)")


def mesh_unique_cap(mesh: "mesh_lib.Mesh", hashes, runs=None,
                    n_distinct: Optional[int] = None) -> int:
    """The largest per-shard count of distinct non-sentinel hashes (the
    JAX package's _mesh_unique_cap_kernel, a pmax over shards): the local
    phase's counts (runs, or a local run a shard here) in one host_fetch
    of the D counts. n_distinct: the caller's global distinct count, which
    sizes every table (kernels.factorize_table_plan)."""
    hashes = _as_sharded(mesh, hashes)
    _check_positions(mesh, hashes.shards[0].shape[0])
    runs = _local_runs(mesh, hashes, n_distinct) if runs is None else runs
    counts = mesh_lib.host_fetch(collectives.gather([r[1] for r in runs],
                                                    mesh.device))
    for s, count in enumerate(np.asarray(counts).reshape(-1).tolist()):
        _check_count(f"shard {s}", int(count), n_distinct)
    return int(np.asarray(counts).max())


def mesh_factorize_kernel(mesh: "mesh_lib.Mesh", hashes, uniq_cap: int,
                          runs=None, n_distinct: Optional[int] = None):
    """Sharded first-occurrence factorize (the JAX package's
    _mesh_factorize_kernel): each shard's local run (runs, or one here)
    holds its distinct hashes in first-row order (its heads table), the
    [D x uniq_cap] slots are gathered onto the gathering device and given
    their global codes there by one C12 run (kernels.mesh_merge_ranks:
    slot order is global first-position order), and each shard's
    [uniq_cap] window of those codes goes back to remap its rows' local
    codes where they lie (C24). uniq_cap must be at least every shard's
    unique count (mesh_unique_cap). Returns (codes int32 ShardedColumn
    like the rows, n_unique int32[] on the gathering device: -1 where
    n_distinct was too small for the merge's table)."""
    hashes = _as_sharded(mesh, hashes)
    local = hashes.shards[0].shape[0]
    _check_positions(mesh, local, uniq_cap)
    runs = _local_runs(mesh, hashes, n_distinct) if runs is None else runs
    tables = []
    for _, _, heads in runs:
        short = uniq_cap - heads.shape[0]
        tables.append(heads[:uniq_cap] if short <= 0 else torch.cat(
            [heads, heads.new_full((short, 3), -1)]))
    with on_device(mesh.device):
        gathered = collectives.gather(tables, mesh.device).reshape(-1, 3)
        remap, n_unique = kernels.mesh_merge_ranks(gathered, n_distinct)
    codes = []
    for s, ((lcode, _, _), dev) in enumerate(zip(runs, mesh.devices)):
        window = remap[s * uniq_cap:(s + 1) * uniq_cap].to(dev)
        with on_device(dev):
            codes.append(kernels.mesh_remap_rows(lcode, window))
    return ShardedColumn(codes, mesh, len(hashes)), n_unique


def mesh_factorize_codes(mesh: "mesh_lib.Mesh", hashes,
                         n_distinct: Optional[int] = None):
    """Two-phase meshed factorize of row-sharded (n, 3) hash rows (the JAX
    package's mesh_factorize_codes): one local run a shard gives the
    per-shard unique counts, whose maximum, round_capacity'd, fixes the
    gather capacity, and the local codes and heads the factorize then
    merges; nothing is sorted. n_distinct: the global distinct count the
    caller already holds (the pod ingest's host merge), or an upper bound
    of it; it sizes every C12 table, min(n_distinct, shard rows) for a
    shard's. Without it the tables are sized from the rows. A count hint
    below the distinct count raises (RuntimeError), never falls back.
    Returns (codes int32 ShardedColumn, n_unique host int)."""
    hashes = _as_sharded(mesh, hashes)
    runs = _local_runs(mesh, hashes, n_distinct)
    uniq_cap = mesh_lib.round_capacity(mesh_unique_cap(mesh, hashes, runs,
                                                       n_distinct))
    codes, n_unique = mesh_factorize_kernel(mesh, hashes, uniq_cap, runs,
                                            n_distinct)
    n_unique = int(mesh_lib.host_fetch(n_unique))
    _check_count("the merged table", n_unique, n_distinct)
    return codes, n_unique


class HashVocab:
    """Partition vocabulary of the hash-encoded path, decoded only at the
    DP-selected indices.

    Sequence-compatible (``len``, integer ``__getitem__``), so the decoders
    index it like a host vocabulary, but a raw key is looked up (binary
    search of the hash-sorted table) only when its partition was kept:
    ``prefetch`` resolves exactly the kept codes in one O(kept) batch; an
    unprefetched ``__getitem__`` materializes the whole table once.

    The code -> key-hash order comes from the chunk workers' O(uniques)
    tables and their first-occurrence positions (``merge_hash_uniques``),
    so decoding copies nothing from the device.
    """

    def __init__(self, n_codes: int, table_hashes: np.ndarray,
                 table_keys: np.ndarray,
                 hash_by_code_host: np.ndarray = None):
        if hash_by_code_host is None or len(hash_by_code_host) != \
                int(n_codes):
            raise ValueError(
                f"HashVocab: hash_by_code_host must carry one hash per "
                f"code ({n_codes}), got "
                f"{None if hash_by_code_host is None else len(hash_by_code_host)}")
        self._n = int(n_codes)
        self._table_hashes = table_hashes  # uint64, ascending
        self._table_keys = table_keys
        self._host = hash_by_code_host  # uint64[n_codes]
        self._cache = {}  # code -> decoded raw key

    def __len__(self) -> int:
        return self._n

    def _keys_for_hashes(self, hashes: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._table_hashes, hashes)
        in_range = pos < len(self._table_hashes)
        if not (in_range.all() and
                bool((self._table_hashes[np.minimum(
                    pos, len(self._table_hashes) - 1)] == hashes).all())):
            raise RuntimeError(
                "hash-device decode table is missing a selected "
                "partition's key hash — the device factorize and the "
                "host unique merge disagree (internal invariant)")
        return self._table_keys[pos]

    def prefetch(self, codes) -> None:
        """Resolves a batch of partition codes to raw keys in one O(kept)
        lookup: call it with exactly the DP-selected indices."""
        need = sorted({
            int(c)
            for c in codes if 0 <= int(c) < self._n and
            int(c) not in self._cache
        })
        if not need:
            return
        idx = np.fromiter(need, np.int64, len(need))
        for code, key in zip(need,
                             self._keys_for_hashes(self._host[idx])):
            self._cache[code] = key

    def __getitem__(self, code):
        code = int(code)
        if not 0 <= code < self._n:
            raise IndexError(code)
        if code not in self._cache:
            # Unprefetched access walks the whole vocabulary: materialize
            # the code -> key map once.
            self.prefetch(range(self._n))
        return self._cache[code]
