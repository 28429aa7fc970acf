"""The port's hash-keyed encode (pipelinedp_tpu_torch/device_encode.py, the
hash half of ingest.py, C12-C14's plain versions) against the JAX package's
on the CPU, with numpy inputs from a seed.

Bounds stated here: everything compared is an integer or a bit pattern, so
every comparison is exact: the hash words (against the JAX package's
hash_key_column_pair with pandas and, but for one-type object columns,
without), the codes and unique counts of C12's and C13's plain versions (against
_factorize_kernel and _lookup_kernel, sentinel and invalid rows included),
the merged unique tables, the lookup tables and the grown / tail-filled row
buffers (against executor.pad_rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu import device_encode as jax_device_encode
from pipelinedp_tpu import ingest as jax_ingest
from pipelinedp_tpu_torch import columnar, device_encode, executor, ingest
from pipelinedp_tpu_torch import kernels

pytestmark = pytest.mark.torch_port

_U32 = 0xFFFFFFFF


def _key_columns():
    rng = np.random.default_rng(41)
    ints = rng.integers(-50, 50, 300)
    floats = np.concatenate([rng.integers(0, 20, 200).astype(np.float64),
                             [np.nan, -0.0, 0.0, 3.0, np.inf, 2.0**60]])
    big = np.array([2**62, -2**62, 7, 2**53 + 1], np.int64)
    strs = np.char.add("u", rng.integers(0, 80, 250).astype(str))
    byts = np.array([b"a", b"bb", b"", b"a\x00b", b"bb"])
    mixed = np.array([1, "1", 1.0, (1, "a"), None, float("nan"), True, "x"],
                     dtype=object)
    return {"ints": ints, "floats": floats, "big_ints": big, "str": strs,
            "bytes": byts, "object_mixed": mixed,
            "list_of_str": ["a", "b", "a", "c"]}


KEY_COLUMNS = _key_columns()


@pytest.mark.parametrize("name", sorted(KEY_COLUMNS))
def test_hash_words_match_jax(name, monkeypatch):
    raw = KEY_COLUMNS[name]
    got = ingest.hash_key_column_pair(raw)
    # The JAX package's own branch (with pandas) for every column.
    for g, w in zip(got, jax_ingest.hash_key_column_pair(raw)):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
    # Its branch without pandas for every column but the one-type object
    # ones, which it hashes element by element (ROADMAP.md Queue 3).
    monkeypatch.setattr(jax_ingest, "_pd", None)
    if name != "list_of_str":
        for g, w in zip(got, jax_ingest.hash_key_column_pair(raw)):
            np.testing.assert_array_equal(g, w)


def object_column(keys):
    out = np.empty(len(keys), object)
    out[:] = keys
    return out


OBJECT_KEYS = [["a", np.str_("b")], [1, np.int64(2)], [True, np.bool_(0)],
               [1.0, np.nan, np.float32(2.5)], [1, 2.5], [1, np.nan],
               [1, "a"], [None, "a"], ["a", np.nan], [b"a"], [1, True],
               [1.0, True], [(1, 2)], [None], [1.5, "a"]]


@pytest.mark.parametrize("keys", OBJECT_KEYS, ids=repr)
def test_object_key_kind_matches_pandas(keys):
    import pandas
    raw = object_column(keys)
    want = pandas.api.types.infer_dtype(raw, skipna=False)
    got = ingest._object_key_kind(raw)
    vectorized = ("string", "integer", "boolean", "floating",
                  "mixed-integer-float")
    assert got == want or (want not in vectorized and
                           got not in vectorized), (got, want)


def test_reference_without_pandas_hashes_a_listed_key_apart(monkeypatch):
    # The fault of ROADMAP.md Queue 3: without pandas the JAX package
    # hashes "u1" in a list chunk (an object column) element by element and
    # "u1" in a numpy chunk by its characters, two hashes for one key. The
    # port hashes both alike.
    monkeypatch.setattr(jax_ingest, "_pd", None)
    listed, array = ["u1", "u2"], np.array(["u1", "u2"])
    assert (jax_ingest.hash_key_column(listed) !=
            jax_ingest.hash_key_column(array)).all()
    np.testing.assert_array_equal(ingest.hash_key_column(listed),
                                  ingest.hash_key_column(array))
    np.testing.assert_array_equal(ingest.hash_key_column([3, 4]),
                                  ingest.hash_key_column(np.array([3, 4])))


@pytest.mark.parametrize("name", ["ints", "str", "object_mixed"])
def test_hash_uniques_and_packed_rows_match_jax(name, monkeypatch):
    monkeypatch.setattr(jax_ingest, "_pd", None)
    raw = columnar._as_key_array(KEY_COLUMNS[name])
    h1, h2 = ingest.hash_key_column_pair(raw)
    got = ingest._hash_uniques(h1, h2, raw)
    want = jax_ingest._hash_uniques(h1, h2, raw)
    for g, w in zip(got, want):
        assert list(g) == list(w) or np.array_equal(g, w)
    valid = np.arange(len(h1)) % 3 != 0
    np.testing.assert_array_equal(device_encode.pack_hash_rows(h1, valid),
                                  jax_device_encode.pack_hash_rows(h1, valid))


def test_numeric_key_identity_follows_host_equality():
    h = ingest.hash_key_column(np.array([3, 3.0, np.nan, float("nan"), 4]))
    assert h[0] == h[1] and h[2] == h[3] and h[0] != h[4]
    h = ingest.hash_key_column(np.array([1, "1"], dtype=object))
    assert h[0] != h[1]


def hash_rows(seed, n, n_keys, sentinel_every=0, invalid_every=0):
    """uint32 (n, 3) rows over n_keys distinct 64-bit hashes with both
    halves of the uint32 range in each lane, some rows the pad sentinel and
    some invalid."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**63, n_keys, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, n_keys).astype(np.uint64)
    # A hash whose lanes differ from another's only in the low lane.
    keys[-1] = (keys[0] & np.uint64(0xFFFFFFFF00000000)) | np.uint64(5)
    h = keys[rng.integers(0, n_keys, n)]
    valid = np.ones(n, bool)
    if invalid_every:
        valid[::invalid_every] = False
    rows = jax_device_encode.pack_hash_rows(h, valid)
    if sentinel_every:
        rows[3::sentinel_every] = _U32
    return rows


def torch_rows(rows: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(rows.view(np.int32).copy())


FACTORIZE_CASES = {
    "plain": dict(seed=1, n=777, n_keys=60),
    "sentinels_and_invalid": dict(seed=2, n=1024, n_keys=300,
                                  sentinel_every=7, invalid_every=5),
    "all_distinct": dict(seed=3, n=500, n_keys=5000),
    "one_key": dict(seed=4, n=64, n_keys=1),
}


@pytest.mark.parametrize("case", sorted(FACTORIZE_CASES))
def test_factorize_plain_matches_jax(case):
    rows = hash_rows(**FACTORIZE_CASES[case])
    want_codes, want_n = jax_device_encode._factorize_kernel(
        jnp.asarray(rows))
    codes, n_unique = kernels.factorize_codes(torch_rows(rows))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert int(n_unique) == int(want_n)


def test_factorize_all_sentinel_rows():
    rows = np.full((16, 3), _U32, np.uint32)
    codes, n_unique = kernels.factorize_codes(torch_rows(rows))
    want_codes, want_n = jax_device_encode._factorize_kernel(
        jnp.asarray(rows))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert int(n_unique) == int(want_n) == 0


def test_invalid_rows_keep_vocabulary_slots():
    h = ingest.hash_key_column(np.array(["a", "b", "c", "b"]))
    valid = np.array([True, False, True, True])
    codes, n = kernels.factorize_codes(
        torch_rows(device_encode.pack_hash_rows(h, valid)))
    assert codes.tolist() == [0, -1, 2, 1] and int(n) == 3


def merged_table(rows: np.ndarray):
    """The host merge of the rows' distinct hashes as the ingest builds it
    (uniques with their first positions, secondary lane = primary)."""
    real = ~((rows[:, 0] == _U32) & (rows[:, 1] == _U32))
    h = jax_device_encode.join_hash64(rows[:, 0], rows[:, 1])
    u1, _, _, pos = jax_ingest._hash_uniques(h[real], h[real], None)
    return device_encode.merge_hash_uniques(
        [u1], [u1], None, [np.nonzero(real)[0][pos]])


@pytest.mark.parametrize("case", sorted(FACTORIZE_CASES))
def test_lookup_plain_matches_jax_and_factorize(case):
    rows = hash_rows(**FACTORIZE_CASES[case])
    s1, _, n_unique, pos = merged_table(rows)
    lanes, codes_t = device_encode.build_lookup_table(s1, pos, "cpu")
    want_lanes, want_codes_t = jax_device_encode.build_lookup_table(s1, pos)
    np.testing.assert_array_equal(lanes.numpy().view(np.uint32),
                                  np.asarray(want_lanes))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(want_codes_t))
    want = jax_device_encode._lookup_kernel(jnp.asarray(rows), want_lanes,
                                            want_codes_t)
    got = kernels.lookup_codes(torch_rows(rows), lanes, codes_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    factorized, n_fact = kernels.factorize_codes(torch_rows(rows))
    assert torch.equal(got, factorized) and int(n_fact) == n_unique


def test_joined_hash_order_is_unsigned_order():
    rows = hash_rows(seed=9, n=400, n_keys=400)
    keys = kernels.joined_hash_order(*torch_rows(rows)[:, :2].unbind(1))
    u64 = jax_device_encode.join_hash64(rows[:, 0], rows[:, 1])
    np.testing.assert_array_equal(np.argsort(keys.numpy(), kind="stable"),
                                  np.argsort(u64, kind="stable"))


def test_merge_hash_uniques_matches_jax():
    rng = np.random.default_rng(5)
    h1 = [rng.integers(0, 40, 30).astype(np.uint64) for _ in range(3)]
    h2 = [h + np.uint64(1000) for h in h1]
    keys = [np.array([f"k{int(x)}" for x in h], object) for h in h1]
    pos = [np.arange(30, dtype=np.int64) + 30 * j for j in range(3)]
    got = device_encode.merge_hash_uniques(h1, h2, keys, pos)
    want = jax_device_encode.merge_hash_uniques(h1, h2, keys, pos)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1]) and got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])


def test_hash_uniques_with_a_collision_in_the_chunk_match_jax():
    h1 = np.array([9, 4, 9, 4, 9, 7], np.uint64)
    h2 = np.array([1, 2, 3, 2, 1, 5], np.uint64)
    raw = np.array(list("abcdef"), object)
    got = ingest._hash_uniques(h1, h2, raw)
    want = jax_ingest._hash_uniques(h1, h2, raw)
    for g, w in zip(got, want):
        assert list(g) == list(w)
    assert len(got[0]) == 4  # (4, 2), (7, 5), (9, 1), (9, 3)


def test_merge_hash_uniques_out_of_stream_order_matches_jax():
    # Positions that do not grow chunk by chunk take the exact lexsort.
    h1 = [np.array([3, 8], np.uint64), np.array([3, 5], np.uint64)]
    pos = [np.array([10, 11], np.int64), np.array([2, 12], np.int64)]
    keys = [np.array(["x", "y"], object), np.array(["z", "w"], object)]
    got = device_encode.merge_hash_uniques(h1, h1, keys, pos)
    want = jax_device_encode.merge_hash_uniques(h1, h1, keys, pos)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1]) == ["z", "w", "y"]
    np.testing.assert_array_equal(got[3], want[3])


def test_merge_hash_uniques_collision_raises():
    h1 = [np.array([5], np.uint64), np.array([5], np.uint64)]
    h2 = [np.array([1], np.uint64), np.array([2], np.uint64)]
    with pytest.raises(device_encode.HashCollisionError,
                       match="primary hash 5"):
        device_encode.merge_hash_uniques(h1, h2)


def test_round_capacity_matches_jax():
    from pipelinedp_tpu.parallel import mesh as jax_mesh
    for x in (0, 1, 8, 9, 17, 100, 1000, 2**20 + 1, 480_189, 4_725_413):
        assert device_encode.round_capacity(x) == jax_mesh.round_capacity(x)


def test_prefers_lookup_on_the_cpu_only():
    assert device_encode.prefers_lookup_codes(torch.device("cpu"))
    assert not device_encode.prefers_lookup_codes(torch.device("cuda"))


# --- C14's plain versions against executor.pad_rows ------------------------


@pytest.mark.parametrize("vector", [0, 3])
def test_grow_and_fill_tail_give_pad_rows(vector):
    rng = np.random.default_rng(vector)
    n = 13
    pid = rng.integers(0, 5, n).astype(np.int32)
    pk = rng.integers(0, 4, n).astype(np.int32)
    values = rng.uniform(0, 5, (n, vector) if vector else n)
    want = executor.pad_rows(columnar.EncodedData(
        pid=pid, pk=pk, values=values, partition_vocab=list(range(4)),
        n_privacy_ids=5))[:3]
    fills = (0, -1, 0.0)
    bufs = [torch.empty((8,) + a.shape[1:], dtype=t)
            for a, t in ((pid, torch.int32), (pk, torch.int32),
                         (values, torch.float64))]
    for b, a in zip(bufs, (pid, pk, values)):
        b[:5] = torch.from_numpy(a[:5])
    kernels.fill_tail(bufs, 5, fills)
    bufs = kernels.grow_rows(bufs, 16, fills)
    for b, a in zip(bufs, (pid, pk, values)):
        b[5:n] = torch.from_numpy(a[5:n])
    for got, w in zip(bufs, want):
        np.testing.assert_array_equal(got.numpy(), w)


def test_hash_fills_are_the_sentinel_pattern():
    bufs = [torch.zeros((4, 3), dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), torch.ones(4)]
    grown = kernels.grow_rows(bufs, 8, (-1, -1, 0))
    assert (grown[0][4:].numpy().view(np.uint32) == _U32).all()
    assert grown[1][4:].tolist() == [-1] * 4 and grown[2][4:].sum() == 0


def test_append_rows_rejects_bad_buffers():
    with pytest.raises(ValueError, match="1 to 3 buffers"):
        kernels.fill_tail([torch.zeros(4)] * 4, 0, (0,) * 4)
    with pytest.raises(ValueError, match="buffer 1"):
        kernels.grow_rows([torch.zeros(4), torch.zeros(5)], 8, (0, 0))
    with pytest.raises(ValueError, match="new capacity"):
        kernels.grow_rows([torch.zeros(8)], 4, (0,))


# C12's hash table (csrc/factorize_codes.cu) step by step in numpy.

GOLDEN = 0x9E3779B97F4A7C15
EMPTY = 2**64 - 1


def model_factorize(rows: np.ndarray, slots: int, max_probes: int,
                    order=None):
    """The kernel's passes on uint32 (n, 3) rows, rows inserted in `order`
    (default: row order; the atomics' order does not matter): insert with
    the smallest row kept, each key probing linearly from its home slot
    (the top bits of key * GOLDEN) at most max_probes slots; the row bitmap
    of the slots' smallest rows; the exclusive prefix of its words'
    popcounts; each slot's code; each row's code, -1 for a sentinel or
    invalid row. Returns (codes, n_unique, or -1 where a key found no
    slot)."""
    n = len(rows)
    keys = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | \
        rows[:, 1].astype(np.uint64)
    shift = 64 - (slots.bit_length() - 1)
    table_key = [EMPTY] * slots
    table_row = [2**32 - 1] * slots
    slot_of = np.full(n, -1)
    overflow = False
    for i in (range(n) if order is None else order):
        key = int(keys[i])
        if key == EMPTY:
            continue
        s = ((key * GOLDEN) % 2**64) >> shift
        for _ in range(max_probes):
            if table_key[s] == EMPTY:
                table_key[s] = key
            if table_key[s] == key:
                table_row[s] = min(table_row[s], i)
                slot_of[i] = s
                break
            s = (s + 1) % slots
        else:
            overflow = True
    bits = np.zeros((n + 31) // 32, np.uint64)
    occupied = [s for s in range(slots) if table_key[s] != EMPTY]
    for s in occupied:
        bits[table_row[s] >> 5] |= np.uint64(1 << (table_row[s] & 31))
    popc = np.array([bin(int(w)).count("1") for w in bits], np.int64)
    prefix = np.cumsum(popc) - popc
    code = {s: int(prefix[table_row[s] >> 5]) + bin(
        int(bits[table_row[s] >> 5]) & ((1 << (table_row[s] & 31)) - 1)
    ).count("1") for s in occupied}
    keep = (slot_of >= 0) & (rows[:, 2] == 1)
    codes = np.array([code[s] if k else -1 for s, k in zip(slot_of, keep)],
                     np.int32)
    return codes, -1 if overflow else len(occupied)


def adversarial_rows():
    """Row sets the table must survive, as uint32 (n, 3) rows."""
    rng = np.random.default_rng(18)
    sentinel = np.uint64(EMPTY)

    def packed(keys, valid=None):
        return jax_device_encode.pack_hash_rows(
            keys, np.ones(len(keys), bool) if valid is None else valid)

    edge = np.array([(np.uint64(_U32) << np.uint64(32)) | np.uint64(5),
                     sentinel - np.uint64(1), np.uint64(0),
                     np.uint64(_U32)], np.uint64)
    mixed = edge[rng.integers(0, 4, 600)]
    mixed_rows = packed(mixed)
    mixed_rows[::5] = _U32  # sentinel rows interleaved
    claims = hash_rows(seed=19, n=900, n_keys=120, sentinel_every=4,
                       invalid_every=3)
    claims[1::7, 2] = 2  # a valid flag other than 0 / 1
    return {
        "one hash in every row": packed(np.full(700, np.uint64(12345))),
        "every row distinct": packed(
            rng.integers(0, 2**63, 800, dtype=np.uint64)),
        "0xffffffff hi lane, sentinel - 1, sentinels interleaved":
            mixed_rows,
        "invalid rows claim slots": claims,
    }


ADVERSARIAL = adversarial_rows()


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_factorize_plain_matches_jax_on_adversarial_rows(name):
    rows = ADVERSARIAL[name]
    want, want_n = jax_device_encode._factorize_kernel(jnp.asarray(rows))
    real = ~((rows[:, 0] == _U32) & (rows[:, 1] == _U32))
    n_distinct = len(np.unique(rows[real, :2], axis=0))
    for hint in (None, n_distinct, n_distinct + 7):
        codes, n_unique = kernels.factorize_codes(torch_rows(rows),
                                                  n_distinct=hint)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
        assert int(n_unique) == int(want_n) == n_distinct
        slots, probes = kernels.factorize_table_plan(len(rows), hint)
        m_codes, m_n = model_factorize(rows, slots, probes)
        np.testing.assert_array_equal(m_codes, np.asarray(want))
        assert m_n == n_distinct


@pytest.mark.parametrize("case", sorted(FACTORIZE_CASES))
@pytest.mark.parametrize("hint", ["exact", "above", "none"])
def test_hash_table_model_matches_jax(case, hint):
    """The model in a table of at least twice the distinct count, as the
    planner sizes it, and in a deliberately small one (the distinct count
    rounded up to a power of two, at least 2: keys share home slots and
    probe past each other), rows inserted in row order and shuffled."""
    rows = hash_rows(**FACTORIZE_CASES[case])
    want, want_n = jax_device_encode._factorize_kernel(jnp.asarray(rows))
    want = np.asarray(want)
    n_distinct = int(want_n)
    given = {"exact": n_distinct, "above": 2 * n_distinct + 3,
             "none": None}[hint]
    planned = kernels.factorize_table_plan(len(rows), given)
    small = max(2, 1 << max(0, (n_distinct - 1).bit_length()))
    shuffled = np.random.default_rng(len(rows)).permutation(len(rows))
    for slots, probes in (planned, (small, small)):
        for order in (None, shuffled):
            codes, n_unique = model_factorize(rows, slots, probes, order)
            np.testing.assert_array_equal(codes, want)
            assert n_unique == n_distinct


def test_hash_table_model_overflows_a_table_too_small():
    rows = hash_rows(seed=5, n=400, n_keys=200)
    n_distinct = len(np.unique(rows[:, :2], axis=0))
    slots = 1 << (n_distinct - 1).bit_length()
    assert model_factorize(rows, slots, slots)[1] == n_distinct
    assert model_factorize(rows, slots // 2, slots // 2)[1] == -1
    # A bound shorter than the table: a key whose run is longer fails.
    assert model_factorize(rows, slots, 1)[1] == -1


@pytest.mark.parametrize("n, hint, want", [
    (1 << 24, 480_189, (1 << 20, 1024)),
    (1 << 24, 17_770, (1 << 16, 1024)),
    (1 << 24, 4_725_413, (1 << 24, 1024)),
    (1 << 24, None, (1 << 25, 1024)),
    (100, None, (256, 256)),
    (100, 32, (64, 64)),
    (100, 33, (128, 128)),
    (5, 1000, (64, 64)),
    (0, None, (64, 64)),
    (3000, np.int64(600), (2048, 1024)),
])
def test_factorize_table_plan(n, hint, want):
    slots, probes = kernels.factorize_table_plan(n, hint)
    assert (slots, probes) == want
    keys = n if hint is None else min(int(hint), n)
    assert slots >= 2 * keys and slots & (slots - 1) == 0


@pytest.mark.parametrize("hint", [-1, True, 2.5, "3", [4]])
def test_factorize_hint_is_validated_on_the_cpu(hint):
    with pytest.raises(ValueError, match="n_distinct"):
        kernels.factorize_table_plan(10, hint)
    rows = torch_rows(hash_rows(seed=1, n=10, n_keys=3))
    with pytest.raises(ValueError, match="n_distinct"):
        kernels.factorize_codes(rows, n_distinct=hint)


def finalize_inputs(pk_table_rows=None):
    """Hash rows of a pid and a pk column with their host-merged tables (the
    pk table merged from pk_table_rows where given)."""
    pid_rows = hash_rows(seed=31, n=500, n_keys=90, invalid_every=6)
    pk_rows = hash_rows(seed=32, n=500, n_keys=40, sentinel_every=9)
    pk_rows[:, 2] = pid_rows[:, 2]
    s1, _, n, pos = merged_table(pid_rows)
    ps1, _, pn, ppos = merged_table(pk_rows if pk_table_rows is None
                                    else pk_table_rows)
    keys = np.array([f"k{i}" for i in range(pn)], object)
    return (torch_rows(pid_rows), torch_rows(pk_rows),
            torch.zeros(500, dtype=torch.float64), (s1, None, n, pos),
            (ps1, keys, pn, ppos))


@pytest.mark.parametrize("factorize", [False, True])
def test_finalize_hash_codes_counts_agree(monkeypatch, factorize):
    pid_rows, pk_rows, values, pid_table, pk_table = finalize_inputs()
    want = ingest._finalize_hash_codes(pid_rows, pk_rows, values, False,
                                       None, pid_table, pk_table)
    monkeypatch.setattr(device_encode, "prefers_lookup_codes",
                        lambda device: not factorize)
    got = ingest._finalize_hash_codes(pid_rows, pk_rows, values, False,
                                      None, pid_table, pk_table)
    assert torch.equal(got.pid, want.pid) and torch.equal(got.pk, want.pk)
    assert got.n_privacy_ids == want.n_privacy_ids == pid_table[2]


@pytest.mark.parametrize("column", ["privacy-id", "partition"])
def test_finalize_hash_codes_raises_on_a_device_count_unlike_the_host(
        monkeypatch, column):
    monkeypatch.setattr(device_encode, "prefers_lookup_codes",
                        lambda device: False)
    if column == "privacy-id":
        pid_rows, pk_rows, values, pid_table, pk_table = finalize_inputs()
        s1, keys, n, pos = pid_table
        pid_table = (s1, keys, n + 1, pos)
        public = True
    else:
        # The host merge saw one partition hash fewer than the rows hold.
        pk_only = hash_rows(seed=32, n=500, n_keys=40, sentinel_every=9)
        first = pk_only[0, :2].copy()
        dropped = pk_only.copy()
        dropped[(dropped[:, 0] == first[0]) & (dropped[:, 1] == first[1])] = \
            _U32
        pid_rows, pk_rows, values, pid_table, pk_table = finalize_inputs(
            dropped)
        public = False
    with pytest.raises(RuntimeError, match=f"distinct {column} hashes"):
        ingest._finalize_hash_codes(pid_rows, pk_rows, values, public,
                                    [0] if public else None, pid_table,
                                    pk_table)
