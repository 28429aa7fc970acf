"""The port's streamed ingest (pipelinedp_tpu_torch/runtime/pipeline.py,
ingest.py, the ChunkSource entry of DPEngine) against the JAX package's on
the CPU, with numpy inputs from a seed, float64 (JAX under x64).

Bounds stated here:
  * map_overlapped: exact order; at most `depth` items in flight.
  * encoded columns (both encode modes, serial and pipelined), the
    accumulator's buffers (both modes) and the vocabularies: identical to
    the JAX package's and to executor.pad_rows of the serial encode.
  * releases of a ChunkSource on TorchBackend(device="cpu"): the same kept
    partitions as TPUBackend on the same source and seed, values within
    1e-9 relative (max(1, |x|)), the bound of test_torch_engine (float64
    noise words agree to the ulp bounds of test_torch_threefry); and
    identical (==) to the port's own release of the same rows.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import ingest as jax_ingest
from pipelinedp_tpu_torch import columnar, device_encode, executor, ingest
from pipelinedp_tpu_torch import input_validators, kernels
from pipelinedp_tpu_torch.runtime import pipeline as rt_pipeline

pytestmark = pytest.mark.torch_port

F64 = torch.float64


def stream(n=3000, n_users=250, n_parts=30, seed=5):
    rng = np.random.default_rng(seed)
    pids = np.char.add("u", rng.integers(0, n_users, n).astype(str))
    pks = np.char.add("p", (rng.integers(0, n_parts, n)**2 //
                            n_parts).astype(str))
    vals = rng.uniform(0, 9, n)
    return pids, pks, vals


def chunked(pids, pks, vals, chunk=500):
    return [(pids[i:i + chunk], pks[i:i + chunk], vals[i:i + chunk])
            for i in range(0, len(pids), chunk)]


def padded(encoded, pad_rows):
    return [np.asarray(c) for c in pad_rows(encoded)]


def assert_same_inputs(got, want, want_pad_rows=executor.pad_rows):
    """Equal kernel inputs (pid, pk, values, valid after pad_rows), id
    counts and vocabularies."""
    for g, w in zip(padded(got, executor.pad_rows),
                    padded(want, want_pad_rows)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got.n_privacy_ids == want.n_privacy_ids
    assert [got.partition_vocab[i] for i in range(len(got.partition_vocab))
            ] == list(want.partition_vocab)


def encode(chunks, **kw):
    return ingest.stream_encode_columns(chunks, device="cpu", dtype=F64,
                                        **kw)


# --- map_overlapped ----------------------------------------------------------


def test_map_overlapped_keeps_input_order():
    def slow_square(x):
        time.sleep(0.02 * (8 - x) / 8)
        return x * x

    out = list(rt_pipeline.map_overlapped(range(8), slow_square,
                                          encode_threads=4, depth=8))
    assert out == [x * x for x in range(8)]


def test_map_overlapped_backpressure_bounds_the_window():
    depth, lock, in_flight, peak = 3, threading.Lock(), [], [0]

    def tracked(x):
        with lock:
            in_flight.append(x)
            peak[0] = max(peak[0], len(in_flight))
        time.sleep(0.01)
        with lock:
            in_flight.remove(x)
        return x

    consumed = []
    for x in rt_pipeline.map_overlapped(range(20), tracked, encode_threads=4,
                                        depth=depth):
        time.sleep(0.005)
        consumed.append(x)
    assert consumed == list(range(20)) and peak[0] <= depth


def test_map_overlapped_worker_exception_surfaces():
    def boom(x):
        if x == 3:
            raise RuntimeError("encode worker crashed")
        return x

    out = []
    with pytest.raises(RuntimeError, match="encode worker crashed"):
        for x in rt_pipeline.map_overlapped(range(6), boom, encode_threads=2,
                                            depth=4):
            out.append(x)
    assert out == [0, 1, 2]


def test_map_overlapped_producer_exception_surfaces():
    def items():
        yield 1
        yield 2
        raise ValueError("bad input file")

    out = []
    with pytest.raises(ValueError, match="bad input file"):
        for x in rt_pipeline.map_overlapped(items(), lambda v: v,
                                            encode_threads=1, depth=4):
            out.append(x)
    assert out == [1, 2]
    assert list(rt_pipeline.map_overlapped((), lambda v: v, 1)) == []


@pytest.mark.parametrize("bad", [0, -1, 1.5, True])
def test_map_overlapped_rejects_bad_window(bad):
    with pytest.raises(ValueError):
        list(rt_pipeline.map_overlapped((), lambda v: v, encode_threads=1,
                                        depth=bad))


# --- DeviceRowAccumulator ------------------------------------------------------


def row_chunk(n, seed, vector=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, n).astype(np.int32),
            rng.integers(0, 9, n).astype(np.int32),
            rng.uniform(0, 5, (n, vector) if vector else n))


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("sizes,vector,batch", [
    ((700, 700, 700, 700, 700), 0, 0),
    ((1000, 20, 3000), 0, 0),
    ((5,), 0, 0),
    ((40, 500), 3, 0),
    ((300, 300, 900, 10), 0, 512),
])
def test_accumulator_equals_pad_rows(donate, sizes, vector, batch):
    chunks = [row_chunk(n, i, vector) for i, n in enumerate(sizes)]
    cols = [np.concatenate(c) for c in zip(*chunks)]
    want = executor.pad_rows(columnar.EncodedData(
        pid=cols[0], pk=cols[1], values=cols[2],
        partition_vocab=list(range(9)), n_privacy_ids=50))[:3]
    acc = rt_pipeline.DeviceRowAccumulator("cpu", donate=donate,
                                           batch_rows=batch)
    assert acc.donating == donate
    for pid, pk, values in chunks:
        # Rows past n_real (the JAX package's bucket pad) are ignored.
        n = len(pid)
        acc.append(*(np.concatenate([a, a[:3]]) for a in (pid, pk, values)),
                   n)
    assert acc.n_rows == sum(sizes)
    for got, w in zip(acc.finalize(), want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("donate", [False, True])
def test_accumulator_hash_fills_pad_the_tail(donate):
    h = device_encode.pack_hash_rows(ingest.hash_key_column(np.arange(5)))
    k = device_encode.pack_hash_rows(ingest.hash_key_column(np.arange(5) %
                                                            2))
    acc = rt_pipeline.DeviceRowAccumulator("cpu", donate=donate,
                                           fills=(-1, -1, 0))
    acc.append(h.view(np.int32), k.view(np.int32), np.arange(5.0), 5)
    bufs = acc.finalize()
    assert bufs[0].shape == (executor.row_bucket(5), 3)
    assert (bufs[0][5:].numpy().view(np.uint32) == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(bufs[0][:5].numpy().view(np.uint32), h)
    assert bufs[2][5:].sum() == 0


def test_accumulator_empty_stream_finalizes_none():
    assert rt_pipeline.DeviceRowAccumulator("cpu").finalize() is None
    assert not rt_pipeline.DeviceRowAccumulator("cpu").donating


# --- stream_encode_columns against the JAX package ----------------------------


PIDS, PKS, VALS = stream()


@pytest.mark.parametrize("mode", ["host", "hash_device"])
@pytest.mark.parametrize("threads,depth", [(0, None), (2, 2), (1, 1)])
def test_stream_encode_matches_jax(mode, threads, depth):
    chunks = chunked(PIDS, PKS, VALS)
    want = jax_ingest.stream_encode_columns(chunks)
    got = encode(chunks, encode_threads=threads, pipeline_depth=depth,
                 encode_mode=mode)
    assert_same_inputs(got, want, jax_executor.pad_rows)
    serial = columnar.encode_columns(PIDS, PKS, VALS)
    assert_same_inputs(got, serial)


@pytest.mark.parametrize("mode", ["host", "hash_device"])
def test_stream_encode_public_partitions(mode):
    public = [f"p{i}" for i in range(12)] + ["absent"]
    chunks = chunked(PIDS, PKS, VALS)
    got = encode(chunks, public_partitions=public, encode_mode=mode,
                 encode_threads=2)
    want = jax_ingest.stream_encode_columns(chunks,
                                            public_partitions=public)
    assert_same_inputs(got, want, jax_executor.pad_rows)
    assert got.public_encoded and list(got.partition_vocab) == public


def test_stream_encode_mixed_dtypes_match_jax():
    # Int chunks, then float chunks with NaN keys, then wider strings:
    # the vocabulary promotes and NaN keeps one code, as one factorize of
    # the concatenation.
    rng = np.random.default_rng(8)
    pk_chunks = [rng.integers(0, 6, 40), np.array([1.5, np.nan, 2.0, np.nan]),
                 rng.integers(3, 9, 30).astype(np.float64)]
    chunks = [(rng.integers(0, 20, len(k)), k, rng.uniform(0, 1, len(k)))
              for k in pk_chunks]
    want = jax_ingest.stream_encode_columns(chunks)
    for mode in ("host", "hash_device"):
        got = encode(chunks, encode_mode=mode)
        g = padded(got, executor.pad_rows)
        w = padded(want, jax_executor.pad_rows)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        vocab = [got.partition_vocab[i]
                 for i in range(len(got.partition_vocab))]
        np.testing.assert_array_equal(np.asarray(vocab, np.float64),
                                      np.asarray(want.partition_vocab,
                                                 np.float64))


@pytest.mark.parametrize("raw,vocab", [
    (np.array([3, 1, 7, 3, -2]), [1, 3, 5]),
    (np.array([3.0, np.nan, -0.0, 2.5]), [0.0, 2.5, 3.0]),
    (np.array([3.0, np.nan, 1.0]), [np.nan, 1.0]),
    (np.array(["b", "a", "zz", "a"]), ["a", "b", "c"]),
    (np.array([1, 2]), ["1", 2]),
    (np.array(["x", 1, None], dtype=object), ["x", None]),
    (np.array([4, 4, 9]), [4, 9, 4]),
], ids=lambda x: repr(x)[:30])
def test_encode_with_vocab_matches_the_dict_lookup(raw, vocab):
    lookup = {columnar._canonical_key(k): i for i, k in enumerate(vocab)}
    want = [lookup.get(columnar._canonical_key(k), -1) for k in raw]
    got = columnar.encode_with_vocab(raw, vocab)
    assert got.dtype == np.int32 and got.tolist() == want


@pytest.mark.parametrize("raw", [
    np.array([5, 3, 5, 9, 3, 3, -1]),
    np.array([2.5, -0.0, 0.0, 2.5, 1e300, -0.0]),
    np.array(["b", "a", "b", "", "ab"]),
    np.array([b"x", b"", b"x"]),
    np.array([True, False, True]),
    np.array([1.0, np.nan, 1.0, np.nan]),
    np.array([3], np.int32),
    np.array([], np.int64),
], ids=lambda x: repr(x)[:40])
def test_factorize_matches_pandas(raw):
    import pandas
    codes, uniques = columnar.factorize(raw)
    want_codes, want_uniques = pandas.factorize(raw, use_na_sentinel=False)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(np.asarray(uniques),
                                  np.asarray(want_uniques))
    # The first occurrence's own value (-0.0 or 0.0) is the unique.
    if raw.dtype.kind == "f" and len(raw):
        np.testing.assert_array_equal(np.signbit(np.asarray(uniques)),
                                      np.signbit(np.asarray(want_uniques)))


def test_chunked_vocab_encoder_spills_unorderable_keys():
    enc = ingest.ChunkedVocabEncoder()
    a = enc.encode(np.array([3, 1, 3]))
    b = enc.encode(np.array(["x", 1, (2, 3)], dtype=object))
    assert a.tolist() == [0, 1, 0] and b.tolist() == [2, 1, 3]
    assert list(enc.vocabulary) == [3, 1, "x", (2, 3)] and len(enc) == 4


@pytest.mark.parametrize("mode", ["host", "hash_device"])
def test_empty_stream(mode):
    enc = encode([], encode_mode=mode)
    assert enc.n_rows == 0 and len(enc.partition_vocab) == 0
    assert enc.n_privacy_ids == 0


def test_hash_vocab_decodes_lazily():
    chunks = chunked(PIDS, PKS, VALS)
    host = encode(chunks)
    vocab = encode(chunks, encode_mode="hash_device").partition_vocab
    assert isinstance(vocab, device_encode.HashVocab)
    ref = list(host.partition_vocab)
    vocab.prefetch([3, 7])
    assert len(vocab._cache) == 2
    assert vocab[3] == ref[3] and vocab[7] == ref[7]
    assert vocab[11] == ref[11] and list(vocab) == ref
    with pytest.raises(IndexError):
        vocab[len(ref)]


# --- non-finite values ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["host", "hash_device"])
@pytest.mark.parametrize("threads", [0, 2])
def test_nonfinite_error_and_drop(mode, threads):
    vals = VALS.copy()
    vals[2] = np.nan  # an early drop: later codes must not shift
    vals[1100] = np.inf
    chunks = chunked(PIDS, PKS, vals)
    with pytest.raises(ValueError, match="non-finite"):
        encode(chunks, encode_mode=mode, encode_threads=threads)
    got = encode(chunks, nonfinite="drop", encode_mode=mode,
                 encode_threads=threads)
    want = jax_ingest.stream_encode_columns(chunks, nonfinite="drop")
    assert_same_inputs(got, want, jax_executor.pad_rows)
    valid = got.valid.numpy()
    assert not valid[2] and not valid[1100] and valid[:len(vals)].sum() == \
        len(vals) - 2
    assert np.isfinite(got.values.numpy()).all()


def two_chunks_with_a_drop_in_the_second():
    pids = np.array(["u1", "u2", "u3", "u4"])
    pks = np.array(["a", "b", "c", "a"])
    vals = np.array([1.0, np.nan, 2.0, 3.0])
    return [(pids[:1], pks[:1], vals[:1]), (pids[1:], pks[1:], vals[1:])]


@pytest.mark.parametrize("threads", [0, 2])
def test_drop_in_a_later_chunk_keeps_the_row_invalid(threads):
    chunks = two_chunks_with_a_drop_in_the_second()
    want = jax_ingest.stream_encode_columns(chunks, nonfinite="drop")
    got = encode(chunks, nonfinite="drop", encode_threads=threads)
    assert_same_inputs(got, want, jax_executor.pad_rows)
    assert got.pk.tolist()[:4] == [0, -1, 2, 0]


def test_reference_pipelined_drop_revalidates_the_row():
    # The fault of ROADMAP.md Queue 3 in the JAX package: its pipelined
    # host encode marks the dropped row -1 before the vocabulary merge,
    # whose remap then reads -1 as the chunk's last unique ("a", code 0),
    # so the row counts again, with value 0.
    chunks = two_chunks_with_a_drop_in_the_second()
    serial = jax_ingest.stream_encode_columns(chunks, nonfinite="drop")
    piped = jax_ingest.stream_encode_columns(chunks, nonfinite="drop",
                                             encode_threads=2)
    assert np.asarray(serial.pk)[:4].tolist() == [0, -1, 2, 0]
    assert np.asarray(piped.pk)[:4].tolist() == [0, 0, 2, 0]


def test_nonfinite_vector_rows_drop_whole_rows():
    vals = np.array([[1.0, np.nan], [2.0, 3.0], [np.inf, 0.0]])
    chunks = [(np.array(["u1", "u2", "u3"]), np.array(["a", "b", "a"]), vals)]
    got = encode(chunks, nonfinite="drop")
    assert got.valid.tolist()[:3] == [False, True, False]
    assert np.isfinite(got.values.numpy()).all()


# --- collision fallback ----------------------------------------------------------


def collide_keys(monkeypatch, victim, target):
    """The primary hash lane of `victim` set to `target`'s, the secondary
    lane left apart: what the two-lane detector exists for."""
    orig = ingest.hash_key_column_pair

    def colliding(raw):
        h0, h1 = orig(raw)
        arr = columnar._as_key_array(raw)
        h0 = h0.copy()
        h0[arr == victim] = orig(np.asarray([target], object))[0][0]
        return h0, h1

    monkeypatch.setattr(ingest, "hash_key_column_pair", colliding)


@pytest.mark.parametrize("victim,target", [("p1", "p0"), ("u1", "u2")])
def test_collision_falls_back_to_host_encoder(monkeypatch, victim, target):
    chunks = chunked(PIDS, PKS, VALS)
    host = encode(chunks)
    collide_keys(monkeypatch, victim, target)
    got = encode(chunks, encode_mode="hash_device", encode_threads=2)
    assert not isinstance(got.partition_vocab, device_encode.HashVocab)
    assert_same_inputs(got, host)


def test_collision_on_a_one_shot_iterator_raises(monkeypatch):
    collide_keys(monkeypatch, "p1", "p0")
    with pytest.raises(device_encode.HashCollisionError,
                       match="one-shot iterator"):
        encode(iter(chunked(PIDS, PKS, VALS)), encode_mode="hash_device")


# --- DPEngine with a ChunkSource ---------------------------------------------------

EXTRACTORS = dict(privacy_id_extractor=lambda r: r[0],
                  partition_extractor=lambda r: r[1],
                  value_extractor=lambda r: float(r[2]))
ROUTES = {"dense": {}, "blocked": dict(large_partition_threshold=16,
                                       block_partitions=8)}


def aggregate(mod, col, route, public, **backend_kw):
    kw = dict(noise_seed=29, **ROUTES[route], **backend_kw)
    backend = (pdp.TPUBackend(**kw) if mod is pdp else
               tdp.TorchBackend(device="cpu", dtype=F64, **kw))
    acc = mod.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-5)
    params = mod.AggregateParams(
        metrics=[mod.Metrics.COUNT, mod.Metrics.SUM, mod.Metrics.MEAN],
        noise_kind=mod.NoiseKind.LAPLACE, max_partitions_contributed=4,
        max_contributions_per_partition=8, min_value=0.0, max_value=9.0)
    res = mod.DPEngine(acc, backend).aggregate(
        col, params, mod.DataExtractors(**EXTRACTORS),
        sorted(set(PKS.tolist())) if public else None)
    acc.compute_budgets()
    return dict(res)


def select(mod, col, route, **backend_kw):
    kw = dict(noise_seed=29, **ROUTES[route], **backend_kw)
    backend = (pdp.TPUBackend(**kw) if mod is pdp else
               tdp.TorchBackend(device="cpu", dtype=F64, **kw))
    acc = mod.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-5)
    res = mod.DPEngine(acc, backend).select_partitions(
        col, mod.SelectPartitionsParams(max_partitions_contributed=4),
        mod.DataExtractors(**EXTRACTORS))
    acc.compute_budgets()
    return list(res)


def close_releases(got, want):
    assert got and set(got) == set(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)


@functools.lru_cache(maxsize=None)
def jax_aggregate(route, public):
    return aggregate(pdp, pdp.ChunkSource(chunked(PIDS, PKS, VALS)), route,
                     public, encode_threads=2)


@functools.lru_cache(maxsize=None)
def serial_aggregate(route, public):
    rows = list(zip(PIDS.tolist(), PKS.tolist(), VALS.tolist()))
    return aggregate(tdp, rows, route, public)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("public", [False, True])
@pytest.mark.parametrize("mode", ["host", "hash_device"])
def test_engine_aggregate_chunk_source(route, public, mode):
    got = aggregate(tdp, tdp.ChunkSource(chunked(PIDS, PKS, VALS)), route,
                    public, encode_threads=2, encode_mode=mode)
    close_releases(got, jax_aggregate(route, public))
    assert got == serial_aggregate(route, public)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["host", "hash_device"])
def test_engine_select_chunk_source(route, mode):
    source = tdp.ChunkSource(chunked(PIDS, PKS, VALS), encode_mode=mode)
    got = select(tdp, source, route, encode_threads=0)
    want = select(pdp, pdp.ChunkSource(chunked(PIDS, PKS, VALS)), route)
    rows = list(zip(PIDS.tolist(), PKS.tolist(), VALS.tolist()))
    assert got and got == want == select(tdp, rows, route)


def test_chunk_source_mode_overrides_the_backend():
    source = tdp.ChunkSource(chunked(PIDS, PKS, VALS),
                             encode_mode="hash_device")
    calls = []
    original = kernels.lookup_codes

    def counted(*args):
        calls.append(1)
        return original(*args)

    kernels.lookup_codes = counted
    try:
        got = aggregate(tdp, source, "dense", False, encode_mode="host")
    finally:
        kernels.lookup_codes = original
    assert calls and got == serial_aggregate("dense", False)


# --- knobs -------------------------------------------------------------------------


@pytest.mark.parametrize("knob,bad", [("pipeline_depth", 0),
                                      ("pipeline_depth", True),
                                      ("pipeline_depth", 1.5),
                                      ("encode_threads", -1),
                                      ("encode_threads", "2"),
                                      ("encode_mode", "bogus")])
def test_backend_rejects_bad_knobs_like_jax(knob, bad):
    with pytest.raises(ValueError) as got:
        tdp.TorchBackend(device="cpu", **{knob: bad})
    with pytest.raises(ValueError) as want:
        pdp.TPUBackend(**{knob: bad})
    assert str(got.value).replace("TorchBackend", "") == \
        str(want.value).replace("TPUBackend", "")


def test_backend_accepts_valid_knobs():
    b = tdp.TorchBackend(device="cpu", pipeline_depth=2, encode_threads=0,
                         encode_mode="hash_device")
    assert (b.pipeline_depth, b.encode_threads, b.encode_mode) == (
        2, 0, "hash_device")


def test_chunk_source_validates():
    with pytest.raises(ValueError, match="error|drop"):
        tdp.ChunkSource([], nonfinite="ignore")
    with pytest.raises(ValueError, match="encode_mode"):
        tdp.ChunkSource([], encode_mode="bogus")
    with pytest.raises(ValueError, match="encode_mode"):
        ingest.stream_encode_columns([], encode_mode="bogus", device="cpu")
    input_validators.validate_encode_threads(0, "x")
