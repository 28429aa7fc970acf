"""The port's single-process mesh ingest against the JAX package's, on the
CPU: the mesh factorize (device_encode.mesh_factorize_codes, C24's plain
versions after C5's), the host shard encoders (encode_shard,
merge_shards, merge_shard_metas) and encode_local_shard_to_mesh in both
encode modes, then DPEngine on a meshed TorchBackend over the ingested
columns against TPUBackend(mesh=) over the JAX package's. Port meshes are
Mesh(["cpu"] * D), JAX meshes make_mesh(n_devices=D) on the conftest's 8
host devices; inputs come from numpy seeds.

Bounds stated here:
  * codes, unique counts, vocabularies, n_privacy_ids, global pid / pk
    columns and float64 values: exact (==);
  * releases: the same partitions; values within 1e-9 of max(1, |x|) of
    the JAX mesh's (ROADMAP.md Queue 3: integer sums exact, float64
    cross-shard sums within D * 2^-52 of the largest partial, noise words
    within the ulp bounds of tests/test_torch_threefry.py);
  * the port's host and hash_device ingests release the same results
    (==), as run_pod_engine asserts of the JAX package's.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import device_encode as jax_device_encode
from pipelinedp_tpu import ingest as jax_ingest
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import reshard as jax_reshard
from pipelinedp_tpu_torch import columnar, device_encode, executor, ingest
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import reshard
from pipelinedp_tpu_torch.parallel.mesh import (ShardedColumn, make_mesh,
                                                resplit)
from pipelinedp_tpu_torch.runtime import telemetry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _fresh():
    reshard.reset_capacity_cache()
    jax_reshard.reset_capacity_cache()
    telemetry.reset()
    yield
    telemetry.reset()


def port_mesh(d):
    return make_mesh(["cpu"] * d)


def host(col):
    """A column's global rows as numpy (ShardedColumn, tensor or array)."""
    if isinstance(col, ShardedColumn):
        return col.global_rows("cpu").numpy()
    if isinstance(col, torch.Tensor):
        return col.numpy()
    return np.asarray(col)


# ---------------------------------------------------------------------------
# The mesh factorize (K23b)


def hash_rows(raw, valid=None):
    return jax_device_encode.pack_hash_rows(jax_ingest.hash_key_column(raw),
                                            valid)


def sentinels(count):
    return np.full((count, 3), SENT, np.uint32)


def factorize_cases():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 61, 512)
    strs = np.char.add("k", rng.integers(0, 40, 360).astype(str))
    rows = hash_rows(strs, rng.random(360) > 0.2)
    return {
        "ints": hash_rows(raw),
        # 512 rows: invalid rows keep their vocabulary slot, sentinel runs
        # lie inside the stream, and on 4 shards shard 2 (rows 256-383)
        # holds sentinels only.
        "invalid_and_pads": np.concatenate([
            sentinels(3), rows[:200], sentinels(21), rows[200:232],
            sentinels(128), rows[232:]]),
        "all_pads": sentinels(64),
    }


FACTORIZE = factorize_cases()


def reference_codes(rows):
    """columnar.factorize's codes of the non-sentinel rows, -1 for the
    sentinel and invalid rows."""
    sent = (rows[:, 0] == SENT) & (rows[:, 1] == SENT)
    keys = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
    codes = np.full(len(rows), -1, np.int32)
    fact, uniq = columnar.factorize(keys[~sent])
    codes[~sent] = fact
    codes[rows[:, 2] != 1] = -1
    return codes, len(uniq)


@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(FACTORIZE))
def test_mesh_factorize_matches_jax_and_factorize(case, d):
    rows = FACTORIZE[case]
    mesh = port_mesh(d)
    codes, n = device_encode.mesh_factorize_codes(
        mesh, torch.from_numpy(rows.view(np.int32)))
    assert isinstance(codes, ShardedColumn) and codes.mesh == mesh
    want, n_want = jax_device_encode.mesh_factorize_codes(
        jax_make_mesh(n_devices=d), jnp.asarray(rows))
    np.testing.assert_array_equal(host(codes), np.asarray(want))
    assert n == n_want
    ref, n_ref = reference_codes(rows)
    np.testing.assert_array_equal(host(codes), ref)
    assert n == n_ref


@pytest.mark.parametrize("d", [1, 4, 8])
def test_unique_cap_is_the_jax_pmax(d):
    rows = FACTORIZE["invalid_and_pads"]
    got = device_encode.mesh_unique_cap(
        port_mesh(d), torch.from_numpy(rows.view(np.int32)))
    want = jax_device_encode._mesh_unique_cap_kernel(
        jnp.asarray(rows), jax_make_mesh(n_devices=d))
    assert got == int(want)


def test_local_uniques_table_and_remap_entries():
    """C24's per-shard entries on one shard: the heads table holds each
    hash's lanes in first-row order (sentinel excluded by value, padded
    with the sentinel row past n_new), the local codes rank the hashes by
    first row, a count hint sizes the table to round_capacity of it, and
    the remap writes -1 for sentinel and invalid rows."""
    rows = FACTORIZE["invalid_and_pads"][:200]
    t = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32))
    lcode, n_new, heads = kernels.mesh_local_uniques(t)
    sent = (rows[:, 0] == SENT) & (rows[:, 1] == SENT)
    assert int(n_new) == len({(a, b) for a, b in rows[~sent, :2]})
    h = heads.numpy()
    k = int(n_new)
    assert h.shape == (kernels.mesh_heads_capacity(200), 3)
    assert (h[k:] == -1).all() and (h[:k, 2] == 1).all()
    firsts = [np.nonzero((rows[:, 0].view(np.int32) == hi) &
                         (rows[:, 1].view(np.int32) == lo))[0][0]
              for hi, lo in h[:k, :2]]
    assert firsts == sorted(firsts)
    dropped = sent | (rows[:, 2] != 1)
    want = np.array([firsts.index(np.nonzero(
        (rows[:, 0] == a) & (rows[:, 1] == b))[0][0]) if not d else -1
        for (a, b, _), d in zip(rows, dropped)])
    np.testing.assert_array_equal(lcode.numpy(), want)
    assert kernels.mesh_local_uniques(t, n_distinct=k)[2].shape == (
        kernels.mesh_heads_capacity(200, k), 3)
    codes = kernels.mesh_remap_rows(lcode, torch.arange(64, dtype=torch.int32))
    assert (codes.numpy()[dropped] == -1).all()
    assert (codes.numpy()[~dropped] >= 0).all()


def test_mesh_factorize_refuses_int32_overflow():
    mesh = port_mesh(4)
    rows = torch.from_numpy(FACTORIZE["ints"].view(np.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        device_encode.mesh_factorize_kernel(mesh, rows, 1 << 29)
    with pytest.raises(ValueError, match="2\\^31"):
        device_encode._check_positions(mesh, 1 << 29)
    with pytest.raises(ValueError, match="split evenly"):
        device_encode.mesh_factorize_codes(mesh, rows[:510])


def test_sharded_column_and_resplit():
    mesh = port_mesh(4)
    col = ShardedColumn([torch.arange(s * 8, s * 8 + 8) for s in range(4)],
                        mesh, n=29)
    assert len(col) == 29 and col.shape == (29,)
    assert host(col >= 10).sum() == 19
    again = resplit(col, mesh, 8, -1)
    # Shards at their place stay where they lie; the last one's rows past
    # n take the fill.
    assert all(a is b for a, b in zip(again.shards[:3], col.shards))
    np.testing.assert_array_equal(again.shards[3].numpy(),
                                  [24, 25, 26, 27, 28, -1, -1, -1])
    moved = resplit(col, port_mesh(2), 24, -1, n=32)
    assert len(moved) == 32
    np.testing.assert_array_equal(
        torch.cat(moved.shards).numpy(),
        np.concatenate([np.arange(29), np.full(19, -1)]))
    with pytest.raises(ValueError):
        ShardedColumn([torch.zeros(3)] * 3, mesh)


# ---------------------------------------------------------------------------
# The host shard encoders


def stream(n=1600, seed=3, nonfinite=False):
    rng = np.random.default_rng(seed)
    pids = np.char.add("u", rng.integers(0, 150, n).astype(str))
    pks = np.char.add("p", rng.integers(0, 12, n).astype(str))
    vals = rng.integers(0, 6, n).astype(float)
    if nonfinite:
        vals[rng.choice(n, 25, replace=False)] = np.nan
    return pids, pks, vals


def chunks(cols, lo=0, hi=None, size=300):
    pids, pks, vals = cols
    hi = len(pids) if hi is None else hi
    return [(pids[i:min(i + size, hi)], pks[i:min(i + size, hi)],
             vals[i:min(i + size, hi)]) for i in range(lo, hi, size)]


STREAM = stream()
PUBLIC = [f"p{j}" for j in range(14)]


def assert_shard_equal(got, want):
    np.testing.assert_array_equal(got.pid, want.pid)
    np.testing.assert_array_equal(got.pk, want.pk)
    np.testing.assert_array_equal(got.values, want.values)
    assert list(got.pid_vocab) == list(want.pid_vocab)
    assert (got.pk_vocab is None) == (want.pk_vocab is None)
    if got.pk_vocab is not None:
        assert list(got.pk_vocab) == list(want.pk_vocab)


@pytest.mark.parametrize("public", [None, PUBLIC])
def test_encode_and_merge_shards_match_jax(public):
    cols = stream(nonfinite=public is not None)
    halves = [(0, 700), (700, 1600)]
    got = [ingest.encode_shard(chunks(cols, lo, hi), public, "drop")
           for lo, hi in halves]
    want = [jax_ingest.encode_shard(chunks(cols, lo, hi), public, "drop")
            for lo, hi in halves]
    for g, w in zip(got, want):
        assert_shard_equal(g, w)
    merged = ingest.merge_shards(got, public, device="cpu", dtype=F64)
    ref = jax_ingest.merge_shards(want, public)
    for name in ("pid", "pk", "values"):
        np.testing.assert_array_equal(host(getattr(merged, name)),
                                      np.asarray(getattr(ref, name)))
    assert merged.values.dtype == F64
    assert list(merged.partition_vocab) == list(ref.partition_vocab)
    assert merged.n_privacy_ids == ref.n_privacy_ids
    metas = [ingest._ShardMeta(len(s.pid), s.pid_vocab, s.pk_vocab)
             for s in got]
    jmetas = [jax_ingest._ShardMeta(len(s.pid), s.pid_vocab, s.pk_vocab)
              for s in want]
    g_meta = ingest.merge_shard_metas(metas, public is not None)
    w_meta = jax_ingest.merge_shard_metas(jmetas, public is not None)
    for g, w in zip(g_meta[0], w_meta[0]):
        np.testing.assert_array_equal(g, w)
    assert (g_meta[1] is None) == (w_meta[1] is None)
    for g, w in zip(g_meta[1] or [], w_meta[1] or []):
        np.testing.assert_array_equal(g, w)
    assert list(g_meta[2]) == list(w_meta[2])
    assert list(g_meta[3]) == list(w_meta[3])


def test_reference_pod_drop_revalidates_the_row():
    """With private partitions and nonfinite="drop", the JAX package's
    merge_shards and host-mode encode_local_shard_to_mesh index the
    remap with a dropped row's pk -1 (ingest.py:1102, :1185 there), which
    reads the shard's last unique: the row is back in that partition
    (ROADMAP.md Queue 3). The port keeps it out, as the serial encode and
    the JAX package's hash mode do."""
    cols = stream(nonfinite=True)
    dropped = np.isnan(cols[2])
    shard = jax_ingest.encode_shard(chunks(cols), None, "drop")
    assert (shard.pk[dropped] == -1).all()
    ref = jax_ingest.merge_shards([shard])
    assert (np.asarray(ref.pk)[dropped] >= 0).all()
    merged = ingest.merge_shards(
        [ingest.encode_shard(chunks(cols), None, "drop")], device="cpu",
        dtype=F64)
    serial = ingest.stream_encode_columns(chunks(cols), nonfinite="drop",
                                          device="cpu", dtype=F64)
    n = len(dropped)
    np.testing.assert_array_equal(host(merged.pk), host(serial.pk)[:n])
    assert (host(merged.pk)[dropped] == -1).all()
    jenc = jax_ingest.encode_local_shard_to_mesh(
        chunks(cols), jax_make_mesh(n_devices=4), nonfinite="drop")
    assert (np.asarray(jenc.pk)[:n][dropped] >= 0).all()
    enc = ingest.encode_local_shard_to_mesh(
        chunks(cols), port_mesh(4), nonfinite="drop", dtype=F64)
    np.testing.assert_array_equal(host(enc.pk)[:n], host(serial.pk)[:n])


def test_merge_shards_refuses_mixed_publicity():
    cols = stream(n=200)
    shard = ingest.encode_shard(chunks(cols))
    with pytest.raises(ValueError, match="without public"):
        ingest.merge_shards([shard], PUBLIC, device="cpu")
    with pytest.raises(TypeError):
        ingest.merge_shards([shard])  # the device has no default


# ---------------------------------------------------------------------------
# encode_local_shard_to_mesh


MODES = ("host", "hash_device")


def encode_both(d, mode, source, **kw):
    """(port EncodedData, JAX EncodedData) of one pod ingest."""
    got = ingest.encode_local_shard_to_mesh(
        source(), port_mesh(d), encode_mode=mode, dtype=F64, **kw)
    want = jax_ingest.encode_local_shard_to_mesh(
        source(), jax_make_mesh(n_devices=d), encode_mode=mode, **kw)
    return got, want


def assert_encoded_equal(got, want):
    for name in ("pid", "pk", "values"):
        g = getattr(got, name)
        assert isinstance(g, ShardedColumn)
        np.testing.assert_array_equal(host(g), host(getattr(want, name)))
    np.testing.assert_array_equal(host(got.valid), host(want.valid))
    assert got.n_rows == want.n_rows
    assert list(got.partition_vocab) == list(want.partition_vocab)
    assert got.n_privacy_ids == want.n_privacy_ids
    assert got.public_encoded == want.public_encoded


INGEST_CASES = {
    "private": dict(),
    "public": dict(public_partitions=PUBLIC),
    "drop": dict(nonfinite="drop"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(INGEST_CASES))
def test_encode_local_shard_to_mesh_matches_jax(case, mode):
    """Column by column the JAX package's ingest, and its valid rows the
    serial stream_encode_columns'. Under nonfinite="drop" with private
    partitions the JAX host mode puts dropped rows back
    (test_reference_pod_drop_revalidates_the_row): the port's host mode is
    held to the JAX hash mode there, whose columns it equals."""
    kw = INGEST_CASES[case]
    cols = stream(nonfinite=case == "drop")
    got = ingest.encode_local_shard_to_mesh(
        chunks(cols), port_mesh(4), encode_mode=mode, dtype=F64, **kw)
    want = jax_ingest.encode_local_shard_to_mesh(
        chunks(cols), jax_make_mesh(n_devices=4),
        encode_mode="hash_device" if case == "drop" else mode, **kw)
    assert_encoded_equal(got, want)
    serial = ingest.stream_encode_columns(chunks(cols), device="cpu",
                                          dtype=F64, **kw)
    n = len(cols[0])
    valid = host(got.pk) >= 0
    assert valid.sum() == (host(serial.pk)[:n] >= 0).sum()
    for name in ("pid", "pk", "values"):
        np.testing.assert_array_equal(host(getattr(got, name))[:n],
                                      host(getattr(serial, name))[:n])
    assert list(got.partition_vocab) == list(serial.partition_vocab)


@pytest.mark.parametrize("mode", MODES)
def test_empty_shard_matches_jax(mode):
    got, want = encode_both(4, mode, lambda: [])
    assert_encoded_equal(got, want)
    assert not host(got.valid).any()


@pytest.mark.parametrize("mode", MODES)
def test_simulated_two_process_exchange_matches_jax(mode):
    cols = STREAM
    n = len(cols[0])
    half = n // 2
    payloads = []
    for lo, hi in ((0, half), (half, n)):
        if mode == "host":
            shard = jax_ingest.encode_shard(chunks(cols, lo, hi))
            meta = jax_ingest._ShardMeta(len(shard.pid), shard.pid_vocab,
                                         shard.pk_vocab)
        else:
            meta = jax_ingest._hash_encode_shard(
                iter(chunks(cols, lo, hi)), None, "error").meta
        payloads.append(pickle.dumps(meta))
    port_payloads = [pickle.dumps(_to_port_meta(pickle.loads(p)))
                     for p in payloads]
    got, want = None, None
    got = ingest.encode_local_shard_to_mesh(
        chunks(cols, 0, half), port_mesh(4), encode_mode=mode, dtype=F64,
        exchange=lambda payload: list(port_payloads))
    want = jax_ingest.encode_local_shard_to_mesh(
        chunks(cols, 0, half), jax_make_mesh(n_devices=4), encode_mode=mode,
        exchange=lambda payload: list(payloads))
    assert_encoded_equal(got, want)
    serial = ingest.stream_encode_columns(chunks(cols), device="cpu")
    valid = host(got.pk) >= 0
    np.testing.assert_array_equal(host(got.pid)[valid],
                                  host(serial.pid)[:half])
    assert list(got.partition_vocab) == list(serial.partition_vocab)


def _to_port_meta(meta):
    """A JAX shard meta as the port's (the same fields)."""
    cls = (ingest._ShardMeta if isinstance(meta, jax_ingest._ShardMeta)
           else ingest._HashShardMeta)
    return cls(**vars(meta))


def collide(monkeypatch, module, victim="p1", target="p0"):
    """The primary hash lane of `victim` made `target`'s, the secondary
    lane left apart: the collision the two-lane detector catches (the
    pattern of tests/test_device_encode.py)."""
    orig = module.hash_key_column_pair

    def colliding(raw):
        h0, h1 = orig(raw)
        arr = columnar._as_key_array(raw)
        h0 = h0.copy()
        h0[arr == victim] = orig(np.asarray([target], object))[0][0]
        return h0, h1

    monkeypatch.setattr(module, "hash_key_column_pair", colliding)


def test_collision_falls_back_to_the_host_encoder(monkeypatch):
    cols = STREAM
    collide(monkeypatch, ingest)
    collide(monkeypatch, jax_ingest)
    got, want = encode_both(4, "hash_device", lambda: chunks(cols))
    assert_encoded_equal(got, want)
    assert telemetry.counters["ingest_hash_collisions"] == 1
    host_enc = ingest.encode_local_shard_to_mesh(chunks(cols), port_mesh(4),
                                                 dtype=F64)
    assert_encoded_equal(got, host_enc)
    with pytest.raises(device_encode.HashCollisionError,
                       match="one-shot iterator"):
        ingest.encode_local_shard_to_mesh(
            iter(chunks(cols)), port_mesh(4), encode_mode="hash_device")
    assert telemetry.counters["ingest_hash_collisions"] == 2


@pytest.mark.parametrize("mode", MODES)
def test_ingest_spans_and_the_multi_process_refusal(mode, monkeypatch):
    """The ingest.local_shard and ingest.vocab_exchange spans (the latter
    with the exchanged bytes); without an injected exchange, a second
    process would need the torch.distributed exchange, which raises."""
    from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
    from pipelinedp_tpu_torch.runtime import trace
    trace.enable()
    try:
        ingest.encode_local_shard_to_mesh(chunks(STREAM), port_mesh(2),
                                          encode_mode=mode)
        spans = trace.trace_summary()["spans"]
    finally:
        trace.disable()
        telemetry.reset()
    assert spans["ingest.local_shard"]["count"] == 1
    assert spans["ingest.vocab_exchange"]["count"] == 1
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        ingest.encode_local_shard_to_mesh(chunks(STREAM), port_mesh(2),
                                          encode_mode=mode)


def test_encode_mode_is_validated():
    with pytest.raises(ValueError, match="encode_mode"):
        ingest.encode_local_shard_to_mesh([], port_mesh(2),
                                          encode_mode="gpu")


# ---------------------------------------------------------------------------
# DPEngine over the mesh-ingested columns


N_PARTS = 20
ENGINE_PUBLIC = [f"p{j}" for j in range(N_PARTS)]


def engine_stream():
    rng = np.random.default_rng(7)
    n = 2000
    pids = np.char.add("u", rng.integers(0, 240, n).astype(str))
    pks = np.char.add("p", rng.integers(0, N_PARTS, n).astype(str))
    return pids, pks, rng.integers(0, 6, n).astype(float)


ENGINE = engine_stream()


def run_engine(mod, backend, data, select=False, public=None, eps=20.0):
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    engine = mod.DPEngine(acc, backend)
    ex = mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                            partition_extractor=lambda r: r[1],
                            value_extractor=lambda r: r[2])
    if select:
        res = engine.select_partitions(
            data, mod.SelectPartitionsParams(max_partitions_contributed=3),
            ex)
    else:
        params = mod.AggregateParams(
            metrics=[mod.Metrics.COUNT, mod.Metrics.SUM,
                     mod.Metrics.PRIVACY_ID_COUNT],
            max_partitions_contributed=3, max_contributions_per_partition=2,
            min_value=0.0, max_value=5.0)
        res = engine.aggregate(data, params, ex, public_partitions=public)
    acc.compute_budgets()
    out = list(res)
    return sorted(out) if select else dict(out)


def backends(d, blocked, **kw):
    common = dict(noise_seed=29, **kw)
    if blocked:
        common.update(large_partition_threshold=16, block_partitions=8)
    return (tdp.TorchBackend(device="cpu", dtype=F64, mesh=port_mesh(d),
                             **common),
            pdp.TPUBackend(mesh=jax_make_mesh(n_devices=d), **common))


def assert_release_close(got, want):
    assert set(got) == set(want)
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert abs(g - w) <= 1e-9 * max(1.0, abs(w)), (key, g, w)


ROUTES = [("dense", False), ("blocked", True)]


@pytest.mark.parametrize("route,blocked", ROUTES)
def test_engine_over_the_mesh_ingest_matches_jax(route, blocked):
    """Aggregate (private and public partitions) and selection on the
    port's meshed TorchBackend over its mesh-ingested columns, against
    TPUBackend(mesh=) over the JAX package's, in both encode modes; the
    port's two modes release the same results. The hash-mode release and
    staging run under forbid_row_fetches."""
    d = 4
    src = lambda: chunks(ENGINE)  # noqa: E731
    results = {}
    for mode in MODES:
        port_be, jax_be = backends(d, blocked)
        enc = ingest.encode_local_shard_to_mesh(src(), port_mesh(d),
                                                encode_mode=mode, dtype=F64)
        jenc = jax_ingest.encode_local_shard_to_mesh(
            src(), jax_make_mesh(n_devices=d), encode_mode=mode)
        guard = (reshard.forbid_row_fetches() if mode == "hash_device" else
                 _nullcontext())
        with guard:
            got = run_engine(tdp, port_be, enc)
            got_sel = run_engine(tdp, port_be, enc, select=True)
        want = run_engine(pdp, jax_be, jenc)
        want_sel = run_engine(pdp, jax_be, jenc, select=True)
        assert got, "no partition kept"
        assert_release_close(got, want)
        assert got_sel == want_sel
        results[mode] = (got, got_sel)
    assert results["host"] == results["hash_device"]


@pytest.mark.parametrize("mode", MODES)
def test_public_release_over_the_mesh_ingest_matches_jax(mode):
    d = 4
    port_be, jax_be = backends(d, False)
    enc = ingest.encode_local_shard_to_mesh(
        chunks(ENGINE), port_mesh(d), public_partitions=ENGINE_PUBLIC,
        encode_mode=mode, dtype=F64)
    jenc = jax_ingest.encode_local_shard_to_mesh(
        chunks(ENGINE), jax_make_mesh(n_devices=d),
        public_partitions=ENGINE_PUBLIC, encode_mode=mode)
    got = run_engine(tdp, port_be, enc, public=ENGINE_PUBLIC)
    want = run_engine(pdp, jax_be, jenc, public=ENGINE_PUBLIC)
    assert set(got) == set(ENGINE_PUBLIC)
    assert_release_close(got, want)


@pytest.mark.parametrize("reshard_mode", ["host", "device"])
def test_huge_eps_release_is_the_exact_aggregate(reshard_mode):
    """At epsilon 1e6 on rows inside their bounds, the meshed release over
    the pod ingest is the exact aggregate whichever staging path runs,
    and so is the unmeshed backend's run of the ShardedColumns' global
    rows."""
    rng = np.random.default_rng(5)
    n = 1200
    pids = rng.permutation(n) % 600  # two rows an id
    pks = pids % 7
    vals = rng.integers(0, 5, n).astype(float)
    cols = (pids, pks, vals)
    enc = ingest.encode_local_shard_to_mesh(
        chunks(cols), port_mesh(4), public_partitions=list(range(7)),
        dtype=F64)
    truth_count = np.bincount(pks, minlength=7)
    truth_sum = np.bincount(pks, weights=vals, minlength=7)
    for be in (tdp.TorchBackend(device="cpu", dtype=F64, noise_seed=1,
                                mesh=port_mesh(4), reshard=reshard_mode),
               tdp.TorchBackend(device="cpu", dtype=F64, noise_seed=1)):
        got = run_engine(tdp, be, enc, public=list(range(7)), eps=1e6)
        for p in range(7):
            assert abs(got[p].count - truth_count[p]) < 1e-3
            assert abs(got[p].sum - truth_sum[p]) < 1e-3


def test_pad_rows_of_sharded_columns_is_the_jax_global_order():
    """pad_rows pads the global order to the row bucket and splits it
    evenly again: row for row the JAX package's padded global array."""
    cols = stream(n=1100)
    for d in (3, 4):
        got = ingest.encode_local_shard_to_mesh(chunks(cols), port_mesh(d),
                                                dtype=F64)
        want = jax_ingest.encode_local_shard_to_mesh(
            chunks(cols), jax_make_mesh(n_devices=d))
        for g, w in zip(executor.pad_rows(got),
                        jax_executor_pad_rows(want)):
            assert isinstance(g, ShardedColumn)
            assert len(g) == len(w)
            np.testing.assert_array_equal(host(g), np.asarray(w))
            assert len({t.shape for t in g.shards}) == 1


def jax_executor_pad_rows(encoded):
    from pipelinedp_tpu import executor as jax_executor
    return jax_executor.pad_rows(encoded)


class _nullcontext:

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
