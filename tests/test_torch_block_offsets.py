"""C10 block_offsets' entries on the CPU (their plain versions), held
against the JAX package's searchsorted over its block arithmetic.

Bounds stated here: every offset is equal (==) to jnp.searchsorted(stream,
boundaries, side="left") with the boundaries of
pipelinedp_tpu/parallel/large_p._block_boundaries clamped to `end`
(np.minimum), as the JAX package's drivers take them; the meshed table
equals the JAX package's _sharded_block_offsets (tests/
test_torch_large_p_mesh.py), and here each stream's own search, in shard
order, whatever the grouping of the shards by device.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu.parallel import large_p as jax_large_p
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import large_p

pytestmark = pytest.mark.torch_port

INT32_MAX = np.iinfo(np.int32).max


def sorted_stream(rng, n, high):
    return np.sort(rng.integers(0, high, n)).astype(np.int32)


def jax_windows(stream, base, capacity, n_blocks, end):
    bounds = np.minimum(jax_large_p._block_boundaries(base, capacity,
                                                      n_blocks), end)
    return np.asarray(jnp.searchsorted(jnp.asarray(stream),
                                       jnp.asarray(bounds), side="left"))


def check_windows(streams, base, capacity, n_blocks, end):
    got = kernels.block_window_offsets(
        [torch.from_numpy(s) for s in streams], base, capacity, n_blocks,
        end)
    assert got.dtype == torch.int64
    assert tuple(got.shape) == (len(streams), n_blocks + 1)
    for row, stream in zip(got.numpy(), streams):
        np.testing.assert_array_equal(
            row, jax_windows(stream, base, capacity, n_blocks, end))
    return got


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_blocks", [0, 1, 3, 7])
def test_one_stream(seed, n_blocks):
    rng = np.random.default_rng(seed)
    P = 40
    stream = sorted_stream(rng, 300, P + 1)  # rows at P: the sentinel
    check_windows([stream], 0, 8, n_blocks, P)


@pytest.mark.parametrize("base,capacity", [(0, 4), (4, 4), (8, 16), (3, 5)])
def test_three_streams_of_different_lengths(base, capacity):
    rng = np.random.default_rng(base * 31 + capacity)
    P = 37
    streams = [sorted_stream(rng, n, P + 1) for n in (1, 129, 1000)]
    check_windows(streams, base, capacity, 9, P)


def test_an_empty_stream():
    rng = np.random.default_rng(5)
    streams = [np.zeros(0, np.int32), sorted_stream(rng, 50, 21)]
    got = check_windows(streams, 0, 4, 5, 20)
    assert not got[0].any()


def test_every_row_at_the_sentinel():
    P = 24
    got = check_windows([np.full(77, P, np.int32)], 0, 8, 3, P)
    assert not got.any()  # no row lies in any window


def test_end_below_the_last_boundary():
    rng = np.random.default_rng(6)
    P = 19
    stream = sorted_stream(rng, 400, P + 1)
    got = check_windows([stream], 0, 8, 3, P)  # boundaries 0, 8, 16, 19
    assert int(got[0, -1]) == int((stream < P).sum())


def test_a_boundary_clamped_at_int32_max():
    stream = np.array([0, 5, INT32_MAX - 1, INT32_MAX, INT32_MAX],
                      np.int32)
    base = INT32_MAX - 10
    got = check_windows([stream], base, 8, 3, INT32_MAX)
    np.testing.assert_array_equal(got[0].numpy(), [2, 2, 3, 3])


@pytest.mark.parametrize("value", [-1, 0, 1, 2])
def test_a_stream_of_one_row(value):
    check_windows([np.array([max(value, 0)], np.int32)], value, 1, 3, 3)


@pytest.mark.parametrize("seed", range(3))
def test_block_offsets_at_the_sweep_partition_starts(seed):
    # analysis/kernels.py's P + 1 boundaries arange(P + 1), dense and
    # sparse partitions.
    rng = np.random.default_rng(100 + seed)
    P = int(rng.integers(1, 60))
    stream = sorted_stream(rng, int(rng.integers(0, 500)), P)
    bounds = np.arange(P + 1, dtype=np.int32)
    got = kernels.block_offsets(torch.from_numpy(stream),
                                torch.from_numpy(bounds))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.searchsorted(
            jnp.asarray(stream), jnp.asarray(bounds), side="left")))


def test_offsets_take_the_window_entry():
    rng = np.random.default_rng(8)
    P = 30
    stream = sorted_stream(rng, 200, P + 1)
    s = types.SimpleNamespace(skey2=torch.from_numpy(stream))
    got = large_p._offsets(s, 8, 8, 3, P)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_windows(stream, 8, 8, 3, P))


def test_sharded_offsets_keep_shard_order_across_device_groups(monkeypatch):
    # Slots alternating between two device keys: one launch a key, the
    # table put back in shard order.
    rng = np.random.default_rng(9)
    P = 33
    streams = [sorted_stream(rng, n, P + 1) for n in (40, 0, 250, 7, 90)]
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    mesh = types.SimpleNamespace(devices=(cpu, cpu0, cpu, cpu0, cpu),
                                 device=cpu)
    calls = []
    original = kernels.block_window_offsets

    def spy(streams_, *args):
        calls.append(len(streams_))
        return original(streams_, *args)

    monkeypatch.setattr(kernels, "block_window_offsets", spy)
    got = large_p._sharded_block_offsets(
        mesh, [types.SimpleNamespace(skey2=torch.from_numpy(s))
               for s in streams], 4, 8, 4, P)
    assert sorted(calls) == [2, 3]
    assert got.dtype == np.int64 and got.shape == (5, 5)
    for row, stream in zip(got, streams):
        np.testing.assert_array_equal(row, jax_windows(stream, 4, 8, 4, P))


def test_the_wrappers_reject_what_the_kernel_does_not_take():
    ok = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kernels.block_window_offsets([ok, ok.long()], 0, 4, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.block_window_offsets([torch.zeros(8, dtype=torch.int32)[::2]],
                                     0, 4, 2, 8)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.block_window_offsets(
            [ok, torch.zeros(4, dtype=torch.int32, device="meta")], 0, 4, 2,
            8)
    with pytest.raises(ValueError, match="streams"):
        kernels.block_window_offsets([ok] * 65, 0, 4, 2, 8)
    with pytest.raises(ValueError, match="streams"):
        kernels.block_window_offsets([], 0, 4, 2, 8)
    with pytest.raises(ValueError, match="n_blocks"):
        kernels.block_window_offsets([ok], 0, 4, -1, 8)
    with pytest.raises(ValueError, match="boundaries"):
        kernels.block_offsets(ok, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="one device"):
        kernels.block_offsets(
            ok, torch.zeros(2, dtype=torch.int32, device="meta"))
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kernels.block_offsets(meta, meta)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kernels.block_window_offsets([meta], 0, 4, 2, 8)
