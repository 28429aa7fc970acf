"""The port's device mesh (parallel/mesh.py, parallel/collectives.py,
parallel/sharded.shard_rows_by_pid) and C21 combine_shards' plain version,
held against the JAX package's mesh on its 8 CPU devices.

Bounds stated here:
  * round_capacity, rows_per_shard and shard_rows_by_pid: equal (==) to
    the JAX package's;
  * C21's plain entry on int32 / int64 stacks: equal to lax.psum over a
    shard_map of the same D devices (int32 wrapping alike);
  * C21's compensated entry (float32): equal bit for bit to
    segment_ops.compensated_psum under shard_map, and to
    associative_scan(_comp_combine) over the stack, for D in
    {1, 2, 3, 5, 8};
  * C21's plain entry on float64 stacks: the port adds in shard order,
    XLA's CPU all-reduce in its own; integer-valued sums are equal, and
    any sum within D - 1 float64 rounding steps of the largest partial
    magnitude (D * 2^-52 * max|partial|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pipelinedp_tpu.ops import segment_ops as jax_segment_ops
from pipelinedp_tpu.parallel import mesh as jax_mesh
from pipelinedp_tpu.parallel import sharded as jax_sharded
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import collectives
from pipelinedp_tpu_torch.parallel import mesh
from pipelinedp_tpu_torch.parallel import sharded

pytestmark = pytest.mark.torch_port

SHARD_COUNTS = (1, 2, 3, 5, 8)


def jax_psum(stack: np.ndarray, compensated: bool = False) -> np.ndarray:
    """The JAX package's cross-shard sum of stack[s] held by shard s, on a
    mesh of D = len(stack) of the 8 CPU devices."""
    d = stack.shape[0]
    jmesh = jax_mesh.make_mesh(n_devices=d)

    def per_shard(x):
        x = x[0]
        if compensated:
            return jax_segment_ops.compensated_psum(x, jax_mesh.SHARD_AXIS)
        return jax.lax.psum(x, jax_mesh.SHARD_AXIS)

    fn = jax_mesh.shard_map(per_shard, mesh=jmesh,
                            in_specs=P(jax_mesh.SHARD_AXIS), out_specs=P())
    return np.asarray(fn(jnp.asarray(stack)))


@jax.jit
def jax_scan_total(stack):
    """hi[-1] + lo[-1] of associative_scan(_comp_combine) over the shards."""
    hi, lo = jax.lax.associative_scan(jax_segment_ops._comp_combine,
                                      (stack, jnp.zeros_like(stack)), axis=0)
    return hi[-1] + lo[-1]


# ---------------------------------------------------------------------------
# The mesh


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 8, 16])
def test_capacities_equal_jax(n_shards):
    for x in list(range(0, 300)) + [1000, 4095, 4096, 4097, 17_770,
                                    (1 << 20) + 1, 1 << 24]:
        assert mesh.round_capacity(x) == jax_mesh.round_capacity(x)
        assert mesh.rows_per_shard(x, n_shards) == \
            jax_mesh.rows_per_shard(x, n_shards)


def test_make_mesh_needs_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(n_devices=2)


def test_mesh_slots():
    m = mesh.make_mesh(["cpu"] * 8, n_devices=4)
    assert m.size == 4 and m.device == torch.device("cpu")
    assert m == mesh.Mesh([torch.device("cpu")] * 4)
    assert hash(m) == hash(mesh.Mesh(["cpu"] * 4))
    assert mesh.is_fully_addressable(m)
    assert mesh.process_index() == 0 and mesh.process_count() == 1
    assert mesh.local_devices(m) == list(m.devices)
    with pytest.raises(ValueError, match="1 to 32"):
        mesh.Mesh([])
    with pytest.raises(ValueError, match="1 to 32"):
        mesh.Mesh(["cpu"] * 33)
    with pytest.raises(ValueError, match="all be cuda or all cpu"):
        mesh.Mesh(["cpu", "meta"])


def test_host_fetch_is_a_host_copy():
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    got = mesh.host_fetch(t)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, t.numpy())
    assert not getattr(mesh._sanctioned_fetch, "active", False)


# ---------------------------------------------------------------------------
# The host LPT permutation


def lpt_inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pid = rng.integers(0, 500, 4000)
    elif kind == "skewed":
        counts = rng.zipf(1.5, 2000) % 500 + 1
        pid = np.repeat(np.arange(2000), counts)
        pid = pid[rng.permutation(len(pid))]
    elif kind == "one_pid":
        pid = np.zeros(37, dtype=np.int64)
    elif kind == "dominant":
        pid = np.concatenate([np.zeros(7000, np.int64),
                              np.arange(1, 7001)])
    elif kind == "many_ids":  # past the greedy head: a serpentine tail
        pid = rng.integers(0, 9000, 30000)
    elif kind == "sparse_ids":  # negative and far-apart ids: np.unique
        pid = rng.choice(np.array([-2**31, -5, 0, 7, 2**31 - 1]), 3000)
    else:
        raise ValueError(kind)
    pid = pid.astype(np.int32)
    n = len(pid)
    pk = rng.integers(0, 16, n).astype(np.int32)
    values = rng.uniform(0, 5, (n, 3))
    valid = rng.uniform(size=n) < 0.9
    return pid, pk, values, valid


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_pid", "dominant",
                                  "many_ids", "sparse_ids"])
def test_shard_rows_by_pid_equals_jax(kind, n_shards):
    pid, pk, values, valid = lpt_inputs(kind)
    got = sharded.shard_rows_by_pid(pid, pk, values, valid, n_shards)
    want = jax_sharded.shard_rows_by_pid(pid, pk, values, valid, n_shards)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# C21 combine_shards (plain)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_combine_integers_equals_psum(n_shards, dtype):
    rng = np.random.default_rng(n_shards)
    info = np.iinfo(dtype)
    # Large magnitudes: int32 sums wrap, as XLA's do.
    stack = rng.integers(info.min // 2, info.max // 2, (n_shards, 257),
                         dtype=dtype)
    got = kernels.combine_shards(torch.from_numpy(stack))
    np.testing.assert_array_equal(got.numpy(), jax_psum(stack))


def adversarial_f32(n_shards: int, seed: int) -> np.ndarray:
    """float32 partials where the fold order matters: a 2^24-scale head
    with unit tails, cancelling pairs and ragged magnitudes."""
    rng = np.random.default_rng(seed)
    m = 512
    stack = (rng.standard_normal((n_shards, m)) *
             10.0**rng.integers(-3, 8, (n_shards, m))).astype(np.float32)
    stack[0, :64] = 2.0**24
    stack[1 % n_shards, :64] += 1.0
    stack[:, 64:128] = rng.integers(0, 60000, (n_shards, 64))
    stack[-1, 128:192] = -stack[0, 128:192]
    return stack


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_compensated_combine_is_the_jax_fold_bit_for_bit(n_shards):
    stack = adversarial_f32(n_shards, 7 + n_shards)
    got = kernels.combine_shards(torch.from_numpy(stack),
                                 compensated=True).numpy()
    scan = np.asarray(jax_scan_total(jnp.asarray(stack)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), scan.view(np.uint32))
    np.testing.assert_array_equal(
        got.view(np.uint32),
        jax_psum(stack, compensated=True).view(np.uint32))


def test_compensated_combine_recovers_the_exact_sum():
    stack = np.zeros((5, 4), np.float32)
    stack[0] = 2.0**24
    stack[1:] = 1.0
    plain = kernels.combine_shards(torch.from_numpy(stack)).numpy()
    comp = kernels.combine_shards(torch.from_numpy(stack),
                                  compensated=True).numpy()
    assert (plain == np.float32(2.0**24)).all()  # each +1 rounds away
    assert (comp == np.float32(2.0**24 + 4)).all()


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_combine_float64_within_the_stated_bound(n_shards):
    rng = np.random.default_rng(50 + n_shards)
    stack = rng.uniform(-1e6, 1e6, (n_shards, 300))
    stack[:, :100] = np.round(stack[:, :100])  # integer-valued partials
    got = kernels.combine_shards(torch.from_numpy(stack)).numpy()
    want = jax_psum(stack)
    np.testing.assert_array_equal(got[:100], want[:100])
    bound = n_shards * 2.0**-52 * np.abs(stack).max(axis=0)
    assert (np.abs(got - want) <= bound).all()


def test_combine_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="contiguous"):
        kernels.combine_shards(torch.zeros(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.combine_shards(torch.zeros((2, 3), dtype=torch.int16))
    with pytest.raises(ValueError, match="compensated entry takes float32"):
        kernels.combine_shards(torch.zeros((2, 3), dtype=torch.float64),
                               compensated=True)


# ---------------------------------------------------------------------------
# collectives


def test_psum_columns_sums_every_column_in_its_shape():
    rng = np.random.default_rng(3)
    parts = [{"count": torch.as_tensor(rng.integers(0, 9, 7),
                                       dtype=torch.float64),
              "vsum": torch.as_tensor(rng.uniform(size=(7, 3)))}
             for _ in range(4)]
    got = collectives.psum_columns(parts, torch.device("cpu"))
    for name in ("count", "vsum"):
        want = parts[0][name].clone()
        for p in parts[1:]:
            want = want + p[name]
        assert got[name].shape == want.shape
        assert torch.equal(got[name], want)


def test_gather_stacks_on_the_device():
    parts = [torch.full((3,), float(s)) for s in range(5)]
    stack = collectives.gather(parts, torch.device("cpu"))
    assert stack.shape == (5, 3)
    assert torch.equal(stack[:, 0], torch.arange(5, dtype=torch.float32))


def test_all_to_all_copies_each_slice():
    dst = torch.zeros(6, dtype=torch.int32)
    collectives.all_to_all([(dst[1:3], torch.tensor([4, 5],
                                                    dtype=torch.int32)),
                            (dst[4:5], torch.tensor([9], dtype=torch.int32))])
    assert dst.tolist() == [0, 4, 5, 0, 9, 0]
