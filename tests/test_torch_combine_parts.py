"""C21's multi-part entry, kernels.combine_parts, on the CPU (its plain
version), and the collectives that call it, held against the JAX
package's cross-shard sums on its 8 CPU devices.

Each case splits the shards' partials into ragged columns of mixed shapes
([P] and [P, V]); the JAX package sums the same values as one stack (its
sums are element by element, so the split does not change them). Bounds
stated here:
  * int32 (wrapping) and int64: equal (==) to lax.psum over a shard_map
    of the same D devices;
  * compensated float32: equal bit for bit to
    segment_ops.compensated_psum under shard_map;
  * float64: the port adds in shard order, XLA's CPU all-reduce in its
    own; integer-valued sums are equal, any sum within D * 2^-52 of the
    largest partial magnitude;
  * collectives.psum_columns / psum: the same columns, shapes and bits as
    the concatenate-stack-slice form they replace.
"""

import numpy as np
import pytest
import torch

from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import collectives
from test_torch_mesh import SHARD_COUNTS, adversarial_f32, jax_psum

pytestmark = pytest.mark.torch_port

# Ragged column shapes (trailing widths V), 512 values a shard in all.
SHAPES = ((17,), (1,), (0,), (40, 3), (2, 5), (1, 1), (363,))


def split_columns(stack: np.ndarray):
    """parts[s][c]: shard s's row of the [D, 512] stack cut into SHAPES."""
    parts, at = [], 0
    bounds = []
    for shape in SHAPES:
        size = int(np.prod(shape))
        bounds.append((at, at + size, shape))
        at += size
    assert at == stack.shape[1]
    for row in stack:
        parts.append([torch.from_numpy(np.ascontiguousarray(
            row[a:b]).reshape(shape)) for a, b, shape in bounds])
    return parts, bounds


def assert_columns(got, want_flat, bounds, bits=False):
    assert len(got) == len(bounds)
    for col, (a, b, shape) in zip(got, bounds):
        assert tuple(col.shape) == shape
        want = want_flat[a:b].reshape(shape)
        if bits:
            np.testing.assert_array_equal(
                col.numpy().view(np.uint32), want.view(np.uint32))
        else:
            np.testing.assert_array_equal(col.numpy(), want)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_integer_parts_equal_psum(n_shards, dtype):
    rng = np.random.default_rng(200 + n_shards)
    info = np.iinfo(dtype)
    # Large magnitudes: int32 sums wrap, as XLA's do.
    stack = rng.integers(info.min // 2, info.max // 2, (n_shards, 512),
                         dtype=dtype)
    parts, bounds = split_columns(stack)
    got = kernels.combine_parts(parts)
    assert all(c.dtype == parts[0][0].dtype for c in got)
    assert_columns(got, jax_psum(stack), bounds)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_compensated_parts_are_the_jax_fold_bit_for_bit(n_shards):
    stack = adversarial_f32(n_shards, 300 + n_shards)
    parts, bounds = split_columns(stack)
    got = kernels.combine_parts(parts, compensated=True)
    assert_columns(got, jax_psum(stack, compensated=True), bounds,
                   bits=True)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_float64_parts_within_the_stated_bound(n_shards):
    rng = np.random.default_rng(400 + n_shards)
    stack = rng.uniform(-1e6, 1e6, (n_shards, 512))
    stack[:, ::3] = np.round(stack[:, ::3])  # integer-valued partials
    parts, bounds = split_columns(stack)
    got = kernels.combine_parts(parts)
    flat = np.concatenate([c.numpy().reshape(-1) for c in got])
    want = jax_psum(stack)
    np.testing.assert_array_equal(flat[::3], want[::3])
    bound = n_shards * 2.0**-52 * np.abs(stack).max(axis=0)
    assert (np.abs(flat - want) <= bound).all()


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_parts_equal_the_stack_entry_column_by_column(n_shards):
    stack = adversarial_f32(n_shards, 500 + n_shards)
    parts, bounds = split_columns(stack)
    for compensated in (False, True):
        got = kernels.combine_parts(parts, compensated)
        want = kernels.combine_shards(torch.from_numpy(stack),
                                      compensated).numpy()
        assert_columns(got, want, bounds, bits=True)


def stacked_psum_columns(parts, compensated=False):
    """psum_columns as the port computed it before combine_parts: each
    shard's columns concatenated, the shards stacked, one combine_shards,
    the total sliced back into the columns' shapes."""
    names = list(parts[0])
    flat = torch.stack([torch.cat([cols[k].reshape(-1) for k in names])
                        for cols in parts])
    compensated = compensated and flat.dtype == torch.float32
    total = kernels.combine_shards(flat, compensated)
    out, start = {}, 0
    for k in names:
        size = parts[0][k].numel()
        out[k] = total[start:start + size].reshape(parts[0][k].shape)
        start += size
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
@pytest.mark.parametrize("dtype,compensated", [
    (np.float32, False), (np.float32, True), (np.float64, True),
    (np.int32, False), (np.int64, False)])
def test_psum_columns_keeps_its_columns_shapes_and_bits(n_shards, dtype,
                                                        compensated):
    stack = adversarial_f32(n_shards, 600 + n_shards)
    if np.issubdtype(dtype, np.integer):
        stack = np.round(stack / 1e3)
    stack = stack.astype(dtype)
    cols, _ = split_columns(stack)
    names = ("count", "pid_count", "empty", "vsum", "w", "one", "sum")
    parts = [dict(zip(names, c)) for c in cols]
    got = collectives.psum_columns(parts, torch.device("cpu"), compensated)
    want = stacked_psum_columns(parts, compensated)
    assert list(got) == list(names)
    for k in names:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        assert torch.equal(got[k].view(-1).view(torch.uint8),
                           want[k].view(-1).view(torch.uint8))


def test_psum_of_one_tensor_a_shard():
    rng = np.random.default_rng(7)
    parts = [torch.as_tensor(rng.integers(0, 9, (6, 4)), dtype=torch.int32)
             for _ in range(3)]
    got = collectives.psum(parts, torch.device("cpu"))
    assert got.shape == (6, 4) and got.dtype == torch.int32
    assert torch.equal(got, parts[0] + parts[1] + parts[2])
    assert collectives.psum_columns([{}, {}], torch.device("cpu")) == {}


def test_combine_parts_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="1 to 64 shards"):
        kernels.combine_parts([[a]] * 65)
    with pytest.raises(ValueError, match="1 to 64 shards"):
        kernels.combine_parts([])
    with pytest.raises(ValueError, match=r"part \(1, 0\)"):
        kernels.combine_parts([[a], [a.double()]])  # mixed dtypes
    with pytest.raises(ValueError, match=r"part \(1, 0\)"):
        kernels.combine_parts([[a], [torch.zeros(4, device="meta")]])
    with pytest.raises(ValueError, match=r"part \(0, 1\)"):
        kernels.combine_parts([[a, torch.zeros(8)[::2]], [a, a]])
    with pytest.raises(ValueError, match=r"part \(1, 0\)"):
        kernels.combine_parts([[a], [torch.zeros(5)]])  # shapes differ
    with pytest.raises(ValueError, match="shard 1 has 2 columns"):
        kernels.combine_parts([[a], [a, a]])
    with pytest.raises(ValueError, match="int32, int64, float32 or float64"):
        kernels.combine_parts([[torch.zeros(4, dtype=torch.int16)]])
    with pytest.raises(ValueError, match="compensated entry takes float32"):
        kernels.combine_parts([[a.double()]], compensated=True)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kernels.combine_parts([[meta], [meta]])
    assert kernels.combine_parts([[], []]) == []
