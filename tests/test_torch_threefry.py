"""The port's threefry RNG against jax.random (pipelinedp_tpu_torch/ops/
threefry.py).

Bounds stated here:
  * split, fold_in, bits and uniform (float32 and float64, with and
    without a [minval, maxval) range): bit-identical.
  * normal and laplace: the random words and the uniforms are identical;
    the transforms differ only in log1p. XLA's CPU log1p is its own
    approximation (up to 129 ulp from glibc's in float64 near -0.45), so
    float64 laplace stays within 256 ulp and normal within 64 ulp; float32
    within 4 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu.ops import noise as jax_noise
from pipelinedp_tpu_torch.ops import noise as torch_noise
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

KEYS = [np.array([0, 0], np.uint32), np.array([0, 42], np.uint32),
        np.array([0xDEADBEEF, 0x12345678], np.uint32),
        np.array([0xFFFFFFFF, 1], np.uint32)]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def ulp_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Max distance in units in the last place (same-sign ordering)."""
    ints = np.int64 if a.dtype == np.float64 else np.int32
    ai = a.view(ints).astype(np.int64)
    bi = b.view(ints).astype(np.int64)
    lo = np.iinfo(ints).min
    ai = np.where(ai < 0, lo - ai, ai)
    bi = np.where(bi < 0, lo - bi, bi)
    return int(np.abs(ai - bi).max()) if ai.size else 0


@pytest.mark.parametrize("key_idx", range(len(KEYS)))
def test_split_fold_in_bits_are_bit_identical(key_idx):
    key = KEYS[key_idx]
    for num in (2, 3, 5):
        np.testing.assert_array_equal(threefry.split(key, num),
                                      np.asarray(jax.random.split(key, num)))
    for data in (0, 1, 7, 7919, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            threefry.fold_in(key, data),
            np.asarray(jax.random.fold_in(key, data)))
    for n in (1, 4, 33):
        np.testing.assert_array_equal(
            threefry.bits(key, n),
            np.asarray(jax.random.bits(key, (n,), jnp.uint32)))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_uniform_is_bit_identical(jdt, tdt, n):
    for key in KEYS:
        want = np.asarray(jax.random.uniform(key, (n,), jdt))
        got = threefry.uniform(key, n, tdt).numpy()
        np.testing.assert_array_equal(got, want)
        lo = threefry.open_interval_low(tdt)
        want = np.asarray(jax.random.uniform(key, (n,), jdt, lo, 1.0))
        got = threefry.uniform(key, n, tdt, lo, 1.0).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "f64"])
def test_normal_and_laplace_within_ulp_bound(jdt, tdt):
    normal_bound, laplace_bound = ((4, 4) if tdt == torch.float32 else
                                   (64, 256))
    n = 10000
    for key in KEYS:
        for sub in range(2):
            k = threefry.fold_in(key, sub)
            want = np.asarray(jax.random.normal(k, (n,), jdt))
            got = threefry.normal(k, n, tdt).numpy()
            assert ulp_distance(got, want) <= normal_bound
            want = np.asarray(jax.random.laplace(k, (n,), jdt))
            got = threefry.laplace(k, n, tdt).numpy()
            assert ulp_distance(got, want) <= laplace_bound
            assert np.all(np.isfinite(got))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "f64"])
def test_erf_inv_follows_xla_polynomial(jdt, tdt):
    # Both branches of each polynomial (w = -log1p(-x^2) below and above
    # 5 in float32; 6.25 and 16 in float64) and the +-1 edge.
    x = np.concatenate([np.linspace(-0.999999, 0.999999, 4001),
                        1 - np.logspace(-15, -1, 60), [-1.0, 1.0, 0.0]])
    x = x.astype(np.float32 if tdt == torch.float32 else np.float64)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = threefry.erf_inv(torch.as_tensor(x)).numpy()
    assert ulp_distance(got, want) <= (4 if tdt == torch.float32 else 64)


def test_make_noise_key_matches_jax():
    for seed in (0, 1, 42, (1 << 40) + 3):
        np.testing.assert_array_equal(torch_noise.make_noise_key(seed),
                                      jax_noise.make_noise_key(seed))
        np.testing.assert_array_equal(
            torch_noise.make_noise_key(seed),
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
