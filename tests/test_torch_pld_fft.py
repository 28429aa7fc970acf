"""C15 pld_fft's arithmetic on the CPU: the step-by-step PyTorch model of
the kernel (kernels.pld_rfft_four_step / pld_irfft_four_step, the plan of
kernels.pld_fft_plan) against numpy's FFT, the plan's limits and the
wrappers' shape errors.

Bounds stated here:
  * rfft: the model within 1e-12 of np.fft.rfft on rows that sum to 1 (as
    a PLD's pmf rows do, so every bin is at most 1 in magnitude), at every
    power of two L from 2 to 2^21 (the compose path's widest), 1-3 rows;
    also under plans other than the default (three passes, uneven
    factors), where each pass's twiddles and transposition differ.
  * irfft: the model's round trip (irfft of the model's rfft) within 1e-14
    of the input, and the model's irfft within 1e-14 of np.fft.irfft of
    the same spectrum.
  * The default plan: factors are powers of two of at most 2048 whose
    product is n, one pass up to n = 2048, two up to 2^22.
The kernel itself runs on the card only; chip_smoke.py holds it against
this model within 1e-13 and against torch.fft within 1e-12.
"""

import numpy as np
import pytest
import torch

from pipelinedp_tpu.accounting import compose as jax_compose
from pipelinedp_tpu_torch import kernels

pytestmark = pytest.mark.torch_port

LOGS = list(range(1, 22))


def pmf_rows(rows, length, seed):
    x = np.random.default_rng(seed).random((rows, length))
    return x / x.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("log_l", LOGS)
def test_rfft_model_matches_numpy(log_l, rows):
    x = pmf_rows(rows, 1 << log_l, seed=log_l * 10 + rows)
    got = kernels.pld_rfft_four_step(torch.from_numpy(x))
    assert got.shape == (rows, (1 << log_l) // 2 + 1)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.fft.rfft(x, axis=1), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("log_l", LOGS)
def test_irfft_model_round_trip(log_l, rows):
    length = 1 << log_l
    x = pmf_rows(rows, length, seed=log_l * 10 + rows + 5)
    spec = kernels.pld_rfft_four_step(torch.from_numpy(x))
    back = kernels.pld_irfft_four_step(spec, length)
    assert back.shape == (rows, length) and back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        back.numpy(), np.fft.irfft(spec.numpy(), n=length, axis=1), rtol=0,
        atol=1e-14)


@pytest.mark.parametrize("log_n,plan", [
    (13, (4, 32, 64)), (13, (2, 2, 2048)), (13, (2048, 2, 2)),
    (12, (16, 256)), (12, (256, 16)), (10, (2, 512)), (9, (512,)),
    (3, (2, 2, 2)),
])
def test_model_under_other_plans(log_n, plan):
    """Three passes, uneven and radix-2 factors: each plan transforms the
    same rows to the same spectrum."""
    length = 2 << log_n
    x = pmf_rows(2, length, seed=log_n)
    spec = kernels.pld_rfft_four_step(torch.from_numpy(x), plan)
    np.testing.assert_allclose(spec.numpy(), np.fft.rfft(x, axis=1), rtol=0,
                               atol=1e-12)
    back = kernels.pld_irfft_four_step(spec, length, plan)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-14)


def test_model_matches_the_reference_composition():
    """The JAX package's K18 transform pair, jnp.fft.rfft and irfft on the
    CPU, on the same padded rows: the model's spectrum and its inverse
    agree with them."""
    import jax.numpy as jnp
    x = pmf_rows(3, 1 << 12, seed=7)
    want = np.asarray(jnp.fft.rfft(jnp.asarray(x), axis=1))
    got = kernels.pld_rfft_four_step(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        kernels.pld_irfft_four_step(got, 1 << 12).numpy(),
        np.asarray(jnp.fft.irfft(jnp.asarray(want), n=1 << 12, axis=1)),
        rtol=0, atol=1e-14)
    assert jax_compose._next_fast_len(3000) == 1 << 12


@pytest.mark.parametrize("log_n", range(0, 34))
def test_plan_limits(log_n):
    n = 1 << log_n
    plan = kernels.pld_fft_plan(n)
    assert int(np.prod(plan, dtype=np.int64)) == n
    assert all(f >= 2 and f <= 2048 and f & (f - 1) == 0 for f in plan)
    assert list(plan) == sorted(plan, reverse=True)
    if n == 1:
        assert plan == ()
    elif n <= 2048:
        assert plan == (n,)
    elif n <= 1 << 22:
        assert len(plan) == 2
    else:
        assert len(plan) == 3
    # As even as they can be: no two factors more than 2x apart.
    assert not plan or max(plan) <= 2 * min(plan)


@pytest.mark.parametrize("n", [0, 3, 6, 1000, 1 << 34])
def test_plan_refuses(n):
    with pytest.raises(ValueError):
        kernels.pld_fft_plan(n)


def test_model_refuses_a_wrong_plan():
    x = torch.from_numpy(pmf_rows(1, 64, seed=1))
    with pytest.raises(ValueError):
        kernels.pld_rfft_four_step(x, (4, 4))
    with pytest.raises(ValueError):
        kernels.pld_irfft_four_step(kernels.pld_rfft_four_step(x), 64,
                                    (2, 4))


@pytest.mark.parametrize("bad", [
    torch.zeros(2, 8, dtype=torch.float32),      # not float64
    torch.zeros(8, dtype=torch.float64),         # not 2-D
    torch.zeros(8, 2, dtype=torch.float64).t(),  # not contiguous
    torch.zeros(0, 8, dtype=torch.float64),      # no rows
    torch.zeros(65536, 2, dtype=torch.float64),  # too many rows
    torch.zeros(2, 12, dtype=torch.float64),     # not a power of two
    torch.zeros(2, 1, dtype=torch.float64),      # shorter than 2
])
def test_rfft_wrapper_refuses(bad):
    with pytest.raises(ValueError):
        kernels.pld_rfft(bad)


@pytest.mark.parametrize("bins,length,dtype", [
    (5, 8, torch.complex64),    # not complex128
    (4, 8, torch.complex128),   # 4 bins for length 8 (5 expected)
    (5, 10, torch.complex128),  # length not a power of two
    (2, 1, torch.complex128),   # length shorter than 2
])
def test_irfft_wrapper_refuses(bins, length, dtype):
    with pytest.raises(ValueError):
        kernels.pld_irfft(torch.zeros(2, bins, dtype=dtype), length)


def test_wrappers_on_the_cpu_are_the_plain_versions():
    x = torch.from_numpy(pmf_rows(3, 256, seed=3))
    before = kernels.launch_counts["pld_fft"]
    spec = kernels.pld_rfft(x)
    assert torch.equal(spec, kernels.pld_rfft_plain(x))
    assert torch.equal(kernels.pld_irfft(spec, 256),
                       kernels.pld_irfft_plain(spec, 256))
    assert kernels.launch_counts["pld_fft"] == before
