"""The port's PLD accounting (pipelinedp_tpu_torch/accounting/) against the
JAX package's (pipelinedp_tpu/accounting/), on the CPU.

Bounds stated here:
  * pld.py: pmfs, lower indices, infinity masses and every epsilon / delta
    query are bit-equal (the same numpy and scipy arithmetic, longdouble
    suffix sums included).
  * compose_plds on the host: bit-equal to the JAX package's host path.
  * compose_plds(device="cpu") (the plain versions of C15 pld_fft and C16
    log_spectrum): every composed probability within 1e-9 of the JAX
    package's _compose_pmfs_device and of the host path, and epsilon at
    delta = 1e-6 within 1e-9 (tests/test_pld_compose.py's gate).
"""

import math

import numpy as np
import pytest
import torch

from pipelinedp_tpu import input_validators as jax_validators
from pipelinedp_tpu.accounting import compose as jax_compose
from pipelinedp_tpu.accounting import pld as jax_pld
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.accounting import compose
from pipelinedp_tpu_torch.accounting import pld

pytestmark = pytest.mark.torch_port

_D = 1e-3

# (constructor, args) of both packages' from_* functions.
MECHANISMS = [
    ("from_gaussian_mechanism", (1.0, _D)),
    ("from_gaussian_mechanism", (4.0, _D)),
    ("from_gaussian_mechanism", (0.01, _D)),  # past the finite-loss cap
    ("from_gaussian_mechanism", (0.5, _D, 2.0)),
    ("from_laplace_mechanism", (1.0, _D)),
    ("from_laplace_mechanism", (0.5, _D)),
    ("from_laplace_mechanism", (0.005, _D)),  # past the finite-loss cap
    ("from_privacy_parameters", (0.5, 1e-7, _D)),
    ("from_privacy_parameters", (100.0, 1e-6, _D)),
]


def both(name, args):
    return getattr(jax_pld, name)(*args), getattr(pld, name)(*args)


def assert_same_pld(got, want):
    assert np.array_equal(got.probs, want.probs)
    assert got._lower_index == want._lower_index
    assert got.interval == want.interval
    assert got.infinity_mass == want.infinity_mass


@pytest.mark.parametrize("name,args", MECHANISMS,
                         ids=[f"{n}{a}" for n, a in MECHANISMS])
def test_pld_constructors_and_queries_bit_equal(name, args):
    want, got = both(name, args)
    assert_same_pld(got, want)
    lo = float(want.losses[0]) if len(want.probs) else 0.0
    hi = float(want.losses[-1]) if len(want.probs) else 1.0
    for eps in np.concatenate([np.linspace(lo - 1.0, hi + 1.0, 41),
                               [0.0, lo, hi, 11001.0]]):
        assert got.get_delta_for_epsilon(float(eps)) == \
            want.get_delta_for_epsilon(float(eps))
    for delta in (0.0, 1e-8, 1e-6, 1e-3):
        assert got.get_epsilon_for_delta(delta) == \
            want.get_epsilon_for_delta(delta)


def test_pairwise_compose_and_self_compose_bit_equal():
    wa, ga = both("from_gaussian_mechanism", (2.0, _D))
    wb, gb = both("from_laplace_mechanism", (1.5, _D))
    assert_same_pld(ga.compose(gb), wa.compose(wb))
    assert_same_pld(ga.self_compose(5), wa.self_compose(5))
    with pytest.raises(ValueError, match="intervals"):
        ga.compose(pld.from_gaussian_mechanism(2.0, 2 * _D))
    with pytest.raises(ValueError, match="num_times"):
        ga.self_compose(0)


def sample(mod):
    return [
        mod.from_gaussian_mechanism(1.0, _D),
        mod.from_gaussian_mechanism(4.0, _D),
        mod.from_laplace_mechanism(1.0, _D),
        mod.from_laplace_mechanism(0.5, _D),
        mod.from_privacy_parameters(0.5, 1e-7, _D),
        mod.from_gaussian_mechanism(2.0, _D).compose(
            mod.from_laplace_mechanism(1.5, _D)),
    ]


@pytest.mark.parametrize("counts", [[2, 3, 1, 2, 1, 1], [1, 1, 1, 1, 1, 1],
                                    [7, 1, 1, 4, 2, 3]])
def test_compose_host_bit_equal(counts):
    want = jax_compose.compose_plds(sample(jax_pld), counts)
    got = compose.compose_plds(sample(pld), counts, device=False)
    assert_same_pld(got, want)
    assert got.get_epsilon_for_delta(1e-6) == want.get_epsilon_for_delta(1e-6)


def test_compose_converted_plds_bit_equal():
    # The JAX package's PLDs carried across by their fields.
    jax_plds = sample(jax_pld)
    plds = [convert.pld(p.probs, p._lower_index, p.interval, p.infinity_mass)
            for p in jax_plds]
    assert_same_pld(compose.compose_plds(plds, [1, 2, 3, 1, 1, 2],
                                         device=False),
                    jax_compose.compose_plds(jax_plds, [1, 2, 3, 1, 1, 2]))


def assert_within_1e9(got, want):
    assert len(got.probs) == len(want.probs)
    assert got._lower_index == want._lower_index
    assert np.max(np.abs(got.probs - want.probs)) <= 1e-9
    assert got.infinity_mass == want.infinity_mass
    assert got.get_epsilon_for_delta(1e-6) == pytest.approx(
        want.get_epsilon_for_delta(1e-6), abs=1e-9)


@pytest.mark.parametrize("counts", [[2, 3, 1, 2], [1, 1, 1, 1], [64, 1, 9, 3]])
def test_compose_plain_device_path_within_1e9(counts):
    jax_plds = sample(jax_pld)[:4]
    plds = sample(pld)[:4]
    got = compose.compose_plds(plds, counts, device="cpu")
    host = compose.compose_plds(plds, counts, device=False)
    jax_device = jax_compose.compose_plds(jax_plds, counts, device=True)
    assert_within_1e9(got, host)
    assert_within_1e9(got, jax_device)


def test_compose_plain_device_path_wide_trail_within_1e9():
    # A tenant-like trail: 24 distinct mechanisms, multiplicities up to 300
    # (weights in the hundreds amplify the error of small spectral lines),
    # coarsened onto 2^16 cells.
    rng = np.random.default_rng(7)
    specs = []
    for j, scale in enumerate(np.geomspace(0.5, 20.0, 24)):
        kind = "from_gaussian_mechanism" if j % 2 else "from_laplace_mechanism"
        specs.append((kind, (float(scale), _D), int(rng.integers(1, 301))))
    plds = [getattr(pld, k)(*a) for k, a, _ in specs]
    jax_plds = [getattr(jax_pld, k)(*a) for k, a, _ in specs]
    counts = [c for _, _, c in specs]
    got = compose.compose_plds(plds, counts, max_grid=1 << 16, device="cpu")
    host = compose.compose_plds(plds, counts, max_grid=1 << 16,
                                device=False)
    jax_device = jax_compose.compose_plds(jax_plds, counts, max_grid=1 << 16,
                                          device=True)
    assert len(got.probs) > 1 << 15
    assert_within_1e9(got, host)
    assert_within_1e9(got, jax_device)


def test_compose_single_cell_plds_on_the_plain_path():
    # Composed grids of one cell: the device path transforms on length 2.
    plds = [pld.from_privacy_parameters(100.0, 1e-6, _D)] * 2
    host = compose.compose_plds(plds, [3, 2], device=False)
    got = compose.compose_plds(plds, [3, 2], device="cpu")
    assert len(got.probs) == len(host.probs) == 1
    assert_within_1e9(got, host)


def test_compose_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plds = sample(pld)[:2]
    for device in (True, "cuda", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            compose.compose_plds(plds, [1, 2], device=device)


def test_compose_rejects_bad_inputs_as_jax():
    one = pld.from_gaussian_mechanism(1.0, _D)
    with pytest.raises(ValueError, match="at least one"):
        compose.compose_plds([])
    with pytest.raises(ValueError, match="counts"):
        compose.compose_plds([one], [0])
    with pytest.raises(ValueError, match="counts"):
        compose.compose_plds([one], [1, 2])
    with pytest.raises(ValueError, match="intervals"):
        compose.compose_plds([one, pld.from_gaussian_mechanism(1.0, 2 * _D)])


@pytest.mark.parametrize("rows,length", [(1, 2), (3, 4), (2, 64), (5, 1024)])
def test_pld_fft_plain_matches_numpy(rows, length):
    x = np.random.default_rng(rows).random((rows, length))
    spec = kernels.pld_rfft(torch.from_numpy(x))
    np.testing.assert_allclose(spec.numpy(), np.fft.rfft(x, axis=1),
                               rtol=0, atol=1e-12)
    back = kernels.pld_irfft(spec, length)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-14)


@pytest.mark.parametrize("op", [torch.log, torch.angle],
                         ids=["log", "angle"])
def test_log_spectrum_plain_ops_run_inline_with_the_whole_tensors_bits(op):
    # C16's plain accumulate takes log and angle in pieces of at most the
    # intra-op grain, each on the calling thread: a whole-tensor call,
    # split over the thread team, gave a few elements other bits in a
    # loaded process's first calls (counts0 of
    # test_compose_plain_device_path_within_1e9). In pieces the bits are
    # the whole-tensor call's: the composed PLDs do not move.
    rng = np.random.default_rng(11)
    n = 5 * (kernels._INLINE_ELEMENTS // 2 + 3)
    x = torch.complex(torch.from_numpy(rng.normal(size=n)),
                      torch.from_numpy(rng.normal(size=n))).reshape(5, -1)
    x[1, 7] = 0
    arg = torch.abs(x) if op is torch.log else x
    got = kernels._inline(op, arg)
    assert got.shape == arg.shape and got.dtype == torch.float64
    assert torch.equal(got, op(arg))
    assert kernels._inline(op, arg[:0]).shape == (0, arg.shape[1])


def test_log_spectrum_plain_matches_host_math():
    rng = np.random.default_rng(3)
    spec = rng.normal(size=(4, 33)) + 1j * rng.normal(size=(4, 33))
    spec[1, 5] = 0.0  # a dead bin
    w = np.array([1.0, 3.0, 64.0, 2.0])
    acc = torch.zeros(33, dtype=torch.complex128)
    kernels.log_spectrum_accumulate(torch.from_numpy(spec),
                                    torch.from_numpy(w), acc)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = (w[:, None] * np.log(spec)).sum(axis=0)
    alive = np.isfinite(want.real)
    np.testing.assert_allclose(acc.numpy()[alive], want[alive], rtol=1e-13)
    assert not np.isfinite(acc.numpy().real[5])
    out = kernels.log_spectrum_finalize(acc).numpy()
    np.testing.assert_allclose(out[alive], np.exp(want[alive]), rtol=1e-12)
    assert out[5] == 0


def test_pld_fft_rejects_bad_shapes():
    with pytest.raises(ValueError, match="power of two"):
        kernels.pld_rfft(torch.zeros((1, 6), dtype=torch.float64))
    with pytest.raises(ValueError, match="float64"):
        kernels.pld_rfft(torch.zeros((1, 8), dtype=torch.float32))
    with pytest.raises(ValueError, match="bins"):
        kernels.pld_irfft(torch.zeros((1, 4), dtype=torch.complex128), 8)


# Ported from tests/test_pld_compose.py (TestGoldenValues, TestCoarsening,
# TestSpectrumCache).

GOLDEN = [
    ("gaussian", 1.0, 1, 1e-5, 4.377178),
    ("gaussian", 3.0, 30, 1e-5, 8.940357),
    ("laplace", 1.0, 2, 1e-5, 1.999960),
]


@pytest.mark.parametrize("kind,scale,k,delta,exact_eps", GOLDEN)
def test_batched_golden(kind, scale, k, delta, exact_eps):
    name = ("from_gaussian_mechanism" if kind == "gaussian"
            else "from_laplace_mechanism")
    composed = compose.compose_plds([getattr(pld, name)(scale)], [k],
                                    device=False)
    eps = composed.get_epsilon_for_delta(delta)
    assert eps >= exact_eps - 1e-5
    assert eps == pytest.approx(exact_eps, rel=5e-4)
    want = jax_compose.compose_plds([getattr(jax_pld, name)(scale)], [k])
    assert eps == want.get_epsilon_for_delta(delta)


def test_coarsen_mass_conserved_pessimistic_and_bit_equal():
    one = pld.from_gaussian_mechanism(1.0, _D)
    coarse = compose.coarsen_pld(one, 4)
    assert_same_pld(coarse, jax_compose.coarsen_pld(
        jax_pld.from_gaussian_mechanism(1.0, _D), 4))
    assert coarse.interval == pytest.approx(4 * _D)
    assert np.sum(coarse.probs) == pytest.approx(np.sum(one.probs),
                                                 abs=1e-12)
    for eps in (0.0, 1.0, 3.0):
        assert (coarse.get_delta_for_epsilon(eps) >=
                one.get_delta_for_epsilon(eps) - 1e-12)


@pytest.mark.parametrize("device", [False, "cpu"])
def test_max_grid_triggers_coarsening(device):
    one = pld.from_gaussian_mechanism(1.0, _D)
    small = compose.compose_plds([one], [64], max_grid=1 << 12, device=device)
    big = compose.compose_plds([one], [64], device=device)
    assert len(small.probs) <= 1 << 12
    assert small.interval > big.interval
    assert (small.get_epsilon_for_delta(1e-6) >=
            big.get_epsilon_for_delta(1e-6) - 1e-9)
    want = jax_compose.compose_plds([jax_pld.from_gaussian_mechanism(1.0, _D)],
                                    [64], max_grid=1 << 12)
    assert small.interval == want.interval
    assert len(small.probs) == len(want.probs)


def test_spectrum_cache_reuse_keys_and_eviction():
    cache = compose.SpectrumCache()
    a = cache.get("MechanismType.GAUSSIAN", 2.0, 1.0, _D)
    assert cache.get("MechanismType.GAUSSIAN", 2.0, 1.0, _D) is a
    variants = [("MechanismType.LAPLACE", 2.0, 1.0, _D),
                ("MechanismType.GAUSSIAN", 2.0, 1.0, 2 * _D),
                ("MechanismType.GAUSSIAN", 2.0, 2.0, _D)]
    built = [cache.get(*v) for v in variants]
    assert len(cache) == 4
    assert len({id(p) for p in built + [a]}) == 4
    small = compose.SpectrumCache(max_entries=3)
    for scale in (1.0, 2.0, 3.0, 4.0, 5.0):
        small.get("MechanismType.LAPLACE", scale, 1.0, 1e-2)
    assert len(small) == 3
    small.clear()
    assert len(small) == 0


@pytest.mark.parametrize("kind,scale", [
    ("MechanismType.GAUSSIAN", 2.0), ("MechanismType.LAPLACE", 0.7),
    ("job_failed", (0.5, 1e-6)), ("MechanismType.GENERIC", 1.5)])
def test_spectrum_cache_builds_the_jax_pmfs(kind, scale):
    got = compose.SpectrumCache().get(kind, scale, 1.0, _D)
    assert_same_pld(got, jax_compose.SpectrumCache().get(kind, scale, 1.0, _D))


TRAIL = [
    {"mechanism_kind": "MechanismType.GAUSSIAN", "eps": 0.5, "delta": 1e-7,
     "noise_std": 3.0, "sensitivity": 2.0, "count": 3},
    {"mechanism_kind": "MechanismType.GAUSSIAN", "eps": 0.25, "delta": 1e-7},
    {"mechanism_kind": "MechanismType.LAPLACE", "eps": 0.5, "delta": 0.0,
     "noise_std": 2.0},
    {"mechanism_kind": "MechanismType.LAPLACE", "eps": 1.0},
    {"mechanism_kind": "MechanismType.GENERIC", "eps": 0.3, "delta": 1e-8},
    {"mechanism_kind": "job_failed", "eps": 0.1, "delta": 0.0, "count": 2},
    {"mechanism_kind": "MechanismType.GAUSSIAN", "eps": None},
]


def test_mechanism_keys_equal_jax():
    for record in TRAIL:
        assert compose.mechanism_key_for_record(record) == \
            jax_compose.mechanism_key_for_record(record)


@pytest.mark.parametrize("target_delta", [None, 1e-6])
def test_composed_epsilon_from_records_equals_jax(target_delta):
    got = compose.composed_epsilon_from_records(
        TRAIL, discretization=_D, target_delta=target_delta,
        cache=compose.SpectrumCache())
    want = jax_compose.composed_epsilon_from_records(
        TRAIL, discretization=_D, target_delta=target_delta,
        cache=jax_compose.SpectrumCache())
    assert got == want
    assert compose.composed_epsilon_from_records(
        [{"eps": None}], target_delta=target_delta) == \
        jax_compose.composed_epsilon_from_records(
            [{"eps": None}], target_delta=target_delta)


@pytest.mark.parametrize(
    "value", [0.0, -1e-4, 1e-8, 0.6, float("nan"), float("inf"), True, "fine",
              1e-7, 1e-4, 0.5])
def test_pld_discretization_validator_as_jax(value):
    def outcome(mod):
        try:
            mod.validate_pld_discretization(value, "t")
        except ValueError as e:
            return str(e)
        return None

    assert outcome(input_validators) == outcome(jax_validators)


def test_composed_infinity_mass_as_jax():
    p = pld.from_privacy_parameters(0.3, 1e-3, _D)
    composed = compose.compose_plds([p], [10], device=False)
    assert composed.infinity_mass == pytest.approx(
        -math.expm1(10 * math.log1p(-p.infinity_mass)), rel=1e-12)
    saturated = pld.from_gaussian_mechanism(1e-3, _D)
    assert compose.compose_plds([saturated, p], [1, 2],
                                device=False).infinity_mass == \
        jax_compose.compose_plds(
            [jax_pld.from_gaussian_mechanism(1e-3, _D),
             jax_pld.from_privacy_parameters(0.3, 1e-3, _D)],
            [1, 2]).infinity_mass
