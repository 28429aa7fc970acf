"""Threefry-2x32 counter-based RNG, bit-compatible with ``jax.random``.

The JAX package draws every random choice of a release from threefry keys
through ``jax.random.split/fold_in/bits/uniform/normal/laplace`` with the
partitionable counter layout (``jax_threefry_partitionable=True``, the
default of jax 0.9). This module is the port's copy of that generator:

  * keys are ``numpy.uint32[2]`` arrays, derived on the host (``split``,
    ``fold_in``, ``bits``);
  * element ``i`` of a draw of length ``n`` hashes the counter pair
    ``(i >> 32, i & 0xFFFFFFFF)`` under the key; a 32-bit word is
    ``x0 ^ x1``, a 64-bit word ``x0 << 32 | x1``;
  * ``uniform`` keeps JAX's mantissa trick, so words map to the same
    floats bit for bit; ``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's
    erf_inv polynomial and ``laplace`` is ``sign(u) * log1p(-|u|)``.

torch on the CPU has no uint32 add or shift, so the plain arithmetic runs
in int64 and masks to 32 bits. The CUDA kernels (``csrc/common.cuh``)
compute the same words in native uint32. The host key derivation (split,
fold_in, bits of a few words) runs on Python integers instead: a few
hundred tiny torch operations a key each release the GIL, and the
multi-tenant service's worker threads then queue for it behind one
another.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of counter words (x0, x1) under `key`.

    x0, x1: int64 tensors holding uint32 values; key: two uint32 words, as
    ints or as int64 tensors that broadcast with the counters (one key per
    element). Returns two int64 tensors of uint32 words
    (jax/_src/prng.py `_threefry2x32_lowering`).
    """
    k0, k1 = (w & _M32 if isinstance(w, torch.Tensor) else int(w) & _M32
              for w in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


# bits() of at most this many words runs on Python integers; the longer
# draws (dp_computations._threefry_uniforms, 2n words) take the torch path.
_HOST_WORDS = 64


def _threefry_ints(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """threefry2x32 of one counter pair on Python integers."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def _host_words(key, n: int):
    """The counter words (x0, x1) of elements 0..n-1 under one key."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    return [_threefry_ints(k0, k1, i >> 32, i & _M32) for i in range(n)]


def _counter_words(key, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key, idx >> 32, idx & _M32)


def _as_key(words) -> np.ndarray:
    return np.asarray([int(w) & _M32 for w in words], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) -> uint32[num, 2]. The package splits
    into two or three keys, so this runs on Python integers."""
    return np.asarray(_host_words(key, num), dtype=np.uint32).reshape(num, 2)


def fold_in_each(key, data: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fold_in(key, d) for every uint32 d of `data` (int64), under one key
    or one key per element (a pair of int64 tensors): the two key words."""
    return threefry2x32(key, torch.zeros_like(data), data & _M32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    return _as_key(_threefry_ints(int(key[0]) & _M32, int(key[1]) & _M32, 0,
                                  int(data) & _M32))


def random_bits32(key, n: int, device=None) -> torch.Tensor:
    """jax.random.bits(key, (n,), uint32), as int64 holding uint32."""
    b0, b1 = _counter_words(key, n, device)
    return b0 ^ b1


def bits_at(key, counters: torch.Tensor) -> torch.Tensor:
    """Element `counters[...]` of jax.random.bits(key, shape, uint32) (the
    flat index into the draw), under one key or one key per element: int64
    tensors holding uint32 words."""
    b0, b1 = threefry2x32(key, counters >> 32, counters & _M32)
    return b0 ^ b1


def bits(key, n: int) -> np.ndarray:
    """jax.random.bits(key, (n,), jnp.uint32) on the host."""
    if n <= _HOST_WORDS:
        return np.asarray([x0 ^ x1 for x0, x1 in _host_words(key, n)],
                          dtype=np.uint32)
    return random_bits32(key, n, "cpu").numpy().astype(np.uint32)


def _unit_floats(key, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Floats in [1, 2) minus 1: JAX's mantissa fill of the random word."""
    return _words_to_unit(*_counter_words(key, n, device), dtype)


def _words_to_unit(b0: torch.Tensor, b1: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float64:
        mant = (b0 << 20) | (b1 >> 12)  # (b0 << 32 | b1) >> 12
        fbits = mant | 0x3FF0000000000000
        return fbits.view(torch.float64) - 1.0
    if dtype == torch.float32:
        fbits = ((b0 ^ b1) >> 9) | 0x3F800000
        return fbits.to(torch.int32).view(torch.float32) - 1.0
    raise TypeError(f"uniform supports float32/float64, got {dtype}")


def _scale_unit(floats: torch.Tensor, minval: float,
                maxval: float) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=floats.dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=floats.dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key, n: int, dtype: torch.dtype = torch.float64,
            minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """jax.random.uniform(key, (n,), dtype, minval, maxval)."""
    return _scale_unit(_unit_floats(key, n, dtype, device), minval, maxval)


def open_interval_low(dtype: torch.dtype) -> float:
    """-1 + epsneg: the low end of the normal/laplace uniforms (it equals
    nextafter(-1, 0) in both widths)."""
    return -1.0 + float(np.finfo(_np_dtype(dtype)).epsneg)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


# XLA's erf_inv (xla/hlo/builder/lib/math.cc ErfInv32 / ErfInv64): Giles'
# single- and double-precision polynomials in w = -log1p(-x*x).
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv, evaluated in x's dtype with its operation order."""
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        z = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        coef = lambda i: torch.where(  # noqa: E731
            lt, torch.tensor(_ERFINV32_LT5[i], dtype=x.dtype),
            torch.tensor(_ERFINV32_GE5[i], dtype=x.dtype))
        p = coef(0).expand_as(x)
        for i in range(1, 9):
            p = coef(i) + p * z
    else:
        lt625, lt16 = w < 6.25, w < 16.0
        z = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0).to(x))

        def coef(i):
            c = torch.full_like(x, _ERFINV64_LT625[i])
            if i < 19:
                c = torch.where(lt625, c, _ERFINV64_LT16[i])
            if i < 17:
                c = torch.where(lt16, c, _ERFINV64_GE16[i])
            return c

        p = coef(0)
        for i in range(1, 17):
            p = coef(i) + p * z
        for i in range(17, 19):
            p = torch.where(lt16, coef(i) + p * z, p)
        for i in range(19, 23):
            p = torch.where(lt625, coef(i) + p * z, p)
    result = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, result)


def _normal_of(u: torch.Tensor) -> torch.Tensor:
    return torch.tensor(math.sqrt(2), dtype=u.dtype) * erf_inv(u)


def _laplace_of(u: torch.Tensor) -> torch.Tensor:
    return torch.sign(u) * torch.log1p(-u.abs())


def normal(key, n: int, dtype: torch.dtype = torch.float64,
           device=None) -> torch.Tensor:
    """jax.random.normal(key, (n,), dtype)."""
    return _normal_of(uniform(key, n, dtype, open_interval_low(dtype), 1.0,
                              device))


def laplace(key, n: int, dtype: torch.dtype = torch.float64,
            device=None) -> torch.Tensor:
    """jax.random.laplace(key, (n,), dtype)."""
    return _laplace_of(uniform(key, n, dtype, open_interval_low(dtype), 1.0,
                               device))


def draws_at(key, counters: torch.Tensor, dtype: torch.dtype,
             gaussian: bool) -> torch.Tensor:
    """Element `counters[...]` of jax.random.normal (gaussian) or
    jax.random.laplace draws, under one key or one key per element (a
    pair of int64 tensors): only the words asked for are computed."""
    b0, b1 = threefry2x32(key, counters >> 32, counters & _M32)
    u = _scale_unit(_words_to_unit(b0, b1, dtype), open_interval_low(dtype),
                    1.0)
    return _normal_of(u) if gaussian else _laplace_of(u)
