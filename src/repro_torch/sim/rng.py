"""Counter-based random streams: JAX's threefry2x32 in its partitionable
mode, as torch integer ops, vectorized over lanes.

The batched backend draws each event-loop lane's jitter, PE speeds and
per-chunk noise from a stream that depends only on the lane's fold seed
(``InstanceSpec.fold_seed``), never on batch order, so lockstep replays equal
sequential ones.  This module reproduces the reference's draws::

    key = PRNGKey(seed); kj, ks, kn = split(key, 3)
    jitter = uniform(kj, (P,)); speed ~ normal(ks, (P,)); noise ~ normal(kn, (K,))

Keys are ``(B, 2)`` int64 tensors holding uint32 words; every intermediate is
an int64 masked to 32 bits, which behaves alike on the CPU and on CUDA.

Accuracy: the keys, the raw bits, ``uniform`` and ``normal`` are bit-equal to
``jax.random`` on the CPU (``tests/test_torch_rng.py``).  ``normal`` goes
through ``erf_inv``, whose ``log1p`` and the noise's ``exp`` are not the
platform's: :func:`log1p` and :func:`exp` spell out the float32 Cephes
algorithms that XLA emits on the CPU, operation by operation, with the
multiply-adds it fuses written as ``torch.addcmul`` and a correctly rounded
``sqrt``, so the same bits come out on any device whose float32 add, multiply,
divide and fused multiply-add round to nearest.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: XLA's float32 erf_inv coefficients for w < 5 and w >= 5 (Giles, 2010)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
#: Cephes logf: the mantissa split point, the polynomial (in three
#: interleaved parts) and ln(2) in two parts; log1p's rational approximation
#: for |x| < sqrt(2) - 1.  Cephes expf: the clamp, log2(e) and the polynomial
#: on [-ln(2)/2, ln(2)/2].  All are the float32 values XLA's CPU code uses.
_SQRTHF = 0.7071067690849304
_LOG_P = ((0.07037683576345444, -0.11514610052108765),
          (-0.12420140951871872, 0.14249323308467865),
          (0.2000071406364441, -0.24999994039535522),
          (0.11676998436450958, -0.16668057441711426, 0.3333333134651184))
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)
_F32_MIN = float(np.finfo(np.float32).tiny)
_SQRT2 = float(np.float32(math.sqrt(2.0)))
#: the low end of ``normal``'s uniform: nextafter(-1, 0) in float32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for j in range(5):
        for r in _ROTATIONS[j % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(j + 1) % 3]) & _M32
        x2 = (x2 + ks[(j + 2) % 3] + (j + 1)) & _M32
    return x1, x2


def prng_key(seeds: torch.Tensor) -> torch.Tensor:
    """``PRNGKey`` of each uint32 seed: the words (0, seed), shape (B, 2)."""
    seeds = seeds.to(torch.int64) & _M32
    return torch.stack([torch.zeros_like(seeds), seeds], dim=1)


def _counts(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def split(keys: torch.Tensor, num: int = 2):
    """``split(key, num)`` per lane: a tuple of ``num`` (B, 2) keys."""
    k1, k2 = keys[:, 0:1], keys[:, 1:2]
    i = _counts(num, keys)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return tuple(torch.stack([b1[:, j], b2[:, j]], dim=1) for j in range(num))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per draw, (B, n) int64: the two threefry words of the
    counter (0, i), xor-ed."""
    i = _counts(n, keys)
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(i), i)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``uniform(key, (n,))`` on [0, 1) per lane, (B, n) float32: 23 random
    mantissa bits under exponent 0, minus 1."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _f32(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(x, value)


def _fma(a, b, c):
    """``a*b + c`` rounded once (float tensors, or floats for b and c)."""
    if not torch.is_tensor(b):
        b = _f32(a, b)
    if not torch.is_tensor(c):
        c = _f32(a, c)
    return torch.addcmul(c, a, b)


def _log_cephes(a: torch.Tensor) -> torch.Tensor:
    """float32 ``log(a)``: a = m * 2^e with m in [sqrt(1/2), sqrt(2)), a
    degree-9 polynomial in m - 1 (evaluated in three interleaved parts),
    and e * ln(2) added in two parts.  ``a <= 0`` gives nan / -inf and
    ``a = inf`` gives inf."""
    bits = torch.clamp_min(a, _F32_MIN).view(torch.int32).to(torch.int64)
    m = ((bits & 0x7FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    x = (m + -1.0) + torch.where(small, m, torch.zeros_like(m))
    z = x * x
    x3 = z * x
    (a0, a1), (b0, b1), (c0, c1), (a2, b2, c2) = _LOG_P
    pa = _fma(_fma(x, a0, a1), x, a2)
    pb = _fma(_fma(x, b0, b1), x, b2)
    pc = _fma(_fma(x, c0, c1), x, c2)
    poly = _fma(_fma(_fma(pa, x3, pb), x3, pc), x3, e * _LN2_LO)
    out = ((x - z * 0.5) + poly) + e * _LN2_HI
    out = torch.where(a > 0, out, _f32(a, math.nan))
    out = torch.where(a == 0, _f32(a, -math.inf), out)
    return torch.where(a == math.inf, _f32(a, math.inf), out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA computes it on the CPU: a rational
    approximation for |x| < sqrt(2) - 1, else ``log(1 + x)``."""
    x2 = x * x
    num = _f32(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    den = _f32(x, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log_cephes(x + 1.0))


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA computes it on the CPU: n = floor(x log2(e) +
    1/2), a degree-7 polynomial of x - n ln(2) (ln(2) in two parts), times
    2^n.  (XLA flushes subnormal results, x < -87.33, to zero; this does
    not.)"""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_LN2_LO, x - n * _LN2_HI)
    y = _f32(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * two_n


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: a degree-8 polynomial in
    ``w = -log1p(-x*x)`` (shifted by 2.5 below 5, ``sqrt(w) - 3`` above),
    evaluated with fused multiply-adds, times x."""
    w = -log1p(x * -x)
    lt = w < 5.0
    # a correctly rounded float32 sqrt (float64, then rounded: exact)
    root = torch.sqrt(w.double()).to(torch.float32)
    w = torch.where(lt, w - 2.5, root - 3.0)
    p = torch.where(lt, _f32(x, _ERFINV_LT5[0]), _f32(x, _ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.addcmul(torch.where(lt, _f32(x, lo), _f32(x, hi)), p, w)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def erf_inv_uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``erf_inv(u)`` per lane, (B, n) float32, with u uniform on
    (nextafter(-1, 0), 1).  The uniform's span rounds to 2.0 in float32, so
    ``u = 2f + lo`` needs no fusion."""
    u = torch.clamp_min(uniform(keys, n) * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return erf_inv(u)


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``normal(key, (n,))`` per lane, (B, n) float32: ``sqrt(2) *
    erf_inv(u)``."""
    return _SQRT2 * erf_inv_uniform(keys, n)


def folded_scale(scale: float) -> float:
    """The factor of ``erf_inv(u)`` in ``scale * normal(key)`` inside the
    reference's jitted code: XLA folds the two constants first, ``(scale *
    sqrt(2))`` in float32, which can differ from ``scale * normal`` in the
    last bit."""
    return float(np.float32(scale) * np.float32(_SQRT2))


def folded_scales(scale: np.ndarray) -> np.ndarray:
    """:func:`folded_scale` of each entry of a float32 array, as a float32
    array (a per-lane factor)."""
    return np.asarray(scale, np.float32) * np.float32(_SQRT2)
