"""The port's threefry streams (``repro_torch.sim.rng``) reproduce
``jax.random`` in its partitionable threefry2x32 mode bit for bit: keys, raw
bits, ``uniform`` and ``normal``; and the float32 ``log1p``, ``exp`` and
``erf_inv`` equal the reference's ``jnp.log1p``, ``jnp.exp`` and
``lax.erf_inv`` on the CPU."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.sim import rng as R  # noqa: E402

#: fold seeds as the campaign makes them: crc32 of int64 seed tuples
SEEDS = np.array([zlib.crc32(np.asarray((0, a, 128, alg, t, r), np.int64)
                             .tobytes())
                  for a in (7, 4021) for alg in range(12) for t in range(8)
                  for r in range(3)] + [0, 1, 2**31 - 1, 2**32 - 1],
                 dtype=np.uint32)


def _jax_draws(n_p, n_k):
    def one(seed):
        kj, ks, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
        return (jax.random.key_data(kj) if hasattr(jax.random, "key_data")
                else kj, ks, kn, jax.random.bits(kj, (n_p,)),
                jax.random.uniform(kj, (n_p,)), jax.random.normal(ks, (n_p,)),
                jax.random.normal(kn, (n_k,)))
    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(jnp.asarray(SEEDS))]


def _torch_draws(n_p, n_k):
    keys = R.prng_key(torch.from_numpy(SEEDS.astype(np.int64)))
    kj, ks, kn = R.split(keys, 3)
    return (kj, ks, kn, R.random_bits(kj, n_p), R.uniform(kj, n_p),
            R.normal(ks, n_p), R.normal(kn, n_k))


@pytest.mark.parametrize("n_p,n_k", [(20, 257), (56, 1024), (128, 4096)])
def test_keys_bits_uniform_bit_equal(n_p, n_k):
    want = _jax_draws(n_p, n_k)
    got = _torch_draws(n_p, n_k)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    assert got[4].dtype == torch.float32


@pytest.mark.parametrize("n_p,n_k", [(20, 257), (128, 4096)])
def test_normal_bit_equal(n_p, n_k):
    want = _jax_draws(n_p, n_k)
    got = _torch_draws(n_p, n_k)
    for w, g in zip(want[5:], got[5:]):
        np.testing.assert_array_equal(g.numpy(), w)


def _grid(lo, hi, n=1 << 16):
    return np.linspace(lo, hi, n, dtype=np.float32)


@pytest.mark.parametrize("name,x", [
    ("log1p", _grid(-0.999999, 3.0)),
    ("log1p", -np.float32(1) + np.geomspace(1e-7, 1e-2, 4096)
     .astype(np.float32)),
    ("log1p", _grid(-0.42, 0.42)),
    # below -87.33 the result is subnormal, which XLA's CPU code flushes
    # to zero and the port does not; the noise stays near exp(0)
    ("exp", _grid(-87.3, 88.7)),
    ("exp", _grid(-0.2, 0.2)),
    ("erf_inv", _grid(-1.0, 1.0)),
    ("erf_inv", np.float32(1) - np.geomspace(1e-7, 1e-2, 4096)
     .astype(np.float32)),
])
def test_float32_functions_equal_xla(name, x):
    ref = {"log1p": jnp.log1p, "exp": jnp.exp,
           "erf_inv": jax.lax.erf_inv}[name]
    want = np.asarray(jax.jit(ref)(jnp.asarray(x)))
    got = getattr(R, name)(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_draws_depend_only_on_the_seed():
    """A lane's draws are the same in any batch and at any width: the
    counter of draw i is i whatever the shape."""
    keys = R.prng_key(torch.from_numpy(SEEDS.astype(np.int64)))
    _, _, kn = R.split(keys, 3)
    wide = R.normal(kn, 1024)
    narrow = R.normal(kn[5:9], 256)
    torch.testing.assert_close(narrow, wide[5:9, :256], rtol=0, atol=0)


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0, 0.5], dtype=torch.float32)
    y = R.erf_inv(x)
    assert torch.isinf(y[0]) and y[0] < 0 and torch.isinf(y[1]) and y[1] > 0
    assert y[2] == 0 and y[3] == 0
    ref = np.asarray(jax.lax.erf_inv(jnp.float32(0.5)))
    np.testing.assert_array_equal(y[4:].numpy(), np.atleast_1d(ref))
    z = R.log1p(torch.tensor([-1.0, -2.0, np.inf], dtype=torch.float32))
    assert z[0] == -np.inf and torch.isnan(z[1]) and z[2] == np.inf
