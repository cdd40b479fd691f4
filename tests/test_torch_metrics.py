"""``lib`` of the batched simulator, float32, against the reference.

The reference computes ``(1 - mean(fin) / max(fin)) * 100`` in compiled
float32 code (``repro.sim.backends.jax_batched``).  XLA's CPU code sums a
row of more than 32 values window by window and divides by the row length
as a product with its reciprocal; the port's ``xla_row_mean`` follows that
order, so ``lib`` is bit-equal at every P the simulator uses — 20, 56 and
128 (the three systems) and 8 (the what-if fleet's replicas) — and at
lengths that pad the last window.  Both agree with the float64
``repro.core.metrics.percent_load_imbalance`` to float32 rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.metrics import percent_load_imbalance  # noqa: E402
from repro_torch.core.metrics import xla_row_mean, xla_row_sum  # noqa: E402


@jax.jit
def _reference_lib(fin):
    mk = fin.max(axis=1)
    return jnp.where(mk > 0.0, (1.0 - fin.mean(axis=1) / mk) * 100.0, 0.0)


def _port_lib(fin: torch.Tensor) -> torch.Tensor:
    mk = fin.max(dim=1).values
    return torch.where(mk > 0.0, (1.0 - xla_row_mean(fin) / mk) * 100.0,
                       torch.zeros_like(mk))


def _finish_times(P, seed, rows=4096):
    rng = np.random.default_rng(seed)
    fin = (1e-3 + rng.random((rows, P)) * 1e-4).astype(np.float32)
    fin[::5] *= rng.lognormal(0.0, 1.0, (len(fin[::5]), P)).astype(
        np.float32)
    fin[::17] = 0.0
    return fin


@pytest.mark.parametrize("P", [8, 20, 56, 128, 33, 200])
def test_lib_is_bit_equal_to_the_reference(P):
    fin = _finish_times(P, P)
    got = _port_lib(torch.from_numpy(fin)).numpy()
    want = np.asarray(_reference_lib(fin))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        xla_row_sum(torch.from_numpy(fin)).numpy(),
        np.asarray(jax.jit(lambda f: f.sum(axis=1))(fin)))
    f64 = np.array([percent_load_imbalance(r) for r in fin])
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-4)


def test_plain_torch_mean_is_not_the_reference_order():
    """The repair is needed: torch's own float32 row mean rounds otherwise
    at P = 56 on some rows."""
    fin = torch.from_numpy(_finish_times(56, 1))
    assert not torch.equal(fin.mean(dim=1), xla_row_mean(fin))
