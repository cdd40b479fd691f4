"""The gradient of the SSD scan in the port against the reference, on the
CPU: the plain backward (``ssd_scan_bwd_ref``, autograd through the port's
chunked scan) against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked``, the
function the reference trains through; the autograd Function that carries
the backward kernel on the card, wired on CPU tensors to the plain
versions; a numerical gradient check of it in float64; and the forward
under ``no_grad`` recording nothing.

Inputs are drawn from numpy seeds in float32, with dt a softplus of a
normal (positive) and A = -exp(normal) (negative), as the model makes
them.  Tolerance: dx, ddt, dB and dC within ``GRAD_REL`` of their largest
magnitude: both sides compute in float32 and sum the same terms in
another order (XLA's CPU dots against torch's), and the chunk's
exponentials of cumulative sums amplify no rounding beyond that.  dA
within ``DA_REL``: each head's dA is one sum over the batch and the
sequence of terms of both signs, several times larger in magnitude than
the sum (measured: 1.0e-5 to 3.5e-5 against 1e-5), so its rounding is
relative to them; 1e-4 is the forward kernel's float32 tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

GRAD_REL = 1e-5
DA_REL = 1e-4

#: (b, S, nh, hp, st, chunk): states 16, 64, 96 and 128, one chunk and
#: several
CASES = [(1, 32, 2, 8, 16, 32), (2, 64, 3, 16, 16, 16),
         (1, 64, 2, 16, 64, 64), (2, 96, 2, 8, 64, 32),
         (1, 48, 3, 8, 96, 48), (1, 128, 2, 16, 96, 32),
         (1, 64, 2, 16, 128, 64), (2, 128, 2, 8, 128, 32)]


def _inputs(b, S, nh, hp, st, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return ((rng.standard_normal((b, S, nh, hp)) * 0.5).astype(f),
            np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(f),
            (-np.exp(rng.standard_normal(nh) * 0.5)).astype(f),
            (rng.standard_normal((b, S, st)) * 0.5).astype(f),
            (rng.standard_normal((b, S, st)) * 0.5).astype(f),
            rng.standard_normal((b, S, nh, hp)).astype(f),
            rng.standard_normal((b, nh, hp, st)).astype(f))


def _jax_grads(chunk):
    """The reference's gradients of ``ssd_chunked`` for the cotangents of
    (y, final state), jitted (one compile a shape)."""
    def grads(args, cts):
        return jax.vjp(lambda *a: ssd_chunked(*a, chunk), *args)[1](cts)
    return jax.jit(grads)


def _max_rel(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,S,nh,hp,st,chunk", CASES)
@pytest.mark.parametrize("with_dstate", [False, True])
def test_plain_backward_matches_jax_grad_of_the_reference(b, S, nh, hp, st,
                                                          chunk,
                                                          with_dstate):
    *args, dy, dstate = _inputs(b, S, nh, hp, st, b * S + st)
    if not with_dstate:
        dstate = np.zeros_like(dstate)
    want = _jax_grads(chunk)(tuple(map(jnp.asarray, args)),
                             (jnp.asarray(dy), jnp.asarray(dstate)))
    t = [torch.from_numpy(a) for a in args]
    got = SSD.ssd_scan_bwd_ref(
        *t, torch.from_numpy(dy),
        torch.from_numpy(dstate) if with_dstate else None, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert bool(torch.isfinite(g).all()), name
        tol = DA_REL if name == "dA" else GRAD_REL
        assert _max_rel(g, w) <= tol, (name, _max_rel(g, w))


@pytest.mark.parametrize("with_dstate", [False, True])
def test_function_on_cpu_tensors_takes_the_plain_versions(with_dstate):
    """``_SSDScan`` (the Function the card's kernels run in) on CPU
    tensors: its forward is ``ssd_scan_ref``'s output and its backward
    ``ssd_scan_bwd_ref``'s gradients, bit for bit."""
    *args, dy, dstate = _inputs(2, 64, 3, 16, 64, 7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = SSD._SSDScan.apply(*leaves, 32)
    want_y, want_h = SSD.ssd_scan_ref(*(t.detach() for t in leaves),
                                      chunk=32)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    outs, grads = [y], [torch.from_numpy(dy)]
    if with_dstate:
        outs.append(h)
        grads.append(torch.from_numpy(dstate))
    torch.autograd.backward(outs, grads)
    want = SSD.ssd_scan_bwd_ref(*(t.detach() for t in leaves), grads[0],
                                grads[1] if with_dstate else None, chunk=32)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_function_passes_gradcheck_in_float64():
    rng = np.random.default_rng(3)
    b, S, nh, hp, st, chunk = 1, 12, 2, 3, 4, 4

    def leaf(a):
        return torch.from_numpy(a.astype(np.float64)).requires_grad_()

    args = (leaf(rng.standard_normal((b, S, nh, hp))),
            leaf(np.log1p(np.exp(rng.standard_normal((b, S, nh))))),
            leaf(-np.exp(rng.standard_normal(nh) * 0.5)),
            leaf(rng.standard_normal((b, S, st))),
            leaf(rng.standard_normal((b, S, st))))
    assert torch.autograd.gradcheck(
        lambda *a: SSD._SSDScan.apply(*a, chunk), args)


def test_forward_under_no_grad_records_nothing():
    *args, _, _ = _inputs(1, 64, 2, 16, 16, 1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    with torch.no_grad():
        y, h = SSD.ssd_scan(*leaves, chunk=32)
    assert y.grad_fn is None and h.grad_fn is None
    y, h = SSD.ssd_scan(*leaves, chunk=32)
    assert y.grad_fn is not None


def test_backward_wrapper_on_the_cpu_is_the_plain_version():
    *args, dy, dstate = _inputs(1, 64, 2, 16, 96, 2)
    t = [torch.from_numpy(a) for a in args]
    got = SSD.ssd_scan_bwd(*t, torch.from_numpy(dy),
                           torch.from_numpy(dstate), chunk=32)
    want = SSD.ssd_scan_bwd_ref(*t, torch.from_numpy(dy),
                                torch.from_numpy(dstate), chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert SSD.ssd_scan_bwd in SSD.WRAPPERS
