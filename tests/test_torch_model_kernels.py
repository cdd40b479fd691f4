"""The plain versions of the port's model kernels (``rmsnorm``,
``flash_attention``, ``ssd_scan``) against the JAX Pallas kernels, run in
interpret mode on the CPU through ``repro.kernels.ops``, and against the
oracles of ``repro.kernels.ref``, on the same numpy-seeded inputs.

Tolerances, with their reasons:

* float32 — rmsnorm 1e-6, flash attention 1e-5 and SSD 1e-4, relative to
  the largest magnitude of the reference's output: the sums run in another
  order (the row mean of x², the softmax denominator, the in-chunk
  ``cumsum`` and the products), and SSD's ``exp`` of differences of
  cumulative sums amplifies their rounding;
* bfloat16 — one bfloat16 ulp of the output beyond the float32
  tolerance: both sides compute in float32 from the same bfloat16 inputs
  and round once, so float32 results that agree within the float32
  tolerance can land on neighbouring bfloat16 values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = {"rmsnorm": 1e-6, "flash": 1e-5, "ssd": 1e-4}


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _both(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX array and a CPU tensor of
    ``dtype``, rounded alike."""
    jdt, tdt = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(t.float().numpy()).astype(jdt), t


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_close(got, want, dtype: str, kernel: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want)
    f32_bound = F32_TOL[kernel] * max(float(np.abs(want).max()), 1e-30)
    if dtype == "float32":
        assert float(err.max()) <= f32_bound, (float(err.max()), f32_bound)
    else:
        ulp = np.maximum(bf16_ulp(got), bf16_ulp(want))
        assert np.all(err <= ulp + f32_bound), float((err / ulp).max())


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 64), (2, 5, 9, 256),
                                   (4, 3584), (2, 7168)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    xj, xt = _both(rng.standard_normal(shape).astype(np.float32), dtype)
    wj, wt = _both(rng.standard_normal(shape[-1:]).astype(np.float32),
                   dtype)
    got = trms.rmsnorm(xt, wt)
    assert got.dtype == xt.dtype
    assert_close(got.float(), ops.rmsnorm(xj, wj, block_rows=16), dtype,
                 "rmsnorm")
    assert_close(got.float(), ref.rmsnorm_ref(xj, wj), dtype, "rmsnorm")


def test_rmsnorm_float32_input_with_bfloat16_weight():
    """The decode path's gated norm: float32 activations, bf16 weight."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    wj, wt = _both(rng.standard_normal(256).astype(np.float32), "bfloat16")
    got = tlayers.rms_norm(torch.from_numpy(x), wt)
    assert got.dtype == torch.float32
    assert_close(got, ref.rmsnorm_ref(jnp.asarray(x), wj), "float32",
                 "rmsnorm")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (1, 128, 128, 4, 4, 64),     # MHA square
    (2, 96, 160, 8, 2, 32),      # GQA, ragged lengths
    (1, 257, 129, 6, 3, 64),     # non-multiple-of-block sizes, S > T
    (1, 128, 128, 4, 4, 112),    # the path's head dim
    (2, 100, 72, 4, 2, 112),     # hd = 112, GQA, ragged S > T
]


@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(B, S, T, H, K, hd, causal,
                                            dtype):
    rng = np.random.default_rng(B * S + T * H + K * hd)
    qj, qt = _both(rng.standard_normal((B, S, H, hd)).astype(np.float32),
                   dtype)
    kj, kt = _both(rng.standard_normal((B, T, K, hd)).astype(np.float32),
                   dtype)
    vj, vt = _both(rng.standard_normal((B, T, K, hd)).astype(np.float32),
                   dtype)
    got = tfa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype
    want = ops.flash_attention(qj, kj, vj, causal=causal, block_q=64,
                               block_kv=64)
    assert_close(got.float(), want, dtype, "flash")
    assert_close(got.float(), ref.flash_attention_ref(qj, kj, vj,
                                                      causal=causal),
                 dtype, "flash")


def test_model_attention_goes_to_the_flash_kernel():
    """Both of the model's prefill attentions compute the kernel's
    function (the reference's ``full_attention`` / ``chunked_attention``
    twins); a query offset, which the kernel lacks, is refused."""
    from repro.models.layers import chunked_attention, full_attention
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 2, 96, 8, 4, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for port, jax_fn in ((tlayers.full_attention, full_attention),
                         (tlayers.chunked_attention, chunked_attention)):
        n0 = tfa.flash_attention.launches
        got = port(tq, tk, tv, causal=True)
        assert tfa.flash_attention.launches == n0   # CPU: the plain version
        assert_close(got, jax_fn(jq, jk, jv, causal=True), "float32",
                     "flash")
    with pytest.raises(NotImplementedError, match="offset"):
        tlayers.full_attention(tq, tk, tv, causal=True, q_offset=4)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_CASES = [
    (1, 64, 4, 32, 16, 16, 4),
    (2, 128, 8, 32, 16, 32, 4),
    (1, 96, 6, 16, 8, 32, 2),      # nh = 6, head block 2
    (1, 128, 4, 64, 64, 64, 4),    # the path's hp = st = 64
    (1, 128, 4, 64, 128, 64, 4),   # Mamba2-2.7B's state of 128
]


def _ssd_inputs(b, S, nh, hp, st, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, S, nh, hp)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, S, nh)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, S, st)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, S, st)) * 0.5).astype(np.float32)
    xj, xt = _both(x, dtype)
    # B and C enter the kernel in float32, as the model casts them
    Bt = torch.from_numpy(Bm).to(DTYPES[dtype][1]).float()
    Ct = torch.from_numpy(Cm).to(DTYPES[dtype][1]).float()
    jax_f32 = [jnp.asarray(a) for a in (dt, A, Bt.numpy(), Ct.numpy())]
    return (xj, *jax_f32), (xt, torch.from_numpy(dt), torch.from_numpy(A),
                            Bt, Ct)


@pytest.mark.parametrize("b,S,nh,hp,st,chunk,hb", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_and_ref(b, S, nh, hp, st, chunk, hb,
                                          dtype):
    jargs, targs = _ssd_inputs(b, S, nh, hp, st, dtype, b * S + nh * hp)
    y, h = tssd.ssd_scan(*targs, chunk=chunk, head_block=hb)
    assert y.dtype == targs[0].dtype and h.dtype == torch.float32
    yj, hj = ops.ssd_scan(*jargs, chunk=chunk, head_block=hb)
    assert_close(y.float(), yj, dtype, "ssd")
    assert_close(h, hj, "float32", "ssd")
    yr, hr = ref.ssd_ref(*jargs)
    assert_close(y.float(), yr, dtype, "ssd")
    assert_close(h, hr, "float32", "ssd")


def test_ssd_model_path_matches_reference_ssd_chunked():
    """The model's ``ssd_chunked`` (the kernel) against the reference's
    XLA twin, and a chunk longer than the sequence (it is cut to S)."""
    from repro.models.ssm import ssd_chunked
    jargs, targs = _ssd_inputs(2, 128, 4, 32, 16, "float32", 5)
    for chunk in (32, 256):
        y, h = tssm.ssd_chunked(*targs, chunk)
        yj, hj = ssd_chunked(*jargs, chunk)
        assert_close(y, yj, "float32", "ssd")
        assert_close(h, hj, "float32", "ssd")


def test_ssd_wrapper_refuses_a_ragged_chunk():
    _, targs = _ssd_inputs(1, 96, 2, 16, 8, "float32", 0)
    with pytest.raises(ValueError, match="multiple"):
        tssd.ssd_scan_ref(*targs, chunk=64)


# ---------------------------------------------------------------------------
# gradients: the plain versions under autograd against jax.vjp of the
# reference's twins (repro.models.layers.rms_norm / full_attention), which
# the reference trains through and the port's backward kernels compute.
#
# Tolerances: float32 as the forward (rmsnorm 1e-6, flash 1e-5 relative to
# the largest magnitude; sums in another order).  bfloat16 rmsnorm: one
# bfloat16 ulp beyond that (both differentiate in float32 and round once).
# bfloat16 flash attention: relative L2 <= 2**-7, because the twin rounds
# its softmax weights to bfloat16 before the product with v, and so the
# weights' gradient too, where the plain version keeps both in float32:
# two roundings of <= 2**-9 each inside, one at the output (measured
# ~2.6e-3).
# ---------------------------------------------------------------------------

FLASH_GRAD_REL_L2_BF16 = 2.0 ** -7

GRAD_CASES = [
    (2, 64, 64, 4, 2, 32),       # GQA, hd 32
    (1, 128, 128, 6, 2, 128),    # GQA, the training head dim
    (2, 96, 80, 4, 4, 32),       # MHA, ragged S > T
    (1, 130, 130, 8, 2, 128),    # ragged tile edges at hd 128
]


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 64), (4, 3584)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_gradients_match_reference_twin(shape, dtype):
    import jax
    from repro.models.layers import rms_norm
    rng = np.random.default_rng(sum(shape) + 5)
    (xj, xt), (wj, wt), (gj, gt) = (
        _both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in (shape, shape[-1:], shape))
    _, vjp = jax.vjp(lambda x, w: rms_norm(x, w, 1e-5), xj, wj)
    want = vjp(gj)
    got = trms.rmsnorm_bwd(xt, wt, gt)      # CPU: autograd of the plain
    assert [g.dtype for g in got] == [xt.dtype, wt.dtype]
    for g, w in zip(got, want):
        assert_close(g.float(), w, dtype, "rmsnorm")


@pytest.mark.parametrize("B,S,T,H,K,hd", GRAD_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_gradients_match_reference_twin(B, S, T, H, K, hd,
                                                    causal, dtype):
    import jax
    from repro.models.layers import full_attention
    rng = np.random.default_rng(B * S + T + H * K + hd)
    (qj, qt), (kj, kt), (vj, vt), (dj, dt) = (
        _both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd),
                  (B, S, H, hd)))
    _, vjp = jax.vjp(lambda q, k, v: full_attention(q, k, v, causal=causal),
                     qj, kj, vj)
    want = vjp(dj)
    o, lse = tfa.flash_attention_lse(qt, kt, vt, causal=causal)
    n0 = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(qt, kt, vt, o, dt, lse, causal=causal)
    assert tfa.flash_attention_bwd.launches == n0   # CPU: the plain version
    for g, w in zip(got, want):
        assert g.dtype == qt.dtype and g.shape == w.shape
        if dtype == "float32":
            assert_close(g, w, dtype, "flash")
        else:
            assert _rel_l2(g.float(), w) <= FLASH_GRAD_REL_L2_BF16


#: the plain row lse against the reference's scores: float32 sums in
#: another order, relative to the largest |lse|
LSE_REL = 1e-6


@pytest.mark.parametrize("B,S,T,H,K,hd", GRAD_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_lse_matches_reference_scores(B, S, T, H, K, hd, causal,
                                                  dtype):
    """The plain lse that the backward takes is the row logsumexp of the
    masked, scaled scores that ``repro.models.layers.full_attention``
    forms (its own ``_gqa_scores_einsum`` and mask), in (B, H, S); and
    ``flash_attention_lse``'s output is ``flash_attention``'s."""
    import math
    import jax
    from repro.models.layers import _gqa_scores_einsum
    rng = np.random.default_rng(B * S + T + H * K + hd + 1)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    scale = 1.0 / math.sqrt(hd)     # as full_attention scales q
    scores = _gqa_scores_einsum(
        qj.reshape(B, S, K, H // K, hd).astype(jnp.float32) * scale,
        kj.astype(jnp.float32))
    if causal:
        mask = jnp.arange(T)[None, :] <= jnp.arange(S)[:, None]
        scores = jnp.where(mask[None, None, None], scores, -jnp.inf)
    want = _np(jax.nn.logsumexp(scores, axis=-1)).reshape(B, H, S)
    o, lse = tfa.flash_attention_lse(qt, kt, vt, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    err = float(np.abs(lse.numpy() - want).max())
    assert err <= LSE_REL * float(np.abs(want).max()), err
    assert torch.equal(o, tfa.flash_attention(qt, kt, vt, causal=causal))


def test_flash_plain_lse_of_a_row_with_no_key_is_inf():
    q = torch.ones((1, 3, 2, 8))
    lse = tfa.flash_attention_lse_ref(q, q[:, :0, :1], q[:, :0, :1])
    assert lse.shape == (1, 2, 3) and bool(torch.isposinf(lse).all())


def test_model_layers_differentiate_through_the_plain_versions():
    """On the CPU the model's rms_norm and attention are the plain
    versions, so autograd reaches every input (the card's path goes
    through the backward kernels' Functions instead)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 16, 4, 32))
                         .astype(np.float32)).requires_grad_()
    w = torch.ones(32, requires_grad=True)
    kv = x[:, :, :2].detach().clone().requires_grad_()
    out = tlayers.full_attention(tlayers.rms_norm(x, w), kv, kv,
                                 causal=True)
    out.square().sum().backward()
    for t in (x, w, kv):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
