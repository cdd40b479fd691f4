"""The port's MoE family (olmoe-1b-7b, grok-1-314b at ``smoke_reduce``,
float32) and its sort-based capacity dispatch (``layers.moe_block``)
against the JAX reference on the CPU.

The archs go through the checks of ``test_torch_families.py`` (forward
with ``expert_load``, prefill, two decode steps, prefill-then-decode, the
parameter tree and count).  ``moe_block`` is held directly: one and two
groups, a capacity that drops most assignments, ties in the router (which
``lax.top_k`` breaks towards the lower index) — ``expert_load`` equal
exactly, the outputs and the other statistics within 1e-5 of the largest
magnitude, and reruns bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import moe_block as j_moe_block  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

from test_torch_families import CHECKS, MOE_ARCHS  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("check", list(CHECKS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_family_matches_jax(arch, check):
    CHECKS[check](arch)


def _weights(T, D, E, F, seed, integer=False):
    """x (T, D), router (D, E) and the experts' (E, D, F) / (E, F, D)
    weights; ``integer``: x and the router small integers, so that every
    router logit is exact and equal logits tie exactly."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-2, 3, (T, D)).astype(np.float32)
        router = rng.integers(-1, 2, (D, E)).astype(np.float32)
    else:
        x = rng.standard_normal((T, D)).astype(np.float32)
        router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    s = 1 / np.sqrt(D)
    w = [(rng.standard_normal(shape) * s).astype(np.float32)
         for shape in ((E, D, F), (E, D, F), (E, F, D))]
    return [x, router] + w


def _compare(args, **kw):
    out_j, aux_j = j_moe_block(*map(jnp.asarray, args), **kw)
    out_t, aux_t = TL.moe_block(*map(torch.from_numpy, args), **kw)
    assert set(aux_t) == set(aux_j)
    assert aux_t["expert_load"].dtype == torch.int32
    np.testing.assert_array_equal(aux_t["expert_load"].numpy(),
                                  np.asarray(aux_j["expert_load"]))
    want = np.asarray(out_j)
    assert out_t.shape == want.shape
    bound = TOL * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(out_t.numpy() - want).max()) <= bound
    for name in ("dropped_frac", "router_z", "load_balance"):
        np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
    again, _ = TL.moe_block(*map(torch.from_numpy, args), **kw)
    assert torch.equal(again, out_t)
    return aux_t


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("T,D,E,F,k", [(64, 32, 8, 48, 2), (48, 16, 4, 24, 1),
                                       (40, 24, 16, 32, 4)])
def test_moe_block_matches_jax(T, D, E, F, k, groups):
    aux = _compare(_weights(T, D, E, F, seed=T + E), k=k, groups=groups)
    assert int(aux["expert_load"].sum()) == T * k


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_block_drops_over_capacity_as_jax(groups):
    """Capacity 0.25: C = max(1, int(0.25 * k * T / E)); most assignments
    are dropped (the decode case: olmoe's 8 tokens give C = 1)."""
    aux = _compare(_weights(32, 16, 8, 24, seed=9), k=2,
                   capacity_factor=0.25, groups=groups)
    assert float(aux["dropped_frac"]) > 0.5


def test_moe_block_decode_capacity_drops_as_jax():
    """olmoe's decode: 8 tokens, top-8 of 64 experts, C = 1."""
    aux = _compare(_weights(8, 32, 64, 16, seed=10), k=8)
    assert float(aux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_moe_block_router_ties_break_as_jax(k):
    """Integer inputs give exact router logits; two experts' router columns
    are equal, so every token ties between them, and most tokens tie
    between others too: the lower index wins, as in ``lax.top_k``."""
    args = _weights(48, 8, 6, 16, seed=11, integer=True)
    args[1][:, 4] = args[1][:, 1]
    _compare(args, k=k)


def test_top_k_takes_the_lower_index_on_ties():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3],
                      [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = TL.top_k(p, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert torch.equal(vals, p.gather(-1, idx))


def test_moe_block_groups_must_divide_the_tokens():
    args = list(map(torch.from_numpy, _weights(10, 8, 4, 8, seed=12)))
    with pytest.raises(ValueError, match="groups"):
        TL.moe_block(*args, k=1, groups=3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_reads_moe_groups_as_jax(arch):
    """``moe_groups()`` of the context splits the prefill's dispatch into
    groups (decode stays at one), in both packages alike."""
    from repro.distributed import ctx as jctx
    from repro.models import prefill
    from repro_torch import models as T
    from repro_torch.distributed import ctx as tctx
    from test_torch_families import assert_rel, family_model, tokens
    cfg, tcfg, params, tparams = family_model(arch)
    toks = tokens(cfg, 2, 32, seed=13)
    with jctx.activation_sharding(None, None, 1, 1, moe_groups=2), \
            tctx.activation_sharding(None, None, 1, 1, moe_groups=2):
        lj, cj = prefill(cfg, params, jnp.asarray(toks))
        lt, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks))
        _, _, aux = T.forward(tcfg, tparams, torch.from_numpy(toks))
    assert_rel(lt, lj)
    for name in ("k", "v"):
        assert_rel(ct[name], cj[name])
    ungrouped = T.forward(tcfg, tparams, torch.from_numpy(toks))[2]
    assert int(aux["expert_load"].sum()) == int(
        ungrouped["expert_load"].sum())
