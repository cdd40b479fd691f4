"""The port's SSM (mamba2-2.7b) and enc-dec (whisper-small) families
against the JAX reference on the CPU, at ``smoke_reduce`` (float32, no
remat), from the reference's own ``init_params`` weights carried across by
``repro_torch.convert.model_params_from_jax``, with inputs (tokens, and
whisper's stub frame embeddings) from a numpy seed.

``forward``, ``loss_fn``, ``prefill`` (logits and every cache entry, at
the prompt's length and at a longer ``max_len``), two decode steps and
prefill-then-decode against the reference's forward agree within
``REL`` = 1e-4 relative to the largest magnitude of the reference's value
(``test_torch_models.py``'s bar: the port's attention runs the flash
kernel's online-softmax function, its SSD scan and norms sum in another
order, and the float32 products differ in the last bits).  The parameter
trees, dtypes and counts, and the cache specs, are equal.

``layer_norm`` and ``_sinusoid`` are not bit-equal to the reference's, and
cannot be without copying XLA's CPU code: XLA sums a row in windows of 32
(``core.metrics.xla_row_sum``) where torch sums in its own vector order,
and XLA's float32 ``sin`` and ``cos`` are not correctly rounded (one ulp
apart from torch's on about 4 % of equal angles, measured at 1,500 x
768).  So ``layer_norm`` is held within ``LN_REL`` = 1e-6 of the largest
magnitude, and ``_sinusoid`` within a few ulp of its angle: an angle of
up to S radians carries a rounding of S * 2^-24, so the bound is
``S * 2**-22`` absolute.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decode_step, forward, init_params  # noqa: E402
from repro.models import loss_fn, prefill  # noqa: E402
from repro.models.decode import decode_cache_specs  # noqa: E402
from repro.models.layers import layer_norm as j_layer_norm  # noqa: E402
from repro.models.model import _sinusoid as j_sinusoid  # noqa: E402
from repro.models.model import logits_fn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

REL = 1e-4
LN_REL = 1e-6
ARCHS = ["mamba2-2.7b", "whisper-small"]

_MODELS = {}


def family_model(arch):
    """The reference's smoke config of ``arch`` (float32, no remat), the
    port's equal one, the reference's weights and the port's copy of them
    (built once a module)."""
    if arch not in _MODELS:
        cfg = dataclasses.replace(smoke_reduce(get_config(arch)),
                                  remat=False)
        tcfg = dataclasses.replace(t_smoke(t_get_config(arch)), remat=False)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        params = init_params(cfg, jax.random.PRNGKey(0))
        tparams = convert.model_params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu")
        _MODELS[arch] = (cfg, tcfg, params, tparams)
    return _MODELS[arch]


def inputs(cfg, B, S, seed):
    """Tokens (B, S) and, for the enc-dec family, the stub frame
    embeddings (B, encoder_seq, D), from a numpy seed: (numpy tokens,
    numpy embeds or None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = None
    if cfg.family == "encdec":
        emb = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                  ).astype(np.float32)
    return toks, emb


def j_args(emb):
    return {} if emb is None else {"embeds": jnp.asarray(emb)}


def t_args(emb):
    return {} if emb is None else {"embeds": torch.from_numpy(emb)}


def assert_rel(got, want, rel=REL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def assert_caches(tc, jc):
    assert list(tc) == list(jc)
    for name in jc:
        if name == "len":
            assert int(tc[name]) == int(jc[name])
            assert tc[name].dtype == torch.int32
        else:
            assert tc[name].dtype == torch.float32
            assert_rel(tc[name], jc[name])


def pad_kv(cache, n=8):
    """The reference's cache with its self-attention KV stacks zero-padded
    by ``n`` positions (the port's built with room for decode)."""
    out = dict(cache)
    for name in ("k", "v"):
        if name in out:
            out[name] = jnp.pad(out[name], ((0, 0), (0, 0), (0, n), (0, 0),
                                            (0, 0)))
    return out


def check_forward(arch):
    cfg, tcfg, params, tparams = family_model(arch)
    toks, emb = inputs(cfg, 2, 64, 0)
    h, _, aux = forward(cfg, params, jnp.asarray(toks), **j_args(emb))
    th, cache, taux = T.forward(tcfg, tparams, torch.from_numpy(toks),
                                **t_args(emb))
    assert cache is None
    assert_rel(th, h)
    assert set(taux) == set(aux)
    for name in aux:
        assert_rel(taux[name], aux[name])


def check_loss(arch):
    cfg, tcfg, params, tparams = family_model(arch)
    toks, emb = inputs(cfg, 2, 32, 9)
    lj, aux = loss_fn(cfg, params, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks),
                                    **j_args(emb)})
    t = torch.from_numpy(toks)
    lt, taux = T.loss_fn(tcfg, tparams, {"tokens": t, "labels": t,
                                         **t_args(emb)})
    assert abs(float(lt) - float(lj)) <= REL * abs(float(lj))
    assert set(taux) == set(aux)


def check_prefill(arch):
    """Logits and caches at the prompt's length, and at a longer
    ``max_len``: the reference's self-attention KV zero-padded (the SSM
    family's conv windows and states have no positions)."""
    cfg, tcfg, params, tparams = family_model(arch)
    toks, emb = inputs(cfg, 2, 32, 1)
    lj, cj = prefill(cfg, params, jnp.asarray(toks), **j_args(emb))
    lt, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks), **t_args(emb))
    assert_rel(lt, lj)
    assert_caches(ct, cj)
    lt2, ct2 = T.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=40,
                         **t_args(emb))
    assert torch.equal(lt2, lt)
    assert_caches(ct2, pad_kv(cj))


def check_two_decode_steps(arch):
    cfg, tcfg, params, tparams = family_model(arch)
    S = 16
    toks, emb = inputs(cfg, 2, S + 2, 2)
    _, cj = prefill(cfg, params, jnp.asarray(toks[:, :S]), **j_args(emb))
    _, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]),
                      max_len=S + 8, **t_args(emb))
    cj = pad_kv(cj)
    assert_caches(ct, cj)
    for i in range(2):
        nxt = toks[:, S + i]
        lj, cj = decode_step(cfg, params, cj, jnp.asarray(nxt))
        lt, ct = T.decode_step(tcfg, tparams, ct, torch.from_numpy(nxt))
        assert_rel(lt, lj)
        assert_caches(ct, cj)


def check_prefill_then_decode(arch):
    """The reference's cache contract, across the packages: the port's
    prefill(tokens) then decode(next) equals the reference's forward over
    tokens + next, within REL."""
    cfg, tcfg, params, tparams = family_model(arch)
    B, S = 1, 16
    toks, emb = inputs(cfg, B, S + 1, 3)
    t = torch.from_numpy(toks)
    _, cache = T.prefill(tcfg, tparams, t[:, :S], max_len=S + 8,
                         **t_args(emb))
    logits_d, _ = T.decode_step(tcfg, tparams, cache, t[:, S])
    hidden, _, _ = forward(cfg, params, jnp.asarray(toks), **j_args(emb))
    assert_rel(logits_d, logits_fn(cfg, params, hidden[:, -1:, :])[:, 0])


def check_layout(arch):
    """The port's init: the reference's tree, shapes and dtypes (float32
    and bf16); the reference's weights cross key for key, bit for bit."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke_reduce(get_config(arch)),
                                  param_dtype=dtype)
        tcfg = dataclasses.replace(t_smoke(t_get_config(arch)),
                                   param_dtype=dtype)
        jp = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
        tp = T.init_params(tcfg, 0, device="cpu")
        assert set(tp) == set(jp)
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(jflat) == sum(len(v) if isinstance(v, dict) else 1
                                 for v in tp.values())
        for path, spec in jflat:
            t = tp
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == spec.shape, path
            assert str(t.dtype).endswith(str(spec.dtype)), path
    _, _, params, tparams = family_model(arch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        t = tparams
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def check_cache_specs(arch):
    cfg = smoke_reduce(get_config(arch))
    js = decode_cache_specs(cfg, 3, 40)
    ts = T.decode_cache_specs(t_smoke(t_get_config(arch)), 3, 40)
    assert list(ts) == list(js)
    for name, spec in js.items():
        assert ts[name].shape == spec.shape
        assert str(ts[name].dtype).endswith(str(spec.dtype))
    zero = T.init_decode_cache(t_smoke(t_get_config(arch)), 3, 40,
                               device="cpu")
    assert list(zero) == list(js)
    assert all(not bool(t.any()) for t in zero.values())


def check_param_count(arch):
    """The port's full-size init on the meta device holds the reference's
    parameters, leaf for leaf (``jax.eval_shape`` of its init), and
    ``ModelConfig.n_params()`` is the reference's."""
    tcfg = t_get_config(arch)
    p = T.init_params(tcfg, 0, device="meta")
    n = sum(t.numel() for g in p.values()
            for t in (g.values() if isinstance(g, dict) else [g]))
    jp = jax.eval_shape(lambda: init_params(get_config(arch),
                                            jax.random.PRNGKey(0)))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jp))
    assert tcfg.n_params() == get_config(arch).n_params()


def check_steps(arch):
    """The step builders: the port's ``make_prefill_step`` passes the
    batch's ``embeds``, as the reference's; ``make_serve_step`` decodes."""
    cfg, tcfg, params, tparams = family_model(arch)
    toks, emb = inputs(cfg, 2, 16, 7)
    lj, cj = jsteps.make_prefill_step(cfg)(
        params, {"tokens": jnp.asarray(toks), **j_args(emb)})
    lt, ct = tsteps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks), **t_args(emb)})
    assert_rel(lt, lj)
    assert_caches(ct, cj)
    _, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=24,
                      **t_args(emb))
    cj = pad_kv(cj)
    nxt = toks[:, 0]
    lj, cj = jsteps.make_serve_step(cfg)(params, cj, jnp.asarray(nxt))
    lt, ct = tsteps.make_serve_step(tcfg)(tparams, ct, torch.from_numpy(nxt))
    assert_rel(lt, lj)
    assert_caches(ct, cj)


CHECKS = {"forward": check_forward, "loss": check_loss,
          "prefill": check_prefill,
          "two_decode_steps": check_two_decode_steps,
          "prefill_then_decode": check_prefill_then_decode,
          "layout": check_layout, "cache_specs": check_cache_specs,
          "param_count": check_param_count, "steps": check_steps}


@pytest.mark.parametrize("check", list(CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_and_encdec_families_match_jax(arch, check):
    CHECKS[check](arch)


# ---------------------------------------------------------------------------
# the enc-dec family's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [128, 768, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(D, dtype):
    """Within LN_REL of the largest magnitude in float32; in bf16 within
    one bf16 ulp of the output on top (the two round one float32 value
    that may differ in its last bits)."""
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((3, 17, D)) * 3 + 0.5).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, w, b))
    want = np.asarray(j_layer_norm(jx, jw, jb).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = TL.layer_norm(*(torch.from_numpy(np.array(a.astype(jnp.float32)))
                          .to(tdt) for a in (jx, jw, jb)))
    assert got.dtype == tdt
    g = got.float().numpy()
    err = np.abs(g - want)
    if dtype == "bfloat16":
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126)))
                      - 7)
        err = np.maximum(err - ulp, 0.0)
    assert float(err.max()) <= LN_REL * float(np.abs(want).max())


@pytest.mark.parametrize("S,D", [(64, 128), (449, 768), (1500, 768)])
def test_sinusoid_matches_jax(S, D):
    """The table, and each row of it computed alone at its position (the
    decode step's), within ``S * 2**-22``; the rows alone are the table's
    rows bit for bit."""
    want = np.asarray(j_sinusoid(S, D))
    got = TM._sinusoid(S, D)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= S * 2.0 ** -22
    for pos in (0, 1, S // 2, S - 1):
        row = TM._sinusoid_at(torch.tensor([pos]), D)
        assert torch.equal(row[0], got[pos])


def test_encdec_needs_embeddings():
    _, tcfg, _, tparams = family_model("whisper-small")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="embeds"):
        T.forward(tcfg, tparams, toks)


def test_unknown_family_is_refused_as_the_reference_refuses_it():
    cfg = dataclasses.replace(t_smoke(t_get_config("mamba2-2.7b")),
                              family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        T.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        T.decode_cache_specs(cfg, 1, 8)
