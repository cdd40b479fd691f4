"""The reference's per-architecture smoke tests (``test_models_smoke.py``),
ported: every arch at ``smoke_reduce`` (float32), the port held against
the reference on the CPU, not only for shapes and finite values.

Weights are the reference's ``init_params`` carried across by
``repro_torch.convert.model_params_from_jax``; tokens and whisper's stub
frame embeddings come from a numpy seed.  ``loss_fn`` (with the MoE's
``expert_load`` exactly), two decode steps from a zero cache at length 8,
and prefill-then-decode against the reference's forward agree within
``REL`` = 1e-4 relative to the largest magnitude (the bar of
``test_torch_families.py``); the port's prefill-then-decode also meets
the reference's own contract against the port's forward (2e-3).
Parameter counts, active parameters and the applicability rule are
equal.  The reference's train-step smoke takes two steps of
``make_train_step`` from the same weights in both packages, every arch,
and their losses agree within ``REL`` (the launcher trains all but the
enc-dec family; the step builder takes every family).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES, SHAPES, applicable  # noqa: E402
from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.models import (decode_step, forward, init_decode_cache,  # noqa: E402,E501
                          init_params, loss_fn)
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models.model import logits_fn  # noqa: E402
from repro.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.configs import ARCH_NAMES as T_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import applicable as t_applicable  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402

REL = 1e-4
KEY = jax.random.PRNGKey(0)
#: the reference's prefill-then-decode archs: one of each family
CONSISTENCY_ARCHS = ["llama3.2-3b", "mamba2-2.7b", "zamba2-7b",
                     "olmoe-1b-7b", "whisper-small"]

_MODELS = {}


def smoke_model(arch, **kw):
    """The reference's smoke config of ``arch`` (with ``kw``), the port's
    equal one, the reference's weights from KEY and the port's copy of
    them (built once a module for each set of ``kw``)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        cfg = dataclasses.replace(smoke_reduce(get_config(arch)), **kw)
        tcfg = dataclasses.replace(t_smoke(t_get_config(arch)), **kw)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        params = init_params(cfg, KEY)
        tparams = convert.model_params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu")
        _MODELS[key] = (cfg, tcfg, params, tparams)
    return _MODELS[key]


def batch(cfg, B=2, S=32, seed=0):
    """The reference's smoke batch from a numpy seed: tokens as labels,
    and the enc-dec family's frame embeddings; (reference's, port's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        b["embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def assert_rel(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def test_the_port_has_the_reference_archs():
    assert T_ARCHS == ARCH_NAMES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_and_loss(arch):
    cfg, tcfg, params, tparams = smoke_model(arch)
    jb, tb = batch(cfg)
    loss, aux = jax.jit(lambda p, b: loss_fn(cfg, p, b))(params, jb)
    tloss, taux = T.loss_fn(tcfg, tparams, tb)
    assert tloss.shape == () and bool(torch.isfinite(tloss))
    assert abs(float(tloss) - float(loss)) <= REL * abs(float(loss))
    assert set(taux) == set(aux)
    if cfg.family == "moe":
        load = taux["expert_load"]
        assert tuple(load.shape) == (cfg.n_layers, cfg.n_experts)
        np.testing.assert_array_equal(load.numpy(),
                                      np.asarray(aux["expert_load"]))
        # all routed tokens accounted for
        assert int(load.sum()) == cfg.n_layers * 2 * 32 * \
            cfg.experts_per_token


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step(arch):
    """The reference's train-step smoke: two steps of ``make_train_step``
    on one batch from the reference's weights, in both packages; each
    step's loss finite and within REL of the reference's, the second not
    diverging, the moments' step 2, and the parameters moved."""
    from repro_torch.launch.steps import make_train_step as t_train_step
    from repro_torch.optim import AdamWConfig as TAdamWConfig
    from repro_torch.optim import adamw_init as t_adamw_init
    from repro_torch.optim import tree_items, tree_map
    cfg, tcfg, params, tparams = smoke_model(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_cfg, t_opt_cfg = AdamWConfig(**kw), TAdamWConfig(**kw)
    jb, tb = batch(cfg)
    step = jax.jit(make_train_step(cfg, opt_cfg))
    p1, o1, m1 = step(params, adamw_init(params, opt_cfg), jb)
    _, o2, m2 = step(p1, o1, jb)
    # the port updates in place: step a copy of the shared weights
    start = tree_map(lambda t: t.clone(), tparams)
    t_step = t_train_step(tcfg, t_opt_cfg)
    tp, to, tm1 = t_step(start, t_adamw_init(start, t_opt_cfg), tb)
    t1 = float(tm1["loss"])
    moved = sum(float((a - b).abs().sum()) for (_, a), (_, b) in
                zip(tree_items(tp), tree_items(tparams)))
    _, to, tm2 = t_step(tp, to, tb)
    losses = [t1, float(tm2["loss"])]
    assert np.all(np.isfinite(losses))
    for got, want in zip(losses, (m1["loss"], m2["loss"])):
        assert abs(got - float(want)) <= REL * abs(float(want))
    assert losses[1] < losses[0] + 1.0                   # not diverging
    assert int(to.step) == int(o2.step) == 2
    assert moved > 0.0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_two_tokens(arch):
    """Two decode steps from a zero cache at length 8 (the enc-dec
    family's cross cache zero too), as the reference's smoke runs them."""
    cfg, tcfg, params, tparams = smoke_model(arch)
    B, MAXLEN = 2, 64
    cache = init_decode_cache(cfg, B, MAXLEN)
    cache["len"] = jnp.asarray(8, jnp.int32)
    tcache = T.init_decode_cache(tcfg, B, MAXLEN, device="cpu")
    tcache["len"] = torch.tensor(8, dtype=torch.int32)
    assert set(tcache) == set(cache)
    step = jax.jit(lambda p, c, t: decode_step(cfg, p, c, t))
    tok = np.array([1, 2], np.int32)
    for i in range(2):
        logits, cache = step(params, cache, jnp.asarray(tok + i))
        tlogits, tcache = T.decode_step(tcfg, tparams, tcache,
                                        torch.from_numpy(tok + i))
        assert tuple(tlogits.shape) == (B, cfg.vocab_size)
        assert_rel(tlogits, logits)
    assert int(tcache["len"]) == int(cache["len"]) == 10


@pytest.mark.parametrize("arch", CONSISTENCY_ARCHS)
def test_prefill_then_decode_consistency(arch):
    """Prefill(tokens) then decode(next) equals forward over tokens + next
    — the cache's correctness per family: the port's against the
    reference's forward within REL, and against the port's own forward at
    the reference's bar (capacity 8: drops would, legitimately, break the
    equivalence)."""
    cfg, tcfg, params, tparams = smoke_model(arch, remat=False,
                                             capacity_factor=8.0)
    B, S = 1, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    embeds = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                  ).astype(np.float32)
              if cfg.family == "encdec" else None)
    jkw = {} if embeds is None else {"embeds": jnp.asarray(embeds)}
    tkw = {} if embeds is None else {"embeds": torch.from_numpy(embeds)}
    t = torch.from_numpy(toks)
    _, tcache = T.prefill(tcfg, tparams, t[:, :S], max_len=S + 8, **tkw)
    logits_d, _ = T.decode_step(tcfg, tparams, tcache, t[:, S])

    hidden, _, _ = forward(cfg, params, jnp.asarray(toks), **jkw)
    assert_rel(logits_d, logits_fn(cfg, params, hidden[:, -1:, :])[:, 0])
    th, _, _ = T.forward(tcfg, tparams, t, **tkw)
    own = T.logits_fn(tcfg, tparams, th[:, -1:, :])[:, 0]
    torch.testing.assert_close(logits_d, own, rtol=2e-3, atol=2e-3)


def test_applicability_rules():
    """The long_500k rule, as the reference's: 40 cells, 8 skipped, and
    the port's verdict and reason equal to the reference's in each."""
    n_run, n_skip = 0, 0
    assert list(T_SHAPES) == list(SHAPES)
    for arch in ARCH_NAMES:
        cfg, tcfg = get_config(arch), t_get_config(arch)
        for name, shape in SHAPES.items():
            ok, why = applicable(cfg, shape)
            assert t_applicable(tcfg, T_SHAPES[name]) == (ok, why)
            if ok:
                n_run += 1
            else:
                n_skip += 1
                assert shape.name == "long_500k"
                assert not cfg.sub_quadratic
    assert n_run + n_skip == 40
    assert n_skip == 8


def test_param_counts_match_reference():
    """``n_params`` and ``active_params`` equal the reference's for every
    arch, within the reference's sanity bounds."""
    approx = {"qwen3-32b": 32e9, "granite-8b": 8e9, "mistral-nemo-12b": 12e9,
              "llama3.2-3b": 3.2e9, "mamba2-2.7b": 2.7e9,
              "olmoe-1b-7b": 7e9, "grok-1-314b": 314e9,
              "qwen2-vl-72b": 72e9, "zamba2-7b": 7e9,
              "whisper-small": 0.24e9}
    assert set(approx) == set(T_ARCHS)
    for arch, want in approx.items():
        cfg, tcfg = get_config(arch), t_get_config(arch)
        got = tcfg.n_params()
        assert got == cfg.n_params()
        assert tcfg.active_params() == cfg.active_params()
        assert 0.5 * want < got < 1.9 * want, (arch, got, want)
    olmoe = t_get_config("olmoe-1b-7b")
    assert olmoe.active_params() < olmoe.n_params() / 4
