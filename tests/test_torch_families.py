"""The port's dense, VL and MoE serving (``smoke_reduce`` of granite-8b,
mistral-nemo-12b, qwen3-32b, qwen2-vl-72b, olmoe-1b-7b and grok-1-314b,
float32, no remat) against the JAX reference on the CPU, from the
reference's own ``init_params`` weights carried across by
``repro_torch.convert.model_params_from_jax``.

``forward``, ``prefill`` (logits and every cache entry, at the prompt's
length and at a longer ``max_len``), two decode steps and prefill-then-
decode against the reference's forward agree within 1e-4 relative to the
largest magnitude of the reference's value (``REL`` of
``test_torch_models.py``: the port's attention runs the flash kernel's
online-softmax function, and the float32 products differ in the last
bits).  The MoE's ``expert_load`` is equal exactly.  Also: the parameter
trees and counts, M-RoPE, the step builders, the launcher's default and
``distributed.ctx``'s flags.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.distributed import ctx as jctx  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decode_step, forward, prefill  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models.decode import decode_cache_specs  # noqa: E402
from repro.models.layers import apply_mrope as j_apply_mrope  # noqa: E402
from repro.models.model import logits_fn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.configs import ARCH_NAMES as T_ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

REL = 1e-4
DENSE_ARCHS = ["granite-8b", "mistral-nemo-12b", "qwen3-32b",
               "qwen2-vl-72b"]
MOE_ARCHS = ["olmoe-1b-7b", "grok-1-314b"]


def family_model(arch, **kw):
    """The reference's smoke config of ``arch`` (float32, no remat, with
    ``kw``), the port's equal one, the reference's weights and the port's
    copy of them."""
    cfg = dataclasses.replace(smoke_reduce(get_config(arch)), remat=False,
                              **kw)
    tcfg = dataclasses.replace(t_smoke(t_get_config(arch)), remat=False,
                               **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.model_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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
            assert_rel(tc[name], jc[name])


def pad_seq(a, n=8):
    """The reference's KV stack (L, B, S, K, hd) zero-padded along S."""
    return jnp.pad(a, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))


def check_forward(arch):
    cfg, tcfg, params, tparams = family_model(arch)
    toks = tokens(cfg, 2, 48)
    h, _, aux = forward(cfg, params, jnp.asarray(toks))
    th, cache, taux = T.forward(tcfg, tparams, torch.from_numpy(toks))
    assert cache is None
    assert_rel(th, h)
    assert set(taux) == set(aux)
    if cfg.family == "moe":
        load = taux["expert_load"]
        assert load.dtype == torch.int32
        assert tuple(load.shape) == (cfg.n_layers, cfg.n_experts)
        np.testing.assert_array_equal(load.numpy(),
                                      np.asarray(aux["expert_load"]))
        assert int(load.sum()) == cfg.n_layers * 2 * 48 * \
            cfg.experts_per_token


def check_loss(arch):
    """``loss_fn`` (the blockwise cross-entropy over the forward), and the
    MoE's ``expert_load`` in its aux."""
    from repro.models import loss_fn
    cfg, tcfg, params, tparams = family_model(arch)
    toks = tokens(cfg, 2, 32, seed=9)
    lj, aux = loss_fn(cfg, params, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks)})
    t = torch.from_numpy(toks)
    lt, taux = T.loss_fn(tcfg, tparams, {"tokens": t, "labels": t})
    assert abs(float(lt) - float(lj)) <= REL * abs(float(lj))
    assert set(taux) == set(aux)
    if "expert_load" in aux:
        np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                      np.asarray(aux["expert_load"]))


def check_prefill(arch):
    """Logits and caches at the prompt's length, and the caches at a
    longer ``max_len``: the reference's, zero-padded."""
    cfg, tcfg, params, tparams = family_model(arch)
    toks = tokens(cfg, 2, 40, seed=1)
    lj, cj = prefill(cfg, params, jnp.asarray(toks))
    lt, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert_rel(lt, lj)
    assert_caches(ct, cj)
    lt2, ct2 = T.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=48)
    assert torch.equal(lt2, lt)
    assert_caches(ct2, {**cj, "k": pad_seq(cj["k"]), "v": pad_seq(cj["v"])})
    with pytest.raises(ValueError, match="max_len"):
        T.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=39)


def check_two_decode_steps(arch):
    cfg, tcfg, params, tparams = family_model(arch)
    S = 16
    toks = tokens(cfg, 2, S + 2, seed=2)
    _, cj = prefill(cfg, params, jnp.asarray(toks[:, :S]))
    _, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]),
                      max_len=S + 8)
    cj["k"], cj["v"] = pad_seq(cj["k"]), pad_seq(cj["v"])
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
    tokens + next, within REL (capacity 8, as the reference's test sets
    it: capacity drops would, legitimately, break the equivalence)."""
    cfg, tcfg, params, tparams = family_model(arch, capacity_factor=8.0)
    B, S = 1, 16
    toks = tokens(cfg, B, S + 1, seed=3)
    t = torch.from_numpy(toks)
    _, cache = T.prefill(tcfg, tparams, t[:, :S], max_len=S + 8)
    logits_d, _ = T.decode_step(tcfg, tparams, cache, t[:, S])
    hidden, _, _ = forward(cfg, params, jnp.asarray(toks))
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


def check_param_count(arch):
    """The port's full-size init on the meta device holds
    ``ModelConfig.n_params()`` parameters, plus what the count leaves out:
    the vocabulary's padding to 256 and QK-norm's two weights a layer;
    and that count is sane (the reference's ``test_param_counts_sane``
    bounds)."""
    tcfg = t_get_config(arch)
    p = T.init_params(tcfg, 0, device="meta")
    n = sum(t.numel() for g in p.values()
            for t in (g.values() if isinstance(g, dict) else [g]))
    heads = 1 if tcfg.tie_embeddings else 2
    extra = ((T.padded_vocab(tcfg) - tcfg.vocab_size) * tcfg.d_model * heads
             + (2 * tcfg.n_layers * tcfg.head_dim if tcfg.qk_norm else 0))
    assert n == tcfg.n_params() + extra
    assert tcfg.n_params() == get_config(arch).n_params()
    approx = {"qwen3-32b": 32e9, "granite-8b": 8e9, "mistral-nemo-12b": 12e9,
              "olmoe-1b-7b": 7e9, "grok-1-314b": 314e9,
              "qwen2-vl-72b": 72e9}
    assert 0.5 * approx[arch] < n < 1.9 * approx[arch]


CHECKS = {"forward": check_forward, "loss": check_loss,
          "prefill": check_prefill,
          "two_decode_steps": check_two_decode_steps,
          "prefill_then_decode": check_prefill_then_decode,
          "layout": check_layout, "cache_specs": check_cache_specs,
          "param_count": check_param_count}


@pytest.mark.parametrize("check", list(CHECKS))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_and_vl_family_matches_jax(arch, check):
    CHECKS[check](arch)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,theta", [((2, 12, 3, 32), 1e6),
                                         ((1, 7, 2, 128), 1e4)])
def test_apply_mrope_matches_jax_with_three_streams(shape, theta):
    """Three different position streams (temporal, height, width), as an
    image's patches give them."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    pos3 = rng.integers(0, 500, (3,) + shape[:2]).astype(np.int32)
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mrope_of_text_is_rope_bit_for_bit():
    """Text-only input: three equal streams; the model with ``mrope`` gives
    the logits of the same model without it, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 9, 4, 32)).astype(np.float32))
    pos = torch.arange(9).expand(2, 9)
    assert torch.equal(TL.apply_mrope(x, TM._positions3(pos), 1e6),
                       TL.apply_rope(x, pos, 1e6))
    cfg = t_smoke(t_get_config("qwen2-vl-72b"))
    assert cfg.mrope
    params = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 2, 12, seed=6))
    for c in (cfg, dataclasses.replace(cfg, mrope=False)):
        logits, cache = T.prefill(c, params, toks, max_len=14)
        step, _ = T.decode_step(c, params, cache, toks[:, 0])
        if c.mrope:
            want = (logits, step)
    assert torch.equal(logits, want[0]) and torch.equal(step, want[1])


# ---------------------------------------------------------------------------
# step builders, the launcher, the flags
# ---------------------------------------------------------------------------

def test_prefill_and_serve_steps_match_jax():
    cfg, tcfg, params, tparams = family_model("qwen3-32b")
    toks = tokens(cfg, 2, 16, seed=7)
    lj, cj = jsteps.make_prefill_step(cfg)(params,
                                           {"tokens": jnp.asarray(toks)})
    lt, ct = tsteps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert_rel(lt, lj)
    assert_caches(ct, cj)
    # decode appends: the reference's cache padded, the port's built with
    # room for it
    cj["k"], cj["v"] = pad_seq(cj["k"]), pad_seq(cj["v"])
    _, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=24)
    nxt = toks[:, 0]
    lj, cj = jsteps.make_serve_step(cfg)(params, cj, jnp.asarray(nxt))
    lt, ct = tsteps.make_serve_step(tcfg)(tparams, ct, torch.from_numpy(nxt))
    assert_rel(lt, lj)
    assert_caches(ct, cj)


def test_serve_launcher_defaults_to_llama_and_serves_every_arch():
    """The launcher's ``--arch`` defaults to llama3.2-3b, as the
    reference's; its choices are the reference's archs, all ten, and each
    is served (``live`` on the CPU, the reference's 24 warm-up requests),
    the SSM and enc-dec families' included; an unknown arch is refused."""
    from repro.configs import ARCH_NAMES as J_ARCHS
    from repro_torch.launch import serve
    assert serve.parse_args([]).arch == "llama3.2-3b"
    assert T_ARCHS == J_ARCHS and len(T_ARCHS) == 10
    for name in T_ARCHS:
        assert serve.parse_args(["--arch", name]).arch == name
        cfg = t_smoke(t_get_config(name))
        stats, per_tok = serve.live(cfg, T.init_params(cfg, 0, device="cpu"),
                                    slots=4, device="cpu", max_steps=6)
        assert stats["steps"] == 6 and stats["tokens"] == 24, name
        assert per_tok > 0
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "mamba2-7b"])


def test_ctx_flags_match_jax():
    """The flags read what the context installs and restore on exit, as
    the reference's; the constraints are identities on one card."""
    for c in (jctx, tctx):
        assert (c.attn_bf16(), c.attn_remat(), c.moe_groups()) == \
            (False, False, 1)
    with jctx.activation_sharding(None, None, 1, 1, attn_bf16=True,
                                  attn_remat=True, moe_groups=4), \
            tctx.activation_sharding(None, None, 1, 1, attn_bf16=True,
                                     attn_remat=True, moe_groups=4):
        for c in (jctx, tctx):
            assert (c.attn_bf16(), c.attn_remat(), c.moe_groups()) == \
                (True, True, 4)
    assert (tctx.attn_bf16(), tctx.attn_remat(), tctx.moe_groups()) == \
        (False, False, 1)
    x = torch.ones(2, 3, 4)
    for fn in (tctx.constrain_boundary, tctx.constrain_tokens_grouped,
               lambda t: tctx.constrain_expert_weights(t, "up")):
        assert fn(x) is x


def test_attention_flags_are_not_read_by_the_port():
    """``attn_bf16`` and ``attn_remat`` feed only the reference's chunked
    attention; the port's prefill is the flash kernel (float32 scores), so
    its logits and caches are bit-equal with the flags on and off (ROADMAP
    §3)."""
    cfg = t_smoke(t_get_config("qwen3-32b"))
    params = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 2, 24, seed=8))
    base = T.prefill(cfg, params, toks)
    with tctx.activation_sharding(None, None, 1, 1, attn_bf16=True,
                                  attn_remat=True):
        flagged = T.prefill(cfg, params, toks)
    assert torch.equal(base[0], flagged[0])
    for name in ("k", "v"):
        assert torch.equal(base[1][name], flagged[1][name])
