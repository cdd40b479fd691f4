"""The port's hybrid model (Zamba2, ``smoke_reduce`` of ``zamba2-7b``,
float32, no remat) against the JAX reference on the CPU, from the
reference's own ``init_params`` weights carried across by
``repro_torch.convert.model_params_from_jax``.

``forward``, ``prefill`` (logits and every cache entry) and decode steps
agree within 1e-4 relative to the largest magnitude of the reference's
value: the port's attention runs the flash kernel's online-softmax
function where the reference forms the whole score matrix, its SSD scan
and norms sum in another order, and the layers' float32 products differ
in the last bits.  The reference's own contract, "prefill then decode
equals forward" (``tests/test_models_smoke.py``), holds for the port at
the reference's bar.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.models import decode_step, forward, prefill  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models.decode import decode_cache_specs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402

REL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(smoke_reduce(get_config("zamba2-7b")),
                              remat=False)
    tcfg = dataclasses.replace(t_smoke(t_get_config("zamba2-7b")),
                               remat=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.model_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _tokens(cfg, B, S, seed=0):
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


def _assert_caches(tc, jc):
    assert set(tc) == set(jc)
    for name in jc:
        if name == "len":
            assert int(tc[name]) == int(jc[name])
            assert tc[name].dtype == torch.int32
        else:
            assert_rel(tc[name], jc[name])


def test_converted_weights_keep_structure_and_dtype(model):
    cfg, tcfg, params, tparams = model
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in tparams.values())
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_bfloat16_weights_cross_bit_for_bit():
    tree = {"a": np.asarray(jnp.asarray([1.0, -2.5, 3e-3], jnp.bfloat16)),
            "n": {"b": np.arange(4, dtype=np.int32)}}
    out = convert.model_params_from_jax(tree, device="cpu")
    assert out["a"].dtype == torch.bfloat16
    assert out["n"]["b"].dtype == torch.int32
    np.testing.assert_array_equal(out["a"].float().numpy(),
                                  tree["a"].astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_matches_reference_layout(dtype):
    cfg = dataclasses.replace(smoke_reduce(get_config("zamba2-7b")),
                              param_dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(t_get_config("zamba2-7b")),
                               param_dtype=dtype)
    jp = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    tp = T.init_params(tcfg, 0, device="cpu")
    assert set(tp) == set(jp) == {"embed", "final_norm", "lm_head",
                                  "layers", "shared_attn"}
    for group in ("layers", "shared_attn"):
        assert set(tp[group]) == set(jp[group])
        for name, spec in jp[group].items():
            assert tuple(tp[group][name].shape) == spec.shape
            assert str(tp[group][name].dtype).endswith(str(spec.dtype))
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[name].shape) == jp[name].shape


def test_cache_specs_match_reference():
    cfg = smoke_reduce(get_config("zamba2-7b"))
    tcfg = t_smoke(t_get_config("zamba2-7b"))
    js = decode_cache_specs(cfg, 3, 40)
    ts = T.decode_cache_specs(tcfg, 3, 40)
    assert set(js) == set(ts)
    for name, spec in js.items():
        assert ts[name].shape == spec.shape
        assert str(ts[name].dtype).endswith(str(spec.dtype))


def test_forward_matches_jax(model):
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, 64)
    h, _, _ = forward(cfg, params, jnp.asarray(toks))
    th, cache, aux = T.forward(tcfg, tparams, torch.from_numpy(toks))
    assert cache is None and aux == {}
    assert_rel(th, h)


def test_prefill_matches_jax(model):
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, 64, seed=1)
    lj, cj = prefill(cfg, params, jnp.asarray(toks))
    lt, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert_rel(lt, lj)
    _assert_caches(ct, cj)


def _pad_seq(a, axis, n=8):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n)
    return jnp.pad(a, pad)


def test_two_decode_steps_match_jax(model):
    cfg, tcfg, params, tparams = model
    S = 16
    toks = _tokens(cfg, 2, S + 2, seed=2)
    _, cj = prefill(cfg, params, jnp.asarray(toks[:, :S]))
    _, ct = T.prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]),
                      max_len=S + 8)
    cj["k"], cj["v"] = _pad_seq(cj["k"], 2), _pad_seq(cj["v"], 2)
    _assert_caches(ct, cj)
    for i in range(2):
        nxt = toks[:, S + i]
        lj, cj = decode_step(cfg, params, cj, jnp.asarray(nxt))
        lt, ct = T.decode_step(tcfg, tparams, ct, torch.from_numpy(nxt))
        assert_rel(lt, lj)
        _assert_caches(ct, cj)


def test_prefill_then_decode_equals_forward(model):
    """The reference's cache contract, for the port: prefill(tokens) then
    decode(next) equals forward over tokens + next (the reference's bar,
    2e-3)."""
    _, tcfg, _, tparams = model
    B, S = 1, 16
    toks = torch.from_numpy(_tokens(tcfg, B, S + 1, seed=3))
    _, cache = T.prefill(tcfg, tparams, toks[:, :S], max_len=S + 8)
    logits_d, _ = T.decode_step(tcfg, tparams, cache, toks[:, S])
    hidden, _, _ = T.forward(tcfg, tparams, toks)
    want = T.logits_fn(tcfg, tparams, hidden[:, -1:, :])[:, 0]
    torch.testing.assert_close(logits_d, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "whisper-small"])
def test_ssm_and_encdec_forward_collects_the_reference_caches(arch):
    """The SSM and enc-dec families' ``forward`` with ``collect_cache``
    (the prefill trunk) from the reference's weights: the hidden states
    and the raw caches in the reference's structure (the SSM's stacked
    conv windows and states; the enc-dec's decoder (k, v), cross xk and
    xv), within REL; ``max_len`` pads only the decoder's k and v."""
    cfg = dataclasses.replace(smoke_reduce(get_config(arch)), remat=False)
    tcfg = dataclasses.replace(t_smoke(t_get_config(arch)), remat=False)
    params = init_params(cfg, jax.random.PRNGKey(1))
    tparams = convert.model_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    toks = _tokens(cfg, 2, 32, seed=4)
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)
                               ).astype(np.float32)
           if cfg.family == "encdec" else None)
    jkw = {} if emb is None else {"embeds": jnp.asarray(emb)}
    tkw = {} if emb is None else {"embeds": torch.from_numpy(emb)}
    h, jc, _ = forward(cfg, params, jnp.asarray(toks), collect_cache=True,
                       **jkw)
    th, tc, _ = T.forward(tcfg, tparams, torch.from_numpy(toks),
                          collect_cache=True, max_len=40, **tkw)
    assert_rel(th, h)
    if cfg.family == "ssm":
        assert set(tc) == set(jc) == {"conv", "state"}
        for name in jc:
            assert_rel(tc[name], jc[name])
    else:
        ((k, v), xk, xv), ((jk, jv), jxk, jxv) = tc, jc
        for got, want in ((k, jk), (v, jv)):
            assert got.shape[2] == 40
            assert not bool(got[:, :, 32:].any())
            assert_rel(got[:, :, :32], want)
        for got, want in ((xk, jxk), (xv, jxv)):
            assert_rel(got, want)


def test_entry_points_default_to_the_card():
    tcfg = t_smoke(t_get_config("zamba2-7b"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_decode_cache(tcfg, 2, 8)
