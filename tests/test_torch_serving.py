"""The port's serving layer against the JAX reference on the CPU: the
request generator field for field, and continuous batching over the small
Zamba2 (``smoke_reduce`` of ``zamba2-7b``, float32) from the same weights —
the same steps, tokens and completions, logits within 1e-4 relative to
their largest magnitude (the model's tolerance, ``test_torch_models.py``),
and the same greedy tokens wherever the top two logits are further apart
than that."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.data import synthetic_requests  # noqa: E402
from repro.models import decode_step, init_decode_cache  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serving import ContinuousBatcher  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.data import synthetic_requests as t_requests  # noqa: E402
from repro_torch.launch.serve import live  # noqa: E402
from repro_torch.serving import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serving import ReplicaCostModel  # noqa: E402

REL = 1e-4


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kw", [
    {},
    {"mean_prompt": 8, "mean_gen": 16},
    {"mean_prompt": 2048, "mean_gen": 32, "heavy_tail": 1.15},
    {"arrival_rate": 5.0, "heavy_tail": 2.0},
])
def test_synthetic_requests_equal_reference(seed, kw):
    want = synthetic_requests(64, seed=seed, **kw)
    got = t_requests(64, seed=seed, **kw)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]


def test_supplied_arrivals_pass_through_and_are_checked():
    arr = np.linspace(0.0, 1.0, 10)
    got = t_requests(10, seed=3, arrivals=arr)
    want = synthetic_requests(10, seed=3, arrivals=arr)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    with pytest.raises(ValueError, match="arrivals"):
        t_requests(4, arrivals=arr)


def test_replica_cost_model_equals_reference():
    from repro.serving import ReplicaCostModel as JModel
    tokens = np.array([3, 40, 512])
    assert ReplicaCostModel(per_token=7e-6).cost(tokens) == \
        JModel(per_token=7e-6).cost(tokens)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(smoke_reduce(get_config("zamba2-7b")),
                              remat=False)
    tcfg = dataclasses.replace(t_smoke(t_get_config("zamba2-7b")),
                               remat=False)
    params = init_params(cfg, jax.random.PRNGKey(1))
    tparams = convert.model_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def _recording(step, log):
    def serve(p, c, t):
        logits, c = step(p, c, t)
        log.append(np.asarray(logits if not torch.is_tensor(logits)
                              else logits.numpy(), np.float32))
        return logits, c
    return serve


def test_continuous_batcher_matches_reference(model):
    cfg, tcfg, params, tparams = model
    slots, max_len = 4, 48
    reqs = dict(n=10, seed=5, mean_prompt=8, mean_gen=6)
    j_log, t_log = [], []
    jb = ContinuousBatcher(
        _recording(jax.jit(lambda p, c, t: decode_step(cfg, p, c, t)),
                   j_log), None, slots)
    jb.submit(synthetic_requests(**reqs))
    js = jb.run(params, init_decode_cache(cfg, slots, max_len),
                jnp.zeros((slots,), jnp.int32), max_steps=max_len)
    tb = TBatcher(_recording(
        lambda p, c, t: T.decode_step(tcfg, p, c, t), t_log), None, slots)
    tb.submit(t_requests(**reqs))
    ts = tb.run(tparams, T.init_decode_cache(tcfg, slots, max_len,
                                             device="cpu"),
                torch.zeros((slots,), dtype=torch.int32), max_steps=max_len)
    for key in ("steps", "tokens", "completed"):
        assert ts[key] == js[key], key
    assert ts["steps"] == len(t_log) == len(j_log) > 1
    assert [rid for rid, _ in tb.completed] == \
        [rid for rid, _ in jb.completed]
    for got, want in zip(t_log, j_log):
        bound = REL * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * bound
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


def test_live_serves_the_reference_warm_up(model):
    """``live`` with the reference launcher's defaults (its 24 warm-up
    requests, a zero cache) schedules as the reference's batcher does —
    which does not depend on the logits — and calibrates a positive
    per-token cost."""
    _, tcfg, _, tparams = model
    stats, per_tok = live(tcfg, tparams, slots=8, device="cpu",
                          max_len=64, max_steps=64)
    jb = ContinuousBatcher(lambda p, c, t: (jnp.zeros((8, 4)), c), None, 8)
    jb.submit(synthetic_requests(24, seed=0, mean_prompt=8, mean_gen=16))
    want = jb.run(None, {}, jnp.zeros((8,), jnp.int32), max_steps=64)
    for key in ("steps", "tokens", "completed"):
        assert stats[key] == want[key], key
    assert per_tok > 0 and per_tok == stats["wall"] / stats["tokens"]
