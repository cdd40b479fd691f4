"""The step-plan autotuner (the paper's selection at training-step
granularity, L2), the gradient compressor and the trainer's straggler
re-trigger in the port against the reference, on the CPU.

The tuners' decisions are compared exactly: both packages' steps advance
one injected clock (``time.perf_counter`` patched for both) by a seeded
cost per plan and call, so the two services see the same step times and
must choose the same plans.  ``PlanWhatIf`` prices and the compressors'
eager outputs are float64 / float32 arithmetic in the same order: exact.
"""

import dataclasses
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.distributed import EFCompressor as JEF  # noqa: E402
from repro.distributed import ExecutionPlan as JPlan  # noqa: E402
from repro.distributed import PlanWhatIf as JWhatIf  # noqa: E402
from repro.distributed import StepAutoTuner as JTuner  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.core.simpolicy import Candidate  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import (DEFAULT_PLANS, EFCompressor,  # noqa: E402
                                     ExecutionPlan, PlanWhatIf,
                                     StepAutoTuner, compression_ratio,
                                     make_plan_builder)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

TCFG = dataclasses.replace(t_smoke(t_get_config("llama3.2-3b")),
                           vocab_size=128)
CFG = dataclasses.replace(smoke_reduce(get_config("llama3.2-3b")),
                          vocab_size=128)
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
DATA = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
#: seconds a step of each plan takes on the injected clock
COST = {"mb1_remat": 1.00, "mb2_remat": 1.06, "mb4_remat": 1.13,
        "mb1_noremat": 0.81, "mb2_noremat": 0.86}


class Clock:
    """An injected ``time.perf_counter``: each built step advances it by
    its plan's cost times seeded noise (one draw per step call)."""

    def __init__(self, sigma=0.08, seed=0):
        self.t = 0.0
        self.rng = np.random.default_rng(seed)
        self.sigma = sigma

    def __call__(self):
        return self.t

    def builder(self, metrics):
        def build(plan):
            def step(params, opt, batch):
                self.t += COST[plan.name] * float(
                    np.exp(self.sigma * self.rng.standard_normal()))
                return params, opt, metrics()
            return step
        return build


def _tuner_runs(monkeypatch, method, n_steps=40, **kw):
    runs = []
    for tuner_cls, metrics in (
            (JTuner, lambda: {"loss": jnp.float32(1.0)}),
            (StepAutoTuner, lambda: {"loss": torch.tensor(1.0)})):
        clock = Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        plans = ([JPlan(**dataclasses.asdict(p)) for p in DEFAULT_PLANS]
                 if tuner_cls is JTuner else list(DEFAULT_PLANS))
        tuner = tuner_cls(plans, clock.builder(metrics), method=method,
                          seed=3, **kw)
        for _ in range(n_steps):
            tuner.step({}, {}, {})
        runs.append((tuner.history, tuner.selected_plan,
                     tuner.compile_times))
    return runs


@pytest.mark.parametrize("method", ["ExhaustiveSel", "QLearn",
                                    "SimPolicy", "RandomSel", "Hybrid"])
def test_tuner_decisions_equal_the_reference(monkeypatch, method):
    (jh, jsel, jct), (th, tsel, tct) = _tuner_runs(monkeypatch, method)
    assert [h[0] for h in th] == [h[0] for h in jh]
    assert [h[1] for h in th] == [h[1] for h in jh]
    assert tsel == jsel
    assert sorted(tct) == sorted(jct)
    if method in ("ExhaustiveSel", "QLearn", "Hybrid"):
        assert len({h[0] for h in th}) > 1     # it explored live
    if method == "SimPolicy":                  # priced, never explored
        assert {h[0] for h in th} == {"mb1_noremat"}


def test_plan_whatif_prices_equal_the_reference():
    plans = list(DEFAULT_PLANS) + [ExecutionPlan("mb2_int8", microbatches=2,
                                                 compress="int8"),
                                   ExecutionPlan("mb1_topk",
                                                 compress="topk")]
    jw = JWhatIf([JPlan(**dataclasses.asdict(p)) for p in plans])
    tw = PlanWhatIf(plans)
    rng = np.random.default_rng(1)
    for idx in [0, 0, 3, 1, 3, 5]:
        assert [tw.prior(p) for p in plans] == [jw.prior(p) for p in jw.plans]
        want = [o.loop_time for o in jw.price(jw.candidates())]
        got = [o.loop_time for o in tw.price(tw.candidates())]
        assert got == want
        t = float(rng.uniform(0.5, 2.0))
        jw.observe(idx, t)
        tw.observe(idx, t)
    assert tw.candidates() == [Candidate(i) for i in range(len(plans))]


def test_autotuner_explores_then_settles():
    """Ported from tests/test_system.py: three real plans on the CPU."""
    plans = [ExecutionPlan("mb1", microbatches=1),
             ExecutionPlan("mb2", microbatches=2),
             ExecutionPlan("mb1_noremat", microbatches=1, remat=False)]
    tuner = StepAutoTuner(plans, make_plan_builder(TCFG, OPT, device="cpu"),
                          method="ExhaustiveSel")
    params = init_params(TCFG, 0, device="cpu")
    opt = adamw_init(params, OPT)
    pipe = TokenPipeline(DATA)
    for step in range(8):
        batch = {k: torch.from_numpy(v) for k, v in
                 pipe.batch_at(step).items()}
        (params, opt, m), plan, dt = tuner.step(params, opt, batch)
        assert np.isfinite(float(m["loss"])) and dt > 0
    tried = {h[0] for h in tuner.history[:3]}
    assert tried == {"mb1", "mb2", "mb1_noremat"}    # explored all plans
    settled = {h[0] for h in tuner.history[3:]}
    assert len(settled) == 1                          # then exploited one
    assert sorted(tuner.compile_times) == [0, 1, 2]


@pytest.mark.parametrize("field", [{"attn_impl": "chunked"},
                                   {"fsdp": False}])
def test_plan_builder_refuses_options_the_port_does_not_read(field):
    """A plan that differs from its default twin only in ``attn_impl`` or
    ``fsdp`` would build the same step; the builder refuses it rather than
    let the tuner explore a copy."""
    build = make_plan_builder(TCFG, OPT, device="cpu")
    build(ExecutionPlan("default"))
    with pytest.raises(ValueError, match="same step"):
        build(ExecutionPlan("twin", **field))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_ef_compressor_equals_the_reference_called_eagerly(codec):
    rng = np.random.default_rng(7)
    grads = [{"w": rng.standard_normal((40, 30)).astype(np.float32),
              "b": {"c": rng.standard_normal(300).astype(np.float32)}}
             for _ in range(3)]
    jc, tc = JEF(codec, topk_frac=0.05), EFCompressor(codec, topk_frac=0.05)
    for g in grads:
        want = jc(jax.tree.map(jnp.asarray, g))
        got = tc(jax.tree.map(torch.from_numpy, g))
        for path in (("w",), ("b", "c")):
            w, t, jr, tr = want, got, jc.residual, tc.residual
            for k in path:
                w, t, jr, tr = w[k], t[k], jr[k], tr[k]
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert compression_ratio(codec, 0.05) == {"int8": 0.25,
                                              "topk": 0.1}[codec]


def test_ef_residual_carries_in_the_port_not_in_the_jitted_reference():
    """A deliberate difference (ROADMAP §3).  In the reference's jitted
    step the compressor's residual is a Python attribute set only while
    tracing: the same gradient twice gives the same output (no error
    feedback), and the attribute is left holding a tracer.  The port's
    eager step carries the residual: the second output differs, and the
    two together are within one quantisation step of twice the gradient."""
    g = np.array([1.0, -0.5, 0.25, 3.0, 0.0101], np.float32)
    jc = JEF("int8")
    f = jax.jit(lambda x: jc({"w": x})["w"])
    j1, j2 = np.asarray(f(jnp.asarray(g))), np.asarray(f(jnp.asarray(g)))
    np.testing.assert_array_equal(j1, j2)
    assert isinstance(jc.residual["w"], jax.core.Tracer)
    tc = EFCompressor("int8")
    t1 = tc({"w": torch.from_numpy(g)})["w"].numpy()
    t2 = tc({"w": torch.from_numpy(g)})["w"].numpy()
    np.testing.assert_array_equal(t1, j1)    # the first step agrees
    assert not np.array_equal(t1, t2)
    assert np.abs(2 * g - (t1 + t2)).max() <= 3.0 / 127.0 + 1e-6


# ---------------------------------------------------------------------------
# the trainer's straggler re-trigger
# ---------------------------------------------------------------------------

def test_straggler_retrigger_reopens_the_search_in_the_port(monkeypatch,
                                                            tmp_path):
    """A deliberate difference (ROADMAP §3).  A step 3x slower than the
    mean of the earlier ones, under ExhaustiveSel: the reference's
    re-trigger reads ``service._record(region).selector``, which its
    RegionRecord no longer has, and the run dies with AttributeError; the
    port re-opens the policy's exploration and explores every plan
    again."""
    times = iter([1.0] * 5 + [3.0] + [1.0] * 10)
    clock = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["t"])

    def builder(metrics):
        def build(plan):
            def step(params, opt, batch):
                clock["t"] += next(times)
                return params, opt, metrics()
            return step
        return build

    plans = [ExecutionPlan("a"), ExecutionPlan("b", microbatches=2)]
    jtuner = JTuner([JPlan(**dataclasses.asdict(p)) for p in plans],
                    builder(lambda: {"loss": jnp.float32(1.0)}),
                    method="ExhaustiveSel")
    jtr = JTrainer(CFG, JAdamWConfig(), JDataConfig(128, 16, 4),
                   JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                  ckpt_every=100),
                   autotuner=jtuner)
    old = signal.getsignal(signal.SIGTERM)
    with pytest.raises(AttributeError, match="selector"):
        jtr.train(8)
    times = iter([1.0] * 5 + [3.0] + [1.0] * 10)
    tuner = StepAutoTuner(plans, builder(lambda: {"loss": torch.tensor(1.0)}),
                          method="ExhaustiveSel")
    tr = Trainer(TCFG, OPT, DATA,
                 TrainerConfig(ckpt_dir=str(tmp_path / "t"), ckpt_every=100),
                 autotuner=tuner, device="cpu")
    out = tr.train(9)
    signal.signal(signal.SIGTERM, old)
    assert out["final_step"] == 9
    names = [h[0] for h in tuner.history]
    # explore a, b; exploit (the tie goes to a) x 4, the slow step
    # re-opens the search: a, b again, then exploit
    assert names[:2] == ["a", "b"] and names[6:8] == ["a", "b"]
