"""The port's learned-selection training on the CPU against the reference:
``TransitionDataset``, ``gelu_mlp`` / ``forward``, one AdamW step, 40
training steps from one start, checkpoints across the two packages, the
export's normalization fold and ``distill_ladder``; and within the port,
the trainer's checkpoint/restart discipline (bit-identical resume,
failure-restart equivalence, SIGTERM final save) and the two learnability
bars of ``tests/test_learned.py``, held to the port's own trainer.

Tolerances (float32, XLA's CPU code against torch's): ``gelu_mlp`` /
``forward`` within 1e-6 of the output's largest magnitude, and one AdamW
step within 1e-6 absolute on parameters and moments of order one (a few
ulp: products and sums in another order, the tanh and cos of another
library); 40 training steps within 1e-4 relative on every logged loss, with
the same argmin picks (the differences compound over the steps).
"""

import json
import os
import signal

import numpy as np
import pytest

import jax.numpy as jnp
from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.core.learned import distill_ladder as j_distill
from repro.models.layers import gelu_mlp as j_gelu_mlp
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.adamw import schedule_lr as j_schedule_lr
from repro.runtime.policy_trainer import PolicyTrainer as JTrainer
from repro.runtime.policy_trainer import PolicyTrainerConfig as JConfig
from repro.runtime.policy_trainer import TransitionDataset as JDataset
from repro.runtime.policy_trainer import forward as j_forward

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import policy_trainer_state_from_jax  # noqa: E402
from repro_torch.core import (FEATURE_NAMES, N_ALGORITHMS,  # noqa: E402
                              N_FEATURES, distill_ladder)
from repro_torch.core.learned import (mlp_forward,  # noqa: E402
                                      params_from_state)
from repro_torch.models.layers import gelu_mlp  # noqa: E402
from repro_torch.optim import (AdamWConfig, AdamWState,  # noqa: E402
                               adamw_update, schedule_lr)
from repro_torch.runtime import (PolicyTrainer,  # noqa: E402
                                 PolicyTrainerConfig, SimulatedFailure,
                                 TransitionDataset, train_policy_state)
from repro_torch.runtime.policy_trainer import forward  # noqa: E402

CPU = "cpu"


def synth_arrays(n=192, seed=0, n_actions=N_ALGORITHMS):
    """The synthetic translog of ``tests/test_learned.py``: the best
    algorithm flips on the sign of feature 0 (a learnable threshold rule
    with a known ladder form)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    costs = rng.uniform(1.0, 2.0, size=(n, n_actions))
    best = np.where(X[:, 0] > 0.0, 3, 7)
    costs[np.arange(n), best] = 0.5
    return {
        "features": X, "costs": costs.astype(np.float32),
        "libs": np.zeros((n, n_actions), np.float32),
        "chosen": np.zeros(n, np.int16),
        "measured": np.zeros(n, np.float32),
        "cell": (np.arange(n) % 2).astype(np.int32),
        "step": np.zeros(n, np.int32),
        "perturbed": np.zeros(n, np.bool_),
        "cell_keys": np.array(["a|x", "b|y"]),
    }


def _cfg(cls, tmp, n_steps=40, **kw):
    return cls(ckpt_dir=str(tmp), hidden=8, n_steps=n_steps, batch_size=32,
               ckpt_every=10, async_ckpt=False, **kw)


def _trainer(tmp, arrays, n_steps=40, **kw):
    return PolicyTrainer(TransitionDataset(arrays), _cfg(
        PolicyTrainerConfig, tmp, n_steps, **kw), device=CPU)


def _jax_trainer(tmp, arrays, n_steps=40):
    return JTrainer(JDataset(arrays), _cfg(JConfig, tmp, n_steps))


class _NumpyState:
    """The reference's AdamWState as numpy arrays."""

    def __init__(self, opt):
        self.step = np.asarray(opt.step)
        self.m = {k: np.asarray(v) for k, v in opt.m.items()}
        self.v = {k: np.asarray(v) for k, v in opt.v.items()}


def _converted_init(jt):
    params, opt = jt._init_state()
    return policy_trainer_state_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, _NumpyState(opt),
        device=CPU)


def _start_from(tmp, state):
    """Save ``state`` as the step-0 checkpoint of ``tmp``: a trainer there
    starts from it."""
    params, opt = state
    CheckpointManager(str(tmp)).save(0, {"params": params, "opt": opt})


def _params_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# dataset, net, optimizer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("holdout", [(), ("b|y",), ("a|x",)])
def test_transition_dataset_equals_reference(holdout):
    arrays = synth_arrays()
    ds, jds = TransitionDataset(arrays, holdout), JDataset(arrays, holdout)
    for name in ("train_idx", "holdout_idx", "mu", "sigma", "Y", "X"):
        assert np.array_equal(getattr(ds, name), getattr(jds, name)), name
    assert ds.n_train == jds.n_train and ds.holdout_cells == jds.holdout_cells
    for step in (0, 5, 123):
        for a, b in zip(ds.batch_at(step, 16), jds.batch_at(step, 16)):
            assert np.array_equal(a, b)
    for which in ("train", "holdout"):
        for a, b in zip(ds.split(which), jds.split(which)):
            assert np.array_equal(a, b)
    X = arrays["features"][:7]
    assert np.array_equal(ds.normalize(X), jds.normalize(X))


def test_transition_dataset_holdout_split():
    arrays = synth_arrays()
    ds = TransitionDataset(arrays, holdout_cells=["b|y"])
    assert ds.n_train == 96 and len(ds.holdout_idx) == 96
    assert set(ds.cell[ds.holdout_idx]) == {1}
    with pytest.raises(ValueError):
        TransitionDataset(arrays, holdout_cells=["nope|nope"])
    x1, y1 = ds.batch_at(5, 16)
    x2, y2 = ds.batch_at(5, 16)
    np.testing.assert_array_equal(x1, x2)    # pure in (seed, step)
    assert y1.shape == (16, N_ALGORITHMS)


def _net(seed, h=24, a=N_ALGORITHMS):
    """Weights at the trainer's He-normal scale, biases of 0.1."""
    rng = np.random.default_rng(seed)
    shapes = {"w0": (N_FEATURES, h), "b0": (h,), "w1": (h, h), "b1": (h,),
              "w2": (h, a), "b2": (a,)}
    return {k: (rng.standard_normal(s) * (np.sqrt(2.0 / s[0]) if len(s) > 1
                                         else 0.1)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gelu_mlp_and_forward_equal_reference(seed):
    p = _net(seed)
    x = np.random.default_rng(seed + 10).standard_normal(
        (64, N_FEATURES)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    h = np.random.default_rng(seed + 20).standard_normal(
        (64, 24)).astype(np.float32)
    got = gelu_mlp(torch.from_numpy(h), tp["w1"], tp["b1"], tp["w2"],
                   tp["b2"]).numpy()
    want = np.asarray(j_gelu_mlp(jnp.asarray(h), p["w1"], p["b1"], p["w2"],
                                 p["b2"]))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    got = forward(tp, torch.from_numpy(x)).numpy()
    want = np.asarray(j_forward({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_equals_reference(schedule):
    for cfg_kw in ({"warmup_steps": 10, "total_steps": 100},
                   {"warmup_steps": 0, "total_steps": 1}):
        cfg = AdamWConfig(schedule=schedule, **cfg_kw)
        jcfg = JAdamWConfig(schedule=schedule, **cfg_kw)
        for step in (0, 1, 9, 10, 11, 55, 99, 100, 250):
            got = float(schedule_lr(cfg, torch.tensor(step, dtype=torch.int32)))
            want = float(j_schedule_lr(jcfg, jnp.asarray(step, jnp.int32)))
            assert abs(got - want) <= 1e-6 * cfg.lr, (step, got, want)


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_update_equals_reference(schedule, clip):
    """One update from a mid-run state (step 7, moments not zero): the
    clip active (global norm ~90 against 1) or not (against 1e3)."""
    rng = np.random.default_rng(3)
    params = _net(4, h=16)
    grads = {k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    m = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in params.items()}
    v = {k: np.abs(0.1 * rng.standard_normal(x.shape)).astype(np.float32)
         for k, x in params.items()}
    kw = dict(lr=3e-3, weight_decay=1e-2, warmup_steps=5, total_steps=40,
              schedule=schedule, clip_norm=1.0 if clip == "active" else 1e3)
    step = np.int32(7)
    jp, jopt, jmet = j_adamw_update(
        {k: jnp.asarray(x) for k, x in grads.items()},
        JAdamWState(step=jnp.asarray(step), m=m, v=v),
        {k: jnp.asarray(x) for k, x in params.items()}, JAdamWConfig(**kw))
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}  # noqa: E731
    pp, popt, pmet = adamw_update(
        t(grads), AdamWState(step=torch.tensor(step), m=t(m), v=t(v)),
        t(params), AdamWConfig(**kw))
    gnorm = float(jmet["grad_norm"])
    assert (gnorm > kw["clip_norm"]) == (clip == "active")
    assert abs(float(pmet["grad_norm"]) - gnorm) <= 1e-6 * gnorm
    assert abs(float(pmet["lr"]) - float(jmet["lr"])) <= 1e-6 * kw["lr"]
    assert int(popt.step) == int(jopt.step) == 8
    for got, want in ((pp, jp), (popt.m, jopt.m), (popt.v, jopt.v)):
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)


def test_forty_steps_from_one_start_equal_reference(tmp_path):
    arrays = synth_arrays()
    jt = _jax_trainer(tmp_path / "jax", arrays)
    _start_from(tmp_path / "port", _converted_init(jt))
    tr = _trainer(tmp_path / "port", arrays)
    jres, res = jt.train(), tr.train()
    jl, pl = np.asarray(jres["losses"]), np.asarray(res["losses"])
    assert len(pl) == len(jl) == 40
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    x = tr.ds.normalize(arrays["features"]).astype(np.float32)
    picks = forward(res["params"], torch.from_numpy(x)).argmin(1).numpy()
    jpicks = np.asarray(j_forward(jres["params"], jnp.asarray(x))).argmin(1)
    assert np.array_equal(picks, jpicks)
    assert tr.regret(res["params"], "train") == \
        jt.regret(jres["params"], "train")


# ---------------------------------------------------------------------------
# the trainer's checkpoint/restart discipline, within the port
# ---------------------------------------------------------------------------

def test_policy_trainer_resume_bit_identical(tmp_path):
    """An interrupted run restored from its checkpoint replays to EXACTLY
    the uninterrupted result — batches are pure in (seed, step)."""
    arrays = synth_arrays()
    clean = _trainer(tmp_path / "clean", arrays).train()
    tr = _trainer(tmp_path / "cut", arrays)
    tr.train(20)                           # "the process died at step 20"
    resumed = _trainer(tmp_path / "cut", arrays).train()
    assert resumed["final_step"] == clean["final_step"] == 40
    assert _params_equal(clean["params"], resumed["params"])
    assert _params_equal(clean["opt"].m, resumed["opt"].m)
    assert _params_equal(clean["opt"].v, resumed["opt"].v)


def test_policy_trainer_failure_restart_equivalence(tmp_path):
    """Injected node failures (restore latest + replay) reach the same
    final parameters as a clean run."""
    arrays = synth_arrays()
    clean = _trainer(tmp_path / "clean", arrays).train()
    faulty = _trainer(tmp_path / "faulty", arrays, failure_rate=0.1,
                      failure_seed=7).train()
    assert faulty["restarts"] > 0, "failure injection never fired"
    assert _params_equal(clean["params"], faulty["params"])
    assert faulty["final_step"] == 40


def test_policy_trainer_gives_up_after_max_restarts(tmp_path):
    with pytest.raises(SimulatedFailure):
        _trainer(tmp_path, synth_arrays(), failure_rate=1.0,
                 max_restarts=3).train()


def test_policy_trainer_sigterm_final_save(tmp_path):
    """SIGTERM mid-run: the loop finishes the current step, takes a final
    synchronous checkpoint at that step, and a relaunch resumes to the
    uninterrupted result."""
    arrays = synth_arrays()
    tr = _trainer(tmp_path / "pre", arrays)
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        orig = tr.ds.batch_at
        calls = {"n": 0}

        def batch_at(step, batch_size):
            calls["n"] += 1
            if calls["n"] == 14:
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(step, batch_size)

        tr.ds.batch_at = batch_at
        out = tr.train()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["preempted"] and out["final_step"] == 14
    assert tr.ckpt.latest_step() == 14     # the final save, not step 10
    tr.ds.batch_at = orig
    resumed = _trainer(tmp_path / "pre", arrays).train()
    clean = _trainer(tmp_path / "clean", arrays).train()
    assert _params_equal(clean["params"], resumed["params"])


def test_async_checkpoints_and_their_errors(tmp_path):
    tr = PolicyTrainer(TransitionDataset(synth_arrays()), PolicyTrainerConfig(
        ckpt_dir=str(tmp_path), hidden=8, n_steps=30, batch_size=32,
        ckpt_every=10, async_ckpt=True), device=CPU)
    out = tr.train()
    assert tr.ckpt.all_steps() == [10, 20, 30] and out["final_step"] == 30
    mgr = CheckpointManager(str(tmp_path / "bad"))
    mgr.async_save(1, {"x": object()})   # an object array: the write fails
    with pytest.raises(ValueError, match="allow_pickle"):
        mgr.wait()
    mgr.wait()                               # raised once, then clear


def test_train_policy_state_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_policy_state(synth_arrays(), str(tmp_path))


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _state_pair(tmp_path):
    """The same trainer state as the reference's tree and the port's, with
    a bfloat16 leaf beside the float32 and int32 ones."""
    jt = _jax_trainer(tmp_path / "init", synth_arrays())
    jparams, jopt = jt._init_state()
    params, opt = _converted_init(jt)
    bf = np.arange(-6, 6, dtype=np.float32) / 7
    jtree = {"params": jparams, "opt": jopt,
             "extra": {"bf16": jnp.asarray(bf, jnp.bfloat16)}}
    tree = {"params": params, "opt": opt,
            "extra": {"bf16": torch.from_numpy(bf).to(torch.bfloat16)}}
    return jtree, tree


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages(tmp_path, writer):
    jtree, tree = _state_pair(tmp_path)
    port, ref = CheckpointManager(str(tmp_path / "p")), JCkpt(
        str(tmp_path / "r"))
    port.save(3, tree)
    ref.save(3, jtree)
    mp, mr = ({k: v for k, v in json.load(open(os.path.join(
        d, "step_000000003", "manifest.json")))["arrays"].items()}
        for d in (port.dir, ref.dir))
    assert mp == mr                          # keys, files, shapes, dtypes
    assert set(mp) >= {"params/w0", "params/b2", "opt/.step", "opt/.m/w0",
                       "opt/.v/b1", "extra/bf16"}
    src = port if writer == "port" else ref
    back = CheckpointManager(src.dir).restore(3, tree)
    jback = JCkpt(src.dir).restore(3, jtree)
    for k in ("params", "extra"):
        for name, t in back[k].items():
            want = tree[k][name]
            assert t.dtype == want.dtype and torch.equal(t, want)
            assert np.array_equal(np.asarray(jback[k][name], np.float32),
                                  want.float().numpy())
    assert int(back["opt"].step) == int(jback["opt"].step) == 0
    for name in tree["params"]:
        assert torch.equal(back["opt"].m[name], tree["opt"].m[name])
        assert np.array_equal(np.asarray(jback["opt"].v[name]),
                              tree["opt"].v[name].numpy())


def test_checkpoint_keep_and_restore_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(3), "s": torch.tensor(1, dtype=torch.int32)}
    for step in (1, 2, 3):
        mgr.save(step, tree)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    with pytest.raises(KeyError):
        mgr.restore(3, {"w": torch.ones(3), "z": torch.ones(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(3, {"w": torch.ones(4), "s": tree["s"]})


# ---------------------------------------------------------------------------
# export and distillation
# ---------------------------------------------------------------------------

def _trained_pair(tmp_path, n=192, steps=40):
    """The reference's trained params, and the port's trainer holding the
    same dataset, with those params as tensors."""
    arrays = synth_arrays(n=n)
    jt = _jax_trainer(tmp_path / "jax", arrays, steps)
    jparams = jt.train()["params"]
    params = {k: torch.from_numpy(np.asarray(v).copy())
              for k, v in jparams.items()}
    return arrays, jt, jparams, _trainer(tmp_path / "port", arrays), params


def test_export_state_folds_normalization(tmp_path):
    arrays, jt, jparams, tr, params = _trained_pair(tmp_path)
    state = tr.export_state(params, meta={"tag": 1})
    assert state == jt.export_state(jparams, meta={"tag": 1})
    # the deployed numpy forward on RAW rows == the training-side net on
    # normalized rows
    X = arrays["features"]
    deployed = mlp_forward(params_from_state(state["params"]), X)
    trained = forward(params, torch.from_numpy(
        tr.ds.normalize(X).astype(np.float32))).detach().numpy()
    np.testing.assert_allclose(deployed, trained, rtol=0, atol=1e-4)
    assert np.array_equal(deployed.argmin(1), trained.argmin(1))


@pytest.mark.parametrize("max_depth", [1, 2, 3])
def test_distill_ladder_equals_reference(tmp_path, max_depth):
    arrays, jt, jparams, tr, params = _trained_pair(tmp_path, n=400)
    state = tr.export_state(params)
    X = arrays["features"]
    ladder = distill_ladder(state, X, max_depth=max_depth)
    jladder = j_distill(state, X, max_depth=max_depth)
    assert ladder.describe() == jladder.describe()
    assert ladder.teacher_agreement == jladder.teacher_agreement
    assert ladder.n_leaves == jladder.n_leaves
    assert np.array_equal(ladder.predict(X), jladder.predict(X))
    held = np.random.default_rng(5).normal(size=(50, N_FEATURES))
    assert np.array_equal(ladder.predict(held), jladder.predict(held))


# ---------------------------------------------------------------------------
# the learnability bars of tests/test_learned.py, on the port's trainer
# ---------------------------------------------------------------------------

def test_policy_trainer_export_folds_normalization(tmp_path):
    """The exported state consumes RAW feature rows: normalization is
    folded into the first layer, and the deployed numpy forward matches
    the training-side ranking."""
    arrays = synth_arrays()
    tr = _trainer(tmp_path, arrays, n_steps=600)
    result = tr.train()
    state = tr.export_state(result["params"])
    params = params_from_state(state["params"])
    X = arrays["features"]
    pick = np.argmin(mlp_forward(params, X), axis=1)
    best = np.argmin(arrays["costs"], axis=1)
    assert (pick == best).mean() > 0.9     # the rule is learnable
    # regret through the deployed path matches the trainer's measure
    assert tr.regret(result["params"], "train") < 0.05


def test_distill_ladder_recovers_threshold_rule(tmp_path):
    arrays = synth_arrays(n=400)
    tr = _trainer(tmp_path, arrays, n_steps=600)
    state = tr.export_state(tr.train()["params"])
    ladder = distill_ladder(state, arrays["features"], max_depth=2)
    assert ladder.teacher_agreement > 0.9
    # the ladder is the known generating rule: a split on feature 0
    pred = ladder.predict(arrays["features"])
    best = np.argmin(arrays["costs"], axis=1)
    assert (pred == best).mean() > 0.85
    rules = ladder.describe()
    assert 1 < len(rules) <= 4
    assert any(FEATURE_NAMES[0] in r for r in rules)
