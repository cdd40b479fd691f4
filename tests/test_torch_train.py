"""The training path in the port against the reference, on the CPU: the
token pipeline, the loss and its gradients, the train step of every
execution plan, the in-place AdamW, the fault-tolerant trainer and the
launcher; and the SSM and hybrid families' remat.

The model is the reference's test config (``tests/test_system.py``: the
smoke llama3.2-3b, vocab 128) in float32, with the reference's weights
carried over by ``repro_torch.convert``; the SSM and hybrid families
(mamba2-2.7b, zamba2-7b) at the same cut train through the same plans and
the launcher.  Tolerances, with their reasons:

* the loss within 1e-5 relative and every gradient leaf within 1e-4 of
  its largest magnitude: the same float32 function, with products and
  sums in another order (XLA's CPU dots against torch's);
* losses over 8 steps of each plan within 1e-4 relative: AdamW's first
  steps turn each gradient into about its sign, so an element whose
  gradient is near 0 moves by up to 2 * lr in either package; elements
  whose first gradient is well above AdamW's eps (1e-8) are held within
  1e-5 after the first step, and the rest are counted;
* ``TokenPipeline`` batches and the in-place AdamW update: bit for bit.
"""

import dataclasses
import itertools
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402,E501
from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.distributed import DEFAULT_PLANS as J_PLANS  # noqa: E402
from repro.distributed import make_plan_builder as j_plan_builder  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.convert import (model_opt_state_from_jax,  # noqa: E402
                                 model_params_from_jax)
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import DEFAULT_PLANS, make_plan_builder  # noqa: E402,E501
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.steps import (make_train_step,  # noqa: E402
                                      value_and_grad)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import (AdamWConfig, AdamWState,  # noqa: E402
                               adamw_init, adamw_update, adamw_update_,
                               tree_items, tree_leaves, tree_map)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

CFG = dataclasses.replace(smoke_reduce(get_config("llama3.2-3b")),
                          vocab_size=128)
TCFG = dataclasses.replace(t_smoke(t_get_config("llama3.2-3b")),
                           vocab_size=128)
J_OPT = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
J_DATA = JDataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
DATA = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
STEP_LOSS_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jparams(remat=True):
    cfg = dataclasses.replace(CFG, remat=remat)
    return cfg, JM.init_params(cfg, jax.random.PRNGKey(0))


def _tparams(jparams):
    return model_params_from_jax(_np_tree(jparams), device="cpu")


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _max_rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vocab_size=128, seq_len=16,
                                     global_batch=4, seed=3),
                                dict(vocab_size=128256, seq_len=64,
                                     global_batch=3, seed=0)])
def test_token_pipeline_bit_equal(kw):
    jp, tp = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
    for step in (0, 1, 17, 1000):
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_dense_loss_and_gradients_match_reference(remat):
    cfg, jp = _jparams(remat)
    tcfg = dataclasses.replace(TCFG, remat=remat)
    batch = JTokenPipeline(J_DATA).batch_at(5)
    (jloss, _), jg = jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True)(jp, _jbatch(batch))
    (tloss, _), tg = value_and_grad(lambda p, b: TM.loss_fn(tcfg, p, b),
                                    _tparams(jp), _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    assert len(jflat) == len(list(tree_items(tg))) == 11
    for path, g in tree_items(tg):
        want = jflat[tuple(jax.tree_util.DictKey(k) for k in path)]
        assert g.shape == want.shape
        assert _max_rel(g, want) <= GRAD_REL, path


@pytest.mark.parametrize("arch,remat", [
    pytest.param(arch, remat, id=arch + ("-remat" if remat else ""))
    for remat in (False, True)
    for arch in ("mamba2-2.7b", "whisper-small", "zamba2-7b")])
def test_ssm_and_encdec_loss_and_gradients_match_reference(arch, remat):
    """The SSM, hybrid and enc-dec families' ``loss_fn`` on the CPU (smoke,
    float32, the reference's weights; whisper's stub frame embeddings from
    a numpy seed), with and without remat, and its gradients through
    autograd of the plain versions: the loss within LOSS_REL, every leaf
    within GRAD_REL (``A_log``, ``dt_bias``, ``D``, ``conv_w``,
    ``gate_norm`` and the shared block's leaves among them)."""
    cfg = dataclasses.replace(smoke_reduce(get_config(arch)), remat=remat)
    tcfg = dataclasses.replace(t_smoke(t_get_config(arch)), remat=remat)
    jp = JM.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "encdec":
        batch["embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    (jloss, _), jg = jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True)(jp, _jbatch(batch))
    (tloss, _), tg = value_and_grad(lambda p, b: TM.loss_fn(tcfg, p, b),
                                    _tparams(jp), _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    assert len(jflat) == len(list(tree_items(tg)))
    for path, g in tree_items(tg):
        want = jflat[tuple(jax.tree_util.DictKey(k) for k in path)]
        assert g.shape == want.shape
        assert _max_rel(g, want) <= GRAD_REL, path
        if arch != "whisper-small":
            assert float(g.abs().max()) > 0, path


def _saved_bytes(cfg, params, batch):
    """(loss, bytes, gradients) of one ``loss_fn`` forward and backward:
    the bytes of the distinct storages autograd keeps for the backward
    (``saved_tensors_hooks``: a checkpoint saves its inputs through them,
    and what it saves inside is dropped by its own), the parameters' not
    counted."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    mine = {t.untyped_storage().data_ptr() for t in tree_leaves(leaves)}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in mine:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = TM.loss_fn(cfg, leaves, batch)
    loss.backward()
    return loss.detach(), sum(seen.values()), [t.grad for t in
                                               tree_leaves(leaves)]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_and_hybrid_stacks_rematerialize_under_remat(arch):
    """With ``cfg.remat`` each Mamba2 layer (ssm) or each segment (hybrid)
    is checkpointed, as the reference's ``jax.checkpoint`` does: what one
    forward saves for its backward grows with the depth by one (B, S, D)
    tensor a layer or segment, the checkpoint's input (what a checkpointed
    layer saves inside it is not kept), and without remat each layer saves
    several (B, S, D) tensors of its own.  The loss and every gradient are
    bit-equal with and without remat."""
    base = t_smoke(t_get_config(arch))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, base.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    bsd = 2 * 64 * base.d_model * 4
    got = {}
    for depth in (2, 4):
        cfg = dataclasses.replace(base, n_layers=depth)
        params = TM.init_params(cfg, 0, device="cpu")
        for remat in (True, False):
            got[depth, remat] = _saved_bytes(
                dataclasses.replace(cfg, remat=remat), params, batch)
        (l1, _, g1), (l0, _, g0) = got[depth, True], got[depth, False]
        assert torch.equal(l1, l0)
        assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    assert got[4, True][1] - got[2, True][1] <= 2 * bsd
    per_layer = (got[4, False][1] - got[2, False][1]) / 2
    assert per_layer >= 4 * bsd, (per_layer, bsd)
    assert got[2, False][1] >= 4 * got[2, True][1]


# ---------------------------------------------------------------------------
# train steps: every execution plan
# ---------------------------------------------------------------------------

#: the smoke llama's plans keep their ids; the SSM and hybrid archs' take
#: the arch as a prefix, and one step each
PLAN_CASES = [pytest.param(arch, idx, steps,
                           id=(f"{arch}-" if arch != "llama3.2-3b" else "")
                           + p.name)
              for arch, steps in (("llama3.2-3b", 8), ("mamba2-2.7b", 1),
                                  ("zamba2-7b", 1))
              for idx, p in enumerate(DEFAULT_PLANS)]


@pytest.mark.parametrize("arch,idx,steps", PLAN_CASES)
def test_plan_train_steps_match_reference(arch, idx, steps):
    """``steps`` steps of each DEFAULT_PLANS step (the builders the
    autotuner uses) from the reference's weights: losses within
    STEP_LOSS_REL; after the first step, parameters within 1e-5 wherever
    the first gradient is well above AdamW's eps, the rest counted.  The
    smoke llama runs 8 steps; mamba2 and zamba2 (the SSD scan's backward
    on the CPU is its plain version) one."""
    plan, jplan = DEFAULT_PLANS[idx], J_PLANS[idx]
    assert plan == dataclasses.replace(plan, **dataclasses.asdict(jplan))
    cfg = dataclasses.replace(smoke_reduce(get_config(arch)), vocab_size=128)
    tcfg = dataclasses.replace(t_smoke(t_get_config(arch)), vocab_size=128)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = _tparams(jp)
    jstep = j_plan_builder(cfg, J_OPT)(jplan)
    tstep = make_plan_builder(tcfg, OPT, device="cpu")(plan)
    jo, to = j_adamw_init(jp, J_OPT), adamw_init(tp, OPT)
    pipe = JTokenPipeline(J_DATA)
    (_, _), g0 = jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True)(
            jp, _jbatch(pipe.batch_at(0)))
    jl, tl = [], []
    for step in range(steps):
        b = pipe.batch_at(step)
        jp, jo, jm = jstep(jp, jo, _jbatch(b))
        tp, to, tm = tstep(tp, to, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if step == 0:
            jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
            gflat = dict(jax.tree_util.tree_flatten_with_path(g0)[0])
            sure = total = 0
            for path, p in tree_items(tp):
                key = tuple(jax.tree_util.DictKey(k) for k in path)
                big = np.abs(np.asarray(gflat[key])) > 1e-5
                got = p.numpy()[big]
                want = np.asarray(jflat[key])[big]
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
                sure += int(big.sum())
                total += big.size
            assert sure >= 0.5 * total, (sure, total)
    np.testing.assert_allclose(tl, jl, rtol=STEP_LOSS_REL)
    assert int(to.step) == steps


def test_microbatched_gradients_sum_in_float32(monkeypatch):
    """mb > 1 accumulates in float32 (the reference's zeros + g), mb 1
    keeps the parameters' dtype: the update sees those dtypes."""
    import repro_torch.launch.steps as steps
    params = {"w": torch.ones(3, dtype=torch.bfloat16),
              "b": {"c": torch.ones(2)}}
    seen = {}

    def spy(grads, state, p, cfg):
        seen.update({"/".join(k): v.dtype for k, v in tree_items(grads)})
        return p, state, {}

    monkeypatch.setattr(steps, "adamw_update_", spy)
    monkeypatch.setattr(steps, "loss_fn", lambda cfg, p, b: (
        (p["w"].float().sum() + p["b"]["c"].sum())
        * b["tokens"].float().mean(), {}))
    batch = {"tokens": torch.ones((4, 2)), "labels": torch.ones((4, 2))}
    for mb, dt in ((1, torch.bfloat16), (2, torch.float32)):
        make_train_step(TCFG, OPT, microbatches=mb)(
            params, adamw_init(params, OPT), batch)
        assert seen["w"] == dt and seen["b/c"] == torch.float32


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_in_place_equals_functional_bit_for_bit(monkeypatch):
    """A nested, stacked tree in bf16 and float32, walked in small slices
    (SLICE_ELEMENTS cut to 7): every parameter and moment bit-equal to the
    functional update over 4 steps."""
    monkeypatch.setattr(tadamw, "SLICE_ELEMENTS", 7)
    rng = np.random.default_rng(0)

    def t(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dt)

    params = {"embed": t((9, 5), torch.bfloat16), "final_norm": t((5,),
                                                                  torch.float32),
              "layers": {"wq": t((3, 5, 4), torch.bfloat16),
                         "ln1": t((3, 5), torch.float32)},
              "scalar": t((), torch.float32)}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, clip_norm=0.5)
    state = adamw_init(params, cfg)
    ip = tree_map(torch.clone, params)
    istate = AdamWState(state.step.clone(), tree_map(torch.clone, state.m),
                        tree_map(torch.clone, state.v))
    for _ in range(4):
        grads = tree_map(lambda p: t(tuple(p.shape), p.dtype), params)
        params, state, m1 = adamw_update(grads, state, params, cfg)
        ip, istate, m2 = adamw_update_(grads, istate, ip, cfg)
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        for a, b in zip(tree_items(params), tree_items(ip)):
            assert a[0] == b[0] and torch.equal(a[1], b[1])
        for tree_a, tree_b in ((state.m, istate.m), (state.v, istate.v)):
            for a, b in zip(tree_items(tree_a), tree_items(tree_b)):
                assert torch.equal(a[1], b[1])
    assert int(istate.step) == 4


# ---------------------------------------------------------------------------
# the trainer (ported from tests/test_system.py)
# ---------------------------------------------------------------------------

def _run(tmp, failure_rate, n=12, seed=0):
    tr = Trainer(TCFG, OPT, DATA,
                 TrainerConfig(ckpt_dir=str(tmp), ckpt_every=4,
                               async_ckpt=False, failure_rate=failure_rate,
                               failure_seed=6),
                 step_fn=make_train_step(TCFG, OPT), seed=seed,
                 device="cpu")
    return tr.train(n)


def _same(a, b, atol=1e-5):
    return all(np.allclose(x.float().numpy(), y.float().numpy(), atol=atol)
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def test_restart_equivalence(tmp_path):
    """A run with injected node failures reaches the same final parameters
    as an uninterrupted run (deterministic data + checkpoint replay)."""
    clean = _run(tmp_path / "clean", failure_rate=0.0)
    faulty = _run(tmp_path / "faulty", failure_rate=0.15)
    assert faulty["restarts"] > 0, "failure injection never fired"
    assert _same(clean["params"], faulty["params"])
    assert clean["final_step"] == faulty["final_step"] == 12


def test_restart_restores_into_a_template_without_the_lost_state(tmp_path):
    """Each restore of a restart fills a template on the meta device, and
    the state lost in the failure is released before it: two copies of the
    state are never alive together (at full width they would be 64 GB)."""
    import gc
    import weakref
    inner = make_train_step(TCFG, OPT)
    held = []

    def step_fn(params, opt, batch):
        out = inner(params, opt, batch)
        held[:] = [weakref.ref(t) for _, t in tree_items(out[0])]
        return out

    tr = Trainer(TCFG, OPT, DATA,
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                               async_ckpt=False, failure_rate=0.15,
                               failure_seed=6),
                 step_fn=step_fn, seed=0, device="cpu")
    restore, seen = tr.ckpt.restore, []

    def spy(step, like, device=None):
        gc.collect()
        leaves = (tree_leaves(like["params"]) + tree_leaves(like["opt"].m)
                  + tree_leaves(like["opt"].v) + [like["opt"].step])
        seen.append(({t.device.type for t in leaves},
                     sum(r() is not None for r in held)))
        return restore(step, like, device=device)

    tr.ckpt.restore = spy
    out = tr.train(12)
    assert out["restarts"] > 0 and seen, "no restart restored a checkpoint"
    assert all(devs == {"meta"} and alive == 0 for devs, alive in seen), seen


def test_loss_decreases(tmp_path):
    losses = _run(tmp_path, failure_rate=0.0, n=12)["losses"]
    assert losses[-1] < losses[0]


def test_trainer_sigterm_final_save(tmp_path):
    """SIGTERM mid-run: the loop finishes the in-flight step, the final
    synchronous save covers exactly that step, and a relaunch resumes to
    the uninterrupted result."""
    step_fn = make_train_step(TCFG, OPT)
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "pre"), ckpt_every=4,
                         async_ckpt=False)
    tr = Trainer(TCFG, OPT, DATA, tcfg, step_fn=step_fn, seed=0,
                 device="cpu")
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        orig = tr.pipeline.batch_at
        calls = {"n": 0}

        def batch_at(step):
            calls["n"] += 1
            if calls["n"] == 7:            # preempt mid-step 7
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(step)

        tr.pipeline.batch_at = batch_at
        out = tr.train(12)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["preempted"] and out["final_step"] == 7
    assert tr.ckpt.latest_step() == 7      # the final save, not step 4
    tr2 = Trainer(TCFG, OPT, DATA, tcfg, step_fn=step_fn, seed=0,
                  device="cpu")
    resumed = tr2.train(12)
    clean = _run(tmp_path / "clean", failure_rate=0.0)
    assert not resumed["preempted"] and resumed["final_step"] == 12
    assert _same(clean["params"], resumed["params"])


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's Trainer writes step 4 (params and its nested AdamW
    state); the port's Trainer resumes from it to step 8, matching the
    reference's own run to step 8 within the step tolerance."""
    d = str(tmp_path / "ref")
    jt = JTrainer(CFG, J_OPT, J_DATA,
                  JTrainerConfig(ckpt_dir=d, ckpt_every=4, async_ckpt=False),
                  step_fn=j_train_step(CFG, J_OPT), seed=0)
    jt.train(4)
    jfull = JTrainer(CFG, J_OPT, J_DATA,
                     JTrainerConfig(ckpt_dir=str(tmp_path / "ref8"),
                                    ckpt_every=100, async_ckpt=False),
                     step_fn=j_train_step(CFG, J_OPT), seed=0).train(8)
    # the port reads the reference's files: keys, dtypes and the opt tree
    state = JCheckpointManager(d).restore(
        4, {"params": jt._init_state()[0], "opt": jt._init_state()[1]})
    tparams = _tparams(state["params"])
    topt = model_opt_state_from_jax(_np_tree(state["opt"]), device="cpu")
    tr = Trainer(TCFG, OPT, DATA,
                 TrainerConfig(ckpt_dir=d, ckpt_every=100, async_ckpt=False),
                 step_fn=make_train_step(TCFG, OPT), seed=0, device="cpu")
    start, p, o = tr._restore_or_init()
    assert start == 4 and int(o.step) == 4
    for (_, a), (_, b) in zip(tree_items(p), tree_items(tparams)):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(tree_items(o.m), tree_items(topt.m)):
        assert torch.equal(a, b)
    out = tr.train(8)
    assert out["final_step"] == 8
    np.testing.assert_allclose(out["losses"], jfull["losses"][4:],
                               rtol=STEP_LOSS_REL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch_on_the_cpu(arch, tmp_path, capsys, monkeypatch):
    """``launch.train.main`` for ``arch`` (smoke) on the CPU, 7 steps under
    ExhaustiveSel: every plan explored, then one exploited."""
    # A clock that moves 1 ms a reading gives every step the same time, as
    # test_torch_autotune.py's straggler test injects its own: on the host's
    # real clock a step jittered by a few ms (steps take ~10 ms here) trips
    # the trainer's straggler rule (a step over 1.1x the mean of those
    # before it), which re-opens the search and unsettles the last steps.
    clock = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock) * 1e-3)
    old = signal.getsignal(signal.SIGTERM)
    try:
        out = tlaunch.main(["--arch", arch, "--steps", "7",
                            "--seq-len", "32", "--batch", "4",
                            "--ckpt", str(tmp_path), "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["final_step"] == 7 and len(out["losses"]) == 7
    assert np.all(np.isfinite(out["losses"]))
    names = [p.name for p in DEFAULT_PLANS]
    assert [h[0] for h in out["history"][:5]] == names   # explored all
    assert len({h[0] for h in out["history"][5:]}) == 1    # then settled
    assert [r["plan"] for r in out["plans"]] == names
    assert all(r["peak_bytes"] is None for r in out["plans"])
    assert out["settled"] in names
    assert "done: steps=7" in capsys.readouterr().out
    return out


def test_launch_train_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    _launch_on_the_cpu("llama3.2-3b", tmp_path, capsys, monkeypatch)
    # every family's archs: dense, SSM, hybrid, MoE and enc-dec
    assert tlaunch.TRAIN_ARCHS == ["qwen3-32b", "granite-8b",
                                   "mistral-nemo-12b", "llama3.2-3b",
                                   "zamba2-7b", "qwen2-vl-72b",
                                   "mamba2-2.7b", "olmoe-1b-7b",
                                   "grok-1-314b", "whisper-small"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_launch_train_main_trains_the_ssm_and_hybrid_archs(arch, tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """The SSM and hybrid archs train through the launcher on the CPU (the
    SSD scan's plain backward), under the same checks as the dense one."""
    out = _launch_on_the_cpu(arch, tmp_path, capsys, monkeypatch)
    assert "A_log" in out["params"]["layers"]
    assert arch in tlaunch.TRAIN_ARCHS
