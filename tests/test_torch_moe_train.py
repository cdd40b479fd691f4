"""The MoE family's training in the port against the reference, on the
CPU: the dispatch's gradients, olmoe-1b-7b's loss and gradients with and
without remat, one step of every execution plan, the train step's metrics
through the trainer and its restarts, and the launcher.

``moe_block`` is held against ``jax.vjp`` of the reference's
(``repro.models.layers.moe_block``) for x, the router and the three expert
weights, with no drops, with drops, in one and two groups and with router
ties: within ``DISPATCH_REL`` = 1e-5 of each leaf's largest magnitude (the
same float32 function, products and sums in another order).  The router's
gradient reaches it only through the normalised top-k weights: the
reference's loss adds no aux loss.  olmoe's smoke cut (4 experts, top-2,
d_model 128, float32, the reference's weights through
``repro_torch.convert``) is held as the dense model is in
``test_torch_train.py``: the loss within ``LOSS_REL``, every gradient leaf
within ``GRAD_REL`` (1e-4), ``expert_load`` exactly, and every leaf a
nonzero gradient.  With remat the backward routes the checkpointed blocks
again, and its gradients are bit-equal to those without remat.  Each plan
takes one step from the reference's weights, held as
``test_plan_train_steps_match_reference`` holds the dense plans.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.distributed import DEFAULT_PLANS as J_PLANS  # noqa: E402
from repro.distributed import make_plan_builder as j_plan_builder  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import moe_block as j_moe_block  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.distributed import DEFAULT_PLANS, make_plan_builder  # noqa: E402,E501
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.steps import (make_train_step,  # noqa: E402
                                      value_and_grad)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw_init, tree_items, tree_map  # noqa: E402,E501
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

from test_torch_moe import _weights  # noqa: E402
from test_torch_train import (GRAD_REL, J_DATA, J_OPT, LOSS_REL,  # noqa: E402
                              OPT, STEP_LOSS_REL, _jbatch, _launch_on_the_cpu,
                              _max_rel, _tbatch, _tparams)

ARCH = "olmoe-1b-7b"
DISPATCH_REL = 1e-5


# ---------------------------------------------------------------------------
# the dispatch's gradients
# ---------------------------------------------------------------------------

def _dispatch_grads(args, dy, **kw):
    """The reference's gradients of ``<moe_block(...)[0], dy>`` for x, the
    router and the three expert weights (``jax.vjp``, jitted), and the
    port's with its aux."""
    def vjp(a, d):
        return jax.vjp(lambda *a: j_moe_block(*a, **kw)[0], *a)[1](d)
    want = jax.jit(vjp)(tuple(map(jnp.asarray, args)), jnp.asarray(dy))
    got, aux = _port_dispatch_grads(args, dy, **kw)
    return want, got, aux


def _port_dispatch_grads(args, dy, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux = TL.moe_block(*leaves, **kw)
    return torch.autograd.grad(out, leaves, torch.from_numpy(dy)), aux


DISPATCH_CASES = [
    # (T, D, E, F, k, capacity_factor, integer inputs)
    pytest.param(64, 32, 8, 48, 2, 8.0, False, id="no-drops"),
    pytest.param(40, 24, 16, 32, 4, 8.0, False, id="no-drops-k4"),
    pytest.param(48, 16, 8, 24, 2, 0.25, False, id="drops"),
    pytest.param(64, 32, 8, 48, 2, 1.25, False, id="default-capacity"),
    pytest.param(48, 8, 6, 16, 2, 1.25, True, id="router-ties"),
]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("T,D,E,F,k,cf,integer", DISPATCH_CASES)
def test_moe_block_gradients_match_jax_vjp(T, D, E, F, k, cf, integer,
                                           groups):
    """Every gradient of ``moe_block`` within DISPATCH_REL of the
    reference's ``jax.vjp``; a rerun's gradients bit-equal.  The ties case
    makes two router columns equal, so every token ties between those two
    experts (``lax.top_k`` and ``layers.top_k`` take the lower index)."""
    args = _weights(T, D, E, F, seed=T + E + k, integer=integer)
    if integer:
        args[1][:, 4] = args[1][:, 1]
    dy = np.random.default_rng(T * k).standard_normal((T, D)).astype(
        np.float32)
    kw = dict(k=k, capacity_factor=cf, groups=groups)
    want, got, aux = _dispatch_grads(args, dy, **kw)
    dropped = float(aux["dropped_frac"])
    if cf == 8.0:
        assert dropped == 0.0
    if cf == 0.25:
        assert dropped > 0.5
    names = ("x", "router", "w_gate", "w_up", "w_down")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        bound = DISPATCH_REL * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= bound, name
    assert float(got[1].abs().max()) > 0        # through the top-k weights
    again, _ = _port_dispatch_grads(args, dy, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_dispatch_gather_sums_each_tokens_copies_in_sorted_order():
    """``_DispatchGather``'s backward adds a token's kept copies one by one
    in the dispatch's sorted order, in the gradient's dtype: bf16 copies
    summed left to right, bit for bit, and a dropped copy adds nothing."""
    T, k, D = 3, 3, 4
    t_sorted = torch.tensor([0, 1, 2, 0, 2, 1, 0, 1, 2])   # by expert
    keep = torch.tensor([True, True, True, True, False, True, True, True,
                         True])
    by_token = torch.argsort(t_sorted, stable=True)
    x = torch.zeros((T, D), dtype=torch.bfloat16, requires_grad=True)
    rows = TL._DispatchGather.apply(x, t_sorted, keep, by_token, k)
    assert rows.shape == (int(keep.sum()), D)
    g = torch.randn(rows.shape, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    (dx,) = torch.autograd.grad(rows, x, g)
    kept = t_sorted[keep]
    for t in range(T):
        want = torch.zeros(D, dtype=torch.bfloat16)
        for r in torch.nonzero(kept == t).flatten().tolist():
            want = want + g[r]
        assert torch.equal(dx[t], want), t


def test_moe_block_backward_reruns_bit_equal_above_the_cpu_grain():
    """float32, 512 tokens top-4 of 8 experts, D 128 (262,144 gathered
    elements, above the 32,768 from which the CPU's indexed accumulate
    adds with atomics from several threads; four copies a token, whose
    sum depends on the order): the gradients of five reruns bit-equal."""
    args = _weights(512, 128, 8, 64, seed=3)
    dy = np.random.default_rng(3).standard_normal((512, 128)).astype(
        np.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 4))
    try:
        runs = [_port_dispatch_grads(args, dy, k=4, capacity_factor=8.0)[0]
                for _ in range(5)]
    finally:
        torch.set_num_threads(threads)
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


# ---------------------------------------------------------------------------
# olmoe-1b-7b: loss and gradients
# ---------------------------------------------------------------------------

def _smoke(remat, **kw):
    cfg = dataclasses.replace(smoke_reduce(get_config(ARCH)), remat=remat,
                              **kw)
    tcfg = dataclasses.replace(t_smoke(t_get_config(ARCH)), remat=remat,
                               **kw)
    return cfg, tcfg


def _smoke_batch(cfg, B=2, S=32, seed=5):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.mark.parametrize("remat", [False, True])
def test_olmoe_loss_and_gradients_match_reference(remat):
    """olmoe's smoke ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's, with and without remat:
    the loss within LOSS_REL, each leaf within GRAD_REL of its largest
    magnitude and not all zero, ``expert_load`` (L, E) exactly."""
    cfg, tcfg = _smoke(remat)
    jp = JM.init_params(cfg, jax.random.PRNGKey(2))
    batch = _smoke_batch(cfg)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True))(jp, _jbatch(batch))
    (tloss, taux), tg = value_and_grad(lambda p, b: TM.loss_fn(tcfg, p, b),
                                       _tparams(jp), _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    assert tuple(taux["expert_load"].shape) == (cfg.n_layers, cfg.n_experts)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    assert len(jflat) == len(list(tree_items(tg)))
    for path, g in tree_items(tg):
        want = jflat[tuple(jax.tree_util.DictKey(k) for k in path)]
        assert g.shape == want.shape, path
        assert _max_rel(g, want) <= GRAD_REL, path
        assert float(g.abs().max()) > 0, path
    assert {"router", "we_gate", "we_up", "we_down", "q_norm",
            "k_norm"} <= set(tg["layers"])


@pytest.mark.parametrize("groups", [1, 2])
def test_olmoe_remat_gradients_equal_no_remat_bit_for_bit(groups):
    """With remat the backward recomputes each MoE block, its routing,
    capacity mask and kept count included, from the block's input: the
    loss, ``expert_load`` and every gradient bit-equal to the run without
    remat, at a capacity that drops tokens.  The dispatch's groups are
    read from the context while the forward runs: the backward runs after
    the context has closed, and the recompute still routes in the
    forward's groups."""
    base = t_smoke(t_get_config(ARCH))
    params = TM.init_params(base, 0, device="cpu")
    batch = _tbatch(_smoke_batch(base, B=4, S=32, seed=7))
    runs = {}
    for remat in (True, False):
        tcfg = dataclasses.replace(base, remat=remat, capacity_factor=0.5)
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        with tctx.activation_sharding(None, None, 1, 1, moe_groups=groups):
            loss, aux = TM.loss_fn(tcfg, leaves, batch)
        loss.backward()          # after the context has closed
        runs[remat] = (loss.detach(), aux["expert_load"],
                       [t.grad for _, t in tree_items(leaves)])
    (l1, e1, g1), (l0, e0, g0) = runs[True], runs[False]
    assert torch.equal(l1, l0) and torch.equal(e1, e0)
    assert int(e1.sum()) == base.n_layers * 4 * 32 * base.experts_per_token
    assert all(g is not None for g in g1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


# ---------------------------------------------------------------------------
# train steps: every execution plan; metrics through the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", range(len(DEFAULT_PLANS)),
                         ids=[p.name for p in DEFAULT_PLANS])
def test_olmoe_plan_train_step_matches_reference(idx):
    """One step of each DEFAULT_PLANS step (the autotuner's builders) of
    olmoe's smoke cut (vocab 128) from the reference's weights: the loss
    within STEP_LOSS_REL and the parameters within 1e-5 wherever the
    step's gradient is above 1e-5; at one microbatch the metrics carry
    ``expert_load`` (L, E) equal to the reference's, at more than one
    neither has it.  The plans' capacity is per microbatch (C = 40 at one
    microbatch of 4 x 16 tokens, 20 and 10 at two and four), so the
    plans drop different tokens: they are not the same step, in either
    package."""
    plan, jplan = DEFAULT_PLANS[idx], J_PLANS[idx]
    assert plan == dataclasses.replace(plan, **dataclasses.asdict(jplan))
    cfg, tcfg = _smoke(True, vocab_size=128)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = _tparams(jp)
    jstep = j_plan_builder(cfg, J_OPT)(jplan)
    tstep = make_plan_builder(tcfg, OPT, device="cpu")(plan)
    from repro.data import TokenPipeline as JTokenPipeline
    b = JTokenPipeline(J_DATA).batch_at(0)
    jp, jo, jm = jstep(jp, j_adamw_init(jp, J_OPT), _jbatch(b))
    tp, to, tm = tstep(tp, adamw_init(tp, OPT), _tbatch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_LOSS_REL)
    assert ("expert_load" in tm) == ("expert_load" in jm) \
        == (plan.microbatches == 1)
    if plan.microbatches == 1:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
    # the step's own (clipped) gradient, from the reference's first moment:
    # the plans' gradients differ where their drops do
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    mflat = dict(jax.tree_util.tree_flatten_with_path(jo.m)[0])
    sure = total = 0
    for path, p in tree_items(tp):
        key = tuple(jax.tree_util.DictKey(k) for k in path)
        big = np.abs(np.asarray(mflat[key])) / (1 - J_OPT.b1) > 1e-5
        np.testing.assert_allclose(p.numpy()[big],
                                   np.asarray(jflat[key])[big],
                                   rtol=1e-5, atol=1e-6, err_msg=str(path))
        sure += int(big.sum())
        total += big.size
    assert sure >= 0.5 * total, (sure, total)
    assert int(to.step) == 1


def test_olmoe_steps_through_the_trainer_and_its_restarts(tmp_path):
    """A MoE step's metrics (``expert_load`` among them) pass through
    ``Trainer.train``; a run with injected failures restores from its
    checkpoints and ends bit-equal to an uninterrupted one."""
    _, tcfg = _smoke(True, vocab_size=128)
    data = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
    inner, seen = make_train_step(tcfg, OPT), []

    def step_fn(params, opt, batch):
        out = inner(params, opt, batch)
        seen.append(tuple(out[2]["expert_load"].shape))
        return out

    def run(label, failure_rate):
        return Trainer(tcfg, OPT, data, TrainerConfig(
            ckpt_dir=str(tmp_path / label), ckpt_every=2, async_ckpt=False,
            failure_rate=failure_rate, failure_seed=4), step_fn=step_fn,
            seed=0, device="cpu").train(6)

    clean = run("clean", 0.0)
    assert seen == [(tcfg.n_layers, tcfg.n_experts)] * 6
    faulty = run("faulty", 0.1)         # fails at step 3, resumes from 2
    assert faulty["restarts"] == 1 and faulty["final_step"] == 6
    assert faulty["losses"][-1] == clean["losses"][-1]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_items(clean["params"]), tree_items(faulty["params"])))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_main_trains_olmoe_on_the_cpu(tmp_path, capsys,
                                                   monkeypatch):
    """``launch.train.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
    ...])`` trains the smoke cut under the injected clock: every plan
    explored, then one settled; the MoE archs are in ``TRAIN_ARCHS``."""
    out = _launch_on_the_cpu(ARCH, tmp_path, capsys, monkeypatch)
    assert "router" in out["params"]["layers"]
    assert {ARCH, "grok-1-314b"} <= set(tlaunch.TRAIN_ARCHS)
    assert {get_config(a).family for a in tlaunch.TRAIN_ARCHS} >= {"moe"}
