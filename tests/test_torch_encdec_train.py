"""The enc-dec family's training in the port against the reference, on the
CPU: the flash backward at the cross attention's shapes, whisper-small's
loss and gradients, one step of every execution plan, the trainer with
its frames and its restarts, the pipeline's frame stream and the
launcher.

The model is whisper-small's ``smoke_reduce`` (2 + 2 layers, d_model 128,
64 encoder frames, vocab cut to 128) in float32, with the reference's
weights carried over by ``repro_torch.convert``.  The reference's launcher
cannot train this family (its batches carry no frames), so both packages
are given the same frames: the port's ``TokenPipeline.frames_at`` of the
step.  Tolerances, with their reasons:

* the flash gradient within ``FLASH_GRAD_REL`` = 1e-5 of each gradient's
  largest magnitude: the same float32 function as the reference's
  ``full_attention``, products and sums in another order;
* the loss within ``LOSS_REL`` and every gradient leaf within
  ``GRAD_REL`` (``tests/test_torch_train.py``'s bars), and every leaf a
  nonzero gradient: no leaf of the family is zero by the mathematics;
* one step of each plan: the loss within ``STEP_LOSS_REL`` = 1e-4, the
  parameters within 1e-5 where the first gradient exceeds 1e-5, as
  ``test_plan_train_steps_match_reference`` holds the dense plans;
* tokens and labels bit for bit; frames exactly equal across calls.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_reduce  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.distributed import DEFAULT_PLANS as J_PLANS  # noqa: E402
from repro.distributed import make_plan_builder as j_plan_builder  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import full_attention as j_full_attention  # noqa: E402,E501
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_NAMES, ShapeConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_reduce as t_smoke  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import DEFAULT_PLANS, make_plan_builder  # noqa: E402,E501
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.steps import (input_specs,  # noqa: E402
                                      make_train_step, value_and_grad)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw_init, tree_items  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

from test_torch_train import (GRAD_REL, J_DATA, J_OPT, LOSS_REL,  # noqa: E402
                              OPT, STEP_LOSS_REL, DATA, _jbatch,
                              _launch_on_the_cpu, _max_rel, _same,
                              _tbatch, _tparams)

ARCH = "whisper-small"
CFG = dataclasses.replace(smoke_reduce(get_config(ARCH)), vocab_size=128)
TCFG = dataclasses.replace(t_smoke(t_get_config(ARCH)), vocab_size=128)
FLASH_GRAD_REL = 1e-5


def _batch(step):
    """Step ``step``'s batch as the port's trainer draws it: the tokens
    and labels of the pipeline and the step's frames."""
    return TokenPipeline(DATA).train_batch_at(step, TCFG)


def _jloss_and_grads(cfg, jp, batch):
    return jax.value_and_grad(lambda p, b: JM.loss_fn(cfg, p, b),
                              has_aux=True)(jp, _jbatch(batch))


def _grads_by_path(jg):
    flat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    return lambda path: flat[tuple(jax.tree_util.DictKey(k) for k in path)]


# ---------------------------------------------------------------------------
# the flash gradient at the cross attention's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,causal", [(48, 100, False), (100, 100, False),
                                        (48, 48, True)],
                         ids=["cross-48-over-100", "encoder-100",
                              "decoder-48-causal"])
def test_flash_gradient_at_the_cross_shapes_matches_jax_vjp(S, T, causal):
    """The flash backward's plain version (what the wrapper runs on CPU
    tensors, and what autograd of ``flash_attention`` reaches) against
    ``jax.vjp`` of the reference's ``full_attention``, at whisper's three
    kinds of call: the decoder's queries over the encoder's frames (T not
    a multiple of the kernels' 64-key tile, S != T), the encoder's
    non-causal self-attention, the decoder's causal one."""
    B, H, hd = 2, 4, 32
    rng = np.random.default_rng(S * T + causal)
    q, do = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(lambda *a: j_full_attention(*a, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = FA.flash_attention_lse(tq, tk, tv, causal=causal)
    got = FA.flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    FA.flash_attention(*leaves, causal=causal).backward(tdo)
    for name, g, a, w in zip("qkv", got, leaves, want):
        assert g.shape == w.shape
        assert _max_rel(g, w) <= FLASH_GRAD_REL, name
        assert torch.equal(a.grad, g), name


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_whisper_loss_and_every_leaf_gradient_match_reference():
    """One batch of the port's pipeline (tokens and frames) through both
    packages' ``loss_fn``: the loss within LOSS_REL, every leaf within
    GRAD_REL, and every leaf's gradient nonzero (the encoder's reach it
    through every decoder layer's cross k and v)."""
    jp = JM.init_params(CFG, jax.random.PRNGKey(0))
    batch = _batch(0)
    (jloss, _), jg = _jloss_and_grads(CFG, jp, batch)
    (tloss, _), tg = value_and_grad(lambda p, b: TM.loss_fn(TCFG, p, b),
                                    _tparams(jp), _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    want = _grads_by_path(jg)
    items = list(tree_items(tg))
    assert len(items) == len(jax.tree.leaves(jg)) == 36
    for path, g in items:
        assert g.shape == want(path).shape
        assert _max_rel(g, want(path)) <= GRAD_REL, path
        assert float(g.abs().max()) > 0, path


def test_whisper_remat_computes_the_same_step():
    """Neither package checkpoints the enc-dec stack, so ``remat`` is not
    read: the port's loss and gradients are bit-equal with and without
    it, and so are the reference's."""
    jp = JM.init_params(CFG, jax.random.PRNGKey(0))
    tp = _tparams(jp)
    batch = _batch(1)
    got, ref = {}, {}
    for remat in (True, False):
        cfg = dataclasses.replace(TCFG, remat=remat)
        got[remat] = value_and_grad(lambda p, b: TM.loss_fn(cfg, p, b), tp,
                                    _tbatch(batch))
        ref[remat] = _jloss_and_grads(dataclasses.replace(CFG, remat=remat),
                                      jp, batch)
    (l1, _), g1 = got[True]
    (l0, _), g0 = got[False]
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(g1), tree_items(g0)))
    assert float(ref[True][0][0]) == float(ref[False][0][0])
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(ref[True][1]),
                   jax.tree.leaves(ref[False][1])))


# ---------------------------------------------------------------------------
# train steps: every execution plan, with frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", range(len(DEFAULT_PLANS)),
                         ids=[p.name for p in DEFAULT_PLANS])
def test_whisper_plan_step_matches_reference(idx):
    """One step of each DEFAULT_PLANS step (the builders the autotuner
    uses) from the reference's weights on the same batch and frames: the
    microbatch split slices ``embeds`` with the tokens.  The loss within
    STEP_LOSS_REL; the parameters within 1e-5 wherever the first gradient
    exceeds 1e-5 (at least half of them)."""
    plan, jplan = DEFAULT_PLANS[idx], J_PLANS[idx]
    assert plan == dataclasses.replace(plan, **dataclasses.asdict(jplan))
    jp = JM.init_params(CFG, jax.random.PRNGKey(0))
    tp = _tparams(jp)
    batch = _batch(0)
    (_, _), g0 = _jloss_and_grads(CFG, jp, batch)
    grad0 = _grads_by_path(g0)
    jstep = j_plan_builder(CFG, J_OPT)(jplan)
    tstep = make_plan_builder(TCFG, OPT, device="cpu")(plan)
    jp, _, jm = jstep(jp, j_adamw_init(jp, J_OPT), _jbatch(batch))
    tp, to, tm = tstep(tp, adamw_init(tp, OPT), _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_LOSS_REL)
    after = _grads_by_path(jp)
    sure = total = 0
    for path, p in tree_items(tp):
        big = np.abs(np.asarray(grad0(path))) > 1e-5
        np.testing.assert_allclose(p.numpy()[big],
                                   np.asarray(after(path))[big],
                                   rtol=1e-5, atol=1e-6, err_msg=str(path))
        sure += int(big.sum())
        total += big.size
    assert sure >= 0.5 * total, (sure, total)
    assert int(to.step) == 1


# ---------------------------------------------------------------------------
# the trainer: frames, the reference's losses, restarts
# ---------------------------------------------------------------------------

def _trainer(tmp, failure_rate=0.0, start=None):
    """The port's Trainer on the smoke whisper (the CPU), starting from
    ``start`` (params) saved as its step-0 checkpoint."""
    if start is not None:
        CheckpointManager(str(tmp)).save(
            0, {"params": start, "opt": adamw_init(start, OPT)})
    return Trainer(TCFG, OPT, DATA,
                   TrainerConfig(ckpt_dir=str(tmp), ckpt_every=4,
                                 async_ckpt=False, failure_rate=failure_rate,
                                 failure_seed=6),
                   step_fn=make_train_step(TCFG, OPT), seed=0, device="cpu")


def _by_step(tr):
    """The loss of each step of a run (a replayed step's last)."""
    return {m["step"]: m["loss"] for m in tr.metrics_log}


def test_trainer_with_frames_matches_reference_steps(tmp_path):
    """``Trainer.train`` from the reference's weights: each step's batch
    carries the step's frames (the tokens and labels are the reference's
    ``TokenPipeline.batch_at``), and its losses equal, within
    STEP_LOSS_REL, the reference's jitted train step fed the same batches
    and frames."""
    jp = JM.init_params(CFG, jax.random.PRNGKey(0))
    tr = _trainer(tmp_path, start=_tparams(jp))
    out = tr.train(6)
    assert out["final_step"] == 6 and out["restarts"] == 0
    jpipe, jopt = JTokenPipeline(J_DATA), j_adamw_init(jp, J_OPT)
    jstep = jax.jit(j_train_step(CFG, J_OPT))
    want = []
    for step in range(6):
        b = tr.pipeline.train_batch_at(step, TCFG)
        ref = jpipe.batch_at(step)
        assert set(b) == {"tokens", "labels", "embeds"}
        for k in ref:
            np.testing.assert_array_equal(b[k], ref[k])
        assert b["embeds"].shape == (4, TCFG.encoder_seq, TCFG.d_model)
        jp, jopt, jm = jstep(jp, jopt, _jbatch(b))
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=STEP_LOSS_REL)
    assert want[-1] < want[0]


def test_encdec_restart_equivalence(tmp_path):
    """A run with injected node failures replays each lost step on the
    same batch and frames: the same loss a step and the same final
    parameters as an unbroken run."""
    clean_tr = _trainer(tmp_path / "clean")
    clean = clean_tr.train(12)
    faulty_tr = _trainer(tmp_path / "faulty", failure_rate=0.15)
    faulty = faulty_tr.train(12)
    assert faulty["restarts"] > 0, "failure injection never fired"
    assert clean["final_step"] == faulty["final_step"] == 12
    a, b = _by_step(clean_tr), _by_step(faulty_tr)
    assert sorted(a) == sorted(b) == list(range(12))
    np.testing.assert_allclose([b[s] for s in a], [a[s] for s in a],
                               rtol=1e-6)
    assert _same(clean["params"], faulty["params"])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pipeline_tokens_bit_equal_and_frames_keyed_by_step(arch):
    """For every arch, the port's tokens and labels are the reference's
    ``TokenPipeline.batch_at`` bit for bit, at the arch's vocab, and its
    training batch (``train_batch_at``) adds frames to the enc-dec arch's
    alone; the frames are float32 of ``input_specs``' embeds shape,
    the same on every call, different from step to step and seed to
    seed, and drawing them leaves the tokens as they were."""
    cfg = t_get_config(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=7)
    jp, tp = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
    for step in (0, 5):
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    full = tp.train_batch_at(5, cfg)
    np.testing.assert_array_equal(full["tokens"], a["tokens"])
    if cfg.family != "encdec":
        assert full.keys() == {"tokens", "labels"}
        return
    assert full.keys() == {"tokens", "labels", "embeds"}
    spec = input_specs(cfg, ShapeConfig("t", "train", 32, 2))["embeds"]
    f0 = tp.frames_at(0, cfg.encoder_seq, cfg.d_model)
    assert f0.dtype == np.float32 and f0.shape == spec.shape
    assert np.array_equal(f0, tp.frames_at(0, cfg.encoder_seq, cfg.d_model))
    assert not np.array_equal(f0, tp.frames_at(1, cfg.encoder_seq,
                                               cfg.d_model))
    other = TokenPipeline(DataConfig(**{**kw, "seed": 8}))
    assert not np.array_equal(f0, other.frames_at(0, cfg.encoder_seq,
                                                  cfg.d_model))
    assert abs(float(f0.mean())) < 0.01 and abs(float(f0.std()) - 1) < 0.01
    np.testing.assert_array_equal(tp.batch_at(0)["tokens"],
                                  jp.batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_main_trains_whisper_on_the_cpu(tmp_path, capsys,
                                                     monkeypatch):
    """``launch.train.main(["--arch", "whisper-small", "--device", "cpu",
    ...])`` trains the smoke cut under the injected clock: every plan
    explored, then one settled; every arch is in ``TRAIN_ARCHS``."""
    out = _launch_on_the_cpu(ARCH, tmp_path, capsys, monkeypatch)
    assert {"enc_layers", "dec_layers"} <= set(out["params"])
    assert tlaunch.TRAIN_ARCHS == list(ARCH_NAMES)
