"""The dense model stack partitioned over a torch ``DeviceMesh`` (DTensor
in place of the reference's GSPMD), on the CPU.

(a) Numerics: a tiny dense config (2 layers, d_model 64, 4 heads, 2 kv
    heads, vocab 256) on a 2x2 ``data, model`` mesh of 4 gloo ranks, each
    a process of its own: two train steps and the prefill from the
    reference's parameters (``repro_torch.convert``) and a numpy-seeded
    batch, gathered, against the reference's jitted ``make_train_step``
    and prefill and against the port's unsharded steps.  The same on two
    more meshes of 4 ranks, for the branches every production cell takes:
    6 heads over a (1, 4) mesh with tied embeddings (the kv heads
    repeated, the query groups padded 3 -> 4, the vocabulary-split tied
    head, the cache's repeated heads taken back), and a (2, 2, 1) ``pod,
    data, model`` mesh (FSDP's gather over ``pod, data`` in one
    collective, and its reduce-scatter).
(b) The count: rank 0's share of the same config's train step in a fake
    process group of 8 on a (2, 2, 2) ``pod, data, model`` mesh, its FSDP
    all-gathers and reduce-scatters against a hand count from the specs,
    and its FLOPs against the reference's partitioned count
    (``hlo_analysis``) of the step compiled for eight forced host
    devices, in a subprocess.
(c) Every dense, VL and MoE arch's ``train_4k`` and ``prefill_32k`` cell
    on 16x16 and 2x16x16 (28 records): ``dryrun.counted_mesh_cell`` fills
    every per-device field, and the argument bytes are the layout's
    (counted once a run, in subprocesses side by side); ``dryrun.main(
    ["--all", "--mesh", "both"])`` over those records and the layout of
    the rest.
(d) With no mesh the kernels' wrappers and the ``ctx`` functions are what
    they were, and a (1, 1) mesh of one gloo rank computes the unsharded
    steps bit for bit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES,  # noqa: E402
                                 ShapeConfig, applicable, get_config)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed.sharding import (param_specs,  # noqa: E402
                                              shard_shape)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_train_step, params_shape,
                                      value_and_grad)
from repro_torch.models.model import loss_fn  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     tree_items)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
REPO = os.path.dirname(SRC)

TINY = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
CFG, J_CFG = ModelConfig(**TINY), JModelConfig(**TINY)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
B, S, STEPS = 8, 64, 2
#: float32 tolerances of the 2x2 mesh's results: its sums split over ranks
#: (the batch over ``data``, the row-parallel products' and the norm's
#: partial sums over ``model``), so they round in another order than one
#: device's.  Losses and logits relative to their largest magnitude; the
#: parameters after two AdamW steps absolutely: a step moves a parameter
#: by ~lr whatever its gradient, so a gradient within rounding of zero may
#: move it either way, by at most 2 * lr * STEPS (measured: ~1e-7 here).
LOSS_REL = 1e-5
LOGITS_REL = 1e-5
PARAM_ABS = 1e-5
#: against the reference, the port's own float32 distance from XLA's
#: order on one device too (tests/test_torch_train.py holds 1e-4)
REF_REL = 1e-4
REF_PARAM_ABS = 1e-4
#: the other meshes' first gradients against the unsharded port's,
#: relative to each leaf's largest (measured: ~1e-6 on "heads")
GRAD_REL = 1e-5
#: AdamW's first step moves a parameter by lr * g / (|g| + eps): where
#: |g| is near eps = 1e-8 it moves by any fraction of lr, so rounding of
#: g alone (~5e-8 measured on "heads") moves it by up to lr (measured:
#: 6.6e-5 on a wv entry whose gradient is 1.0e-8 unsharded, 1.8e-8 on the
#: mesh, and 5.2e-5 between the unsharded port and the reference).  On
#: the other meshes the parameters are held at PARAM_ABS where the first
#: gradient is at least GRAD_FLOOR, 20x that rounding (at least
#: HELD_SHARE of the entries; most of the rest are embedding rows of
#: tokens absent from the batch, whose gradient is 0), every gradient by
#: GRAD_REL, and the prefill from the start parameters by LOGITS_REL;
#: the prefill after the steps carries those entries' moves, so it is
#: held at REF_REL, the float32 reorder distance of the steps
GRAD_FLOOR = 1e-6
HELD_SHARE = 0.95


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env(**extra):
    """A subprocess's environment: the port on the path, one thread a
    process (several ranks share the host's cores)."""
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


class Job:
    """A subprocess started at once (the module's subprocesses run side by
    side), read when a test needs it.  ``nice``: run it below the others'
    priority (the other test files' workers come first)."""

    def __init__(self, args, nice=False, **extra):
        script, *rest = args
        if nice:
            script = "import os; os.nice(5)\n" + script
        self.proc = subprocess.Popen([sys.executable, "-c", script] + rest,
                                     env=env(**extra),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.out = None

    def lines(self, tag, timeout=600):
        if self.out is None:
            try:
                self.out = self.proc.communicate(timeout=timeout)[0]
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
        assert self.proc.returncode == 0, self.out
        return [json.loads(ln.split(" ", 1)[1])
                for ln in self.out.splitlines() if ln.startswith(tag + " ")]


def batch():
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# (a) numerics on a 2x2 mesh of gloo ranks
# ---------------------------------------------------------------------------

WORKER = r"""
import datetime, sys, torch, torch.distributed as dist
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.distributed.sharding import (batch_specs, distribute, gather,
                                              opt_specs, param_specs)
from repro_torch.launch.mesh import AbstractMesh, device_mesh
from repro_torch.launch.steps import (make_prefill_step, make_train_step,
                                      value_and_grad)
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init
rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
for name in sys.argv[5:]:
    state = torch.load(f"{path}/{name}.pt")
    am = AbstractMesh(tuple(state["axes"]), tuple(state["sizes"]))
    mesh = device_mesh(am, "cpu")
    cfg, opt_cfg = ModelConfig(**state["cfg"]), AdamWConfig(**state["opt"])
    pspec = param_specs(cfg, am, state["params"])
    params = distribute(state["params"], pspec, mesh)
    opt = distribute(adamw_init(state["params"], opt_cfg), opt_specs(pspec),
                     mesh)
    bspec = batch_specs(cfg, am)
    data = distribute(state["batch"], {k: bspec[k] for k in state["batch"]},
                      mesh)
    step = make_train_step(cfg, opt_cfg)
    losses = []
    with activation_sharding(mesh):
        grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b), params,
                               data)[1]
        first = make_prefill_step(cfg)(params, {"tokens": data["tokens"]})
        first = {"logits0": gather(first[0]), "k0": gather(first[1]["k"])}
        for _ in range(state["steps"]):
            params, opt, met = step(params, opt, data)
            losses.append(float(met["loss"].full_tensor()))
        logits, cache = make_prefill_step(cfg)(params,
                                               {"tokens": data["tokens"]})
    out = {"losses": losses, "params": gather(params),
           "logits": gather(logits), "k": gather(cache["k"]),
           "grads": gather(grads), **first,
           "placements": {k: str(v.placements)
                          for k, v in params["layers"].items()}}
    if rank == 0:
        torch.save(out, f"{path}/{name}.out.pt")
dist.destroy_process_group()
"""

#: a config of 6 heads over 2 kv heads with tied embeddings: on a model
#: axis of 4 its kv heads are repeated (``ctx.kv_weight``), its query
#: groups of 3 padded to 4 (``ctx.pad_heads``), its head is the embedding
#: split over the vocabulary, and the prefill's cache takes the repeated
#: heads back (``models.model._cache_slot``)
HEADS = dict(TINY, name="tiny-heads", n_heads=6, tie_embeddings=True)
HEADS_CFG, J_HEADS_CFG = ModelConfig(**HEADS), JModelConfig(**HEADS)
#: the meshes of 4 gloo ranks (a) runs on: name -> (config, axes, sizes)
MESHES = {
    "2x2": (TINY, ("data", "model"), (2, 2)),
    "heads": (HEADS, ("data", "model"), (1, 4)),
    "pod": (TINY, ("pod", "data", "model"), (2, 2, 1)),
}


def start_ranks(path, jparams):
    """4 gloo ranks, side by side, that run each of MESHES in turn from
    the reference's parameters ``jparams[config name]`` (the state and
    results of each under ``path``)."""
    for name, (cfg, axes, sizes) in MESHES.items():
        torch.save({"cfg": cfg, "opt": OPT, "steps": STEPS, "axes": axes,
                    "sizes": sizes, "params": start_params(jparams[
                        cfg["name"]]),
                    "batch": {k: torch.from_numpy(v)
                              for k, v in batch().items()}},
                   path / f"{name}.pt")
    port = str(free_port())
    return [Job([WORKER, str(r), "4", port, str(path), *MESHES], nice=True)
            for r in range(4)]


def unsharded(params, cfg=CFG):
    """The port's plain steps from ``params`` (changed in place), and the
    first step's gradients."""
    step = make_train_step(cfg, AdamWConfig(**OPT))
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    grads = value_and_grad(lambda p, bb: loss_fn(cfg, p, bb), params, b)[1]
    logits0, cache0 = make_prefill_step(cfg)(params, {"tokens": b["tokens"]})
    opt = adamw_init(params, AdamWConfig(**OPT))
    losses = []
    for _ in range(STEPS):
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
    logits, cache = make_prefill_step(cfg)(params, {"tokens": b["tokens"]})
    return {"losses": losses, "params": params, "logits": logits,
            "k": cache["k"], "grads": grads, "logits0": logits0,
            "k0": cache0["k"]}


def reference(jparams, j_cfg=J_CFG):
    j_opt_cfg = JAdamWConfig(**OPT)
    step = jax.jit(JS.make_train_step(j_cfg, j_opt_cfg))
    opt = j_adamw_init(jparams, j_opt_cfg)
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    losses = []
    for _ in range(STEPS):
        jparams, opt, met = step(jparams, opt, b)
        losses.append(float(met["loss"]))
    logits, cache = JS.make_prefill_step(j_cfg)(jparams,
                                                {"tokens": b["tokens"]})
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return {"losses": losses, "params": params,
            "logits": torch.from_numpy(np.asarray(logits)),
            "k": torch.from_numpy(np.asarray(cache["k"]))}


def max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def max_param_diff(a, b):
    return max(float((x - dict(tree_items(b))[k]).abs().max())
               for k, x in tree_items(a))


def held_param_diff(a, b, grads):
    """The largest parameter difference where the first gradient is at
    least GRAD_FLOOR, and the share of entries held so."""
    b, grads = dict(tree_items(b)), dict(tree_items(grads))
    worst, held_n, n = 0.0, 0, 0
    for k, x in tree_items(a):
        held = grads[k].abs() >= GRAD_FLOOR
        worst = max(worst, float(((x - b[k]).abs() * held).max()))
        held_n, n = held_n + int(held.sum()), n + held.numel()
    return worst, held_n / n


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every subprocess of the module, started side by side: each mesh's
    four ranks (a), the reference's compile on eight host devices (b), the
    counted cells in CELL_PARTS parts (c) and the one-rank mesh runs
    (d)."""
    path = tmp_path_factory.mktemp("mesh")
    jparams = {c["name"]: JM.init_params(JModelConfig(**c),
                                         jax.random.PRNGKey(0))
               for c in (TINY, HEADS)}
    out = {"path": path,
           "cells": [Job([CELLS_SCRIPT, json.dumps(part)], nice=True)
                     for part in cell_parts(CELL_PARTS)],
           "ranks": start_ranks(path, jparams),
           "ref8": Job([REF_SCRIPT, json.dumps(TINY),
                        json.dumps(list(dataclasses.astuple(TRAIN)))],
                       nice=True,
                       XLA_FLAGS="--xla_force_host_platform_device_count=8"),
           "one": {dt: Job([ONE_RANK, json.dumps(dict(
               TINY, tie_embeddings=True, param_dtype=dt)),
               str(free_port())], nice=True)
               for dt in ("float32", "bfloat16")}}
    # this process's share, while the subprocesses run
    out.update(plain=unsharded(start_params(jparams[TINY["name"]])),
               ref=reference(jparams[TINY["name"]]),
               heads_plain=unsharded(start_params(jparams[HEADS["name"]]),
                                     HEADS_CFG),
               heads_ref=reference(jparams[HEADS["name"]], J_HEADS_CFG),
               count8=dryrun.mesh_count(CFG, TRAIN, MESH8))
    yield out
    started = out["ranks"] + out["cells"] + list(out["one"].values())
    for job in started + [out["ref8"]]:
        if job.proc.poll() is None:
            job.proc.kill()
            job.proc.wait()


def start_params(jparams):
    return model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def mesh_out(jobs, name):
    """MESHES[name]'s gathered results, once the ranks have ended."""
    for job in jobs["ranks"]:
        job.lines("")
    return torch.load(jobs["path"] / f"{name}.out.pt")


@pytest.fixture(scope="module")
def runs(jobs):
    return {"mesh": mesh_out(jobs, "2x2"),
            "plain": jobs["plain"], "ref": jobs["ref"]}


@pytest.mark.parametrize("against", ["ref", "plain"])
def test_sharded_train_steps_match(runs, against):
    """Two train steps on the 2x2 mesh: each loss within LOSS_REL and every
    gathered parameter within PARAM_ABS of the port's unsharded steps, and
    within REF_REL / REF_PARAM_ABS of the reference's jitted steps (the
    port's own float32 distance from XLA's order on one device); the
    weights laid out as the specs say (FSDP on ``data``, TP on
    ``model``)."""
    got, want = runs["mesh"], runs[against]
    rel, tol = ((LOSS_REL, PARAM_ABS) if against == "plain"
                else (REF_REL, REF_PARAM_ABS))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rel)
    assert max_param_diff(got["params"], want["params"]) <= tol
    assert got["placements"]["wq"] == "(Shard(dim=1), Shard(dim=2))"
    assert got["placements"]["ln1"] == "(Replicate(), Replicate())"


@pytest.mark.parametrize("against", ["ref", "plain"])
def test_sharded_prefill_matches(runs, against):
    """The prefill after those steps on the 2x2 mesh: the last position's
    logits, and the kv cache (written from the heads' layout into the
    cache's: batch on ``data``, sequence on ``model``), within LOGITS_REL
    of the unsharded port's and within REF_REL of the reference's."""
    got, want = runs["mesh"], runs[against]
    tol = LOGITS_REL if against == "plain" else REF_REL
    assert got["logits"].shape == want["logits"].shape
    assert max_rel(got["logits"], want["logits"]) <= tol
    assert got["k"].shape == want["k"].shape
    assert max_rel(got["k"], want["k"]) <= tol


@pytest.mark.parametrize("name", ["heads", "pod"])
@pytest.mark.parametrize("against", ["ref", "plain"])
def test_other_meshes_match(jobs, name, against):
    """The two train steps and the prefill on the other meshes of 4 ranks,
    against the port's unsharded steps: losses within LOSS_REL, the first
    gradients within GRAD_REL, the prefill's logits and k cache from the
    start parameters within LOGITS_REL, the gathered parameters within
    PARAM_ABS where the first gradient is at least GRAD_FLOOR (see there)
    and the prefill after the steps within REF_REL; against the
    reference's jitted steps: losses, logits and k cache within REF_REL,
    every parameter within REF_PARAM_ABS.  "heads": 6 heads over 2 kv
    heads on a (1, 4) ``data, model`` mesh with tied embeddings (kv heads
    repeated 2 -> 4, query groups padded 3 -> 4, the head the
    vocabulary-split embedding, the cache's heads taken back 4 -> 2);
    "pod": a (2, 2, 1)
    ``pod, data, model`` mesh (each weight's FSDP gather one all-gather
    over ``pod, data``, its gradient one reduce-scatter:
    ``ctx._GatherData``)."""
    got = mesh_out(jobs, name)
    plain = jobs["heads_plain" if name == "heads" else "plain"]
    want = jobs[f"heads_{against}" if name == "heads" else against]
    rel, tol = ((LOSS_REL, PARAM_ABS) if against == "plain"
                else (REF_REL, REF_PARAM_ABS))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rel)
    if against == "plain":
        for k, g in tree_items(plain["grads"]):
            assert max_rel(dict(tree_items(got["grads"]))[k], g) <= GRAD_REL
        for key in ("logits0", "k0"):
            assert max_rel(got[key], want[key]) <= LOGITS_REL, key
        worst, share = held_param_diff(got["params"], want["params"],
                                       plain["grads"])
        assert worst <= tol and share >= HELD_SHARE, (worst, share)
    else:
        assert max_param_diff(got["params"], want["params"]) <= tol
    for key in ("logits", "k"):
        assert got[key].shape == want[key].shape
        assert max_rel(got[key], want[key]) <= REF_REL, key
    if name == "heads":
        assert "lm_head" not in got["params"]
        assert got["placements"]["wq"] == "(Shard(dim=1), Shard(dim=2))"
    else:
        assert got["placements"]["wq"] == (
            "(Shard(dim=1), Shard(dim=1), Shard(dim=2))")


# ---------------------------------------------------------------------------
# (b) the count on a (2, 2, 2) mesh
# ---------------------------------------------------------------------------

MESH8 = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
TRAIN = ShapeConfig("tiny train", "train", 128, 8)

REF_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ModelConfig, ShapeConfig
from repro.distributed.ctx import activation_sharding
from repro.distributed.sharding import (batch_specs, data_axes, named,
                                        opt_specs, param_specs)
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.steps import (input_specs, make_train_step, opt_shape,
                                params_shape)
from repro.optim.adamw import AdamWConfig
cfg = ModelConfig(**json.loads(sys.argv[1]))
shape = ShapeConfig(*json.loads(sys.argv[2]))
groups = int(sys.argv[3]) if len(sys.argv) > 3 else 1
devs = np.asarray(jax.devices()[:8], dtype=object).reshape(2, 2, 2)
mesh = Mesh(devs, ("pod", "data", "model"))
pshape = params_shape(cfg)
pspec = param_specs(cfg, mesh, pshape, fsdp=True)
ospec = opt_specs(pspec)
opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
with mesh, activation_sharding(data_axes(mesh), "model", 4, 2,
                               moe_groups=groups):
    jitted = jax.jit(make_train_step(cfg, opt_cfg),
                     in_shardings=(named(mesh, pspec), named(mesh, ospec),
                                   named(mesh, batch_specs(cfg, mesh))),
                     out_shardings=(named(mesh, pspec), named(mesh, ospec),
                                    None), donate_argnums=(0, 1))
    compiled = jitted.lower(pshape, opt_shape(cfg, opt_cfg),
                            input_specs(cfg, shape)).compile()
costs = analyze_hlo(compiled.as_text(), 8)
print("REF", json.dumps({"flops": costs.flops, "coll": costs.coll}))
"""


@pytest.fixture(scope="module")
def count8(jobs):
    return jobs["count8"]


def test_fsdp_collectives_equal_a_hand_count(count8):
    """The all-gathers and reduce-scatters over the flattened ``pod,
    data`` group are the parameters' FSDP gathers and gradient
    reduce-scatters, one collective each over the 4 ranks (not one an
    axis): counted against the specs by hand.  Each weight of the
    ``Spec(.., (pod, data), ..)`` kind is gathered before each use, so a
    layer's weights twice a step under remat (the forward and the
    backward's recompute), the embedding (its lookup) and the head (the
    loss) once; each gradient is reduce-scattered once.  Ring wire bytes
    (the reference's ``collective_wire``): an all-gather sends (G - 1) / G
    of its result, a reduce-scatter G - 1 times its result (a shard)."""
    f32, G = 4, 4
    # per-device shards (float32 bytes) on (2, 2, 2): dims over (pod, data)
    # split 4 ways, over model 2 ways (param_specs)
    shard = {  # name: (shard shape, uses a step)
        "embed": ((256 // 2, 64 // 4), 1),            # Spec(model, dp)
        "lm_head": ((64 // 4, 256 // 2), 1),          # Spec(dp, model)
        "wq": ((64 // 4, 64 // 2), 2 * 2),            # 2 layers x remat
        "wk": ((64 // 4, 32 // 2), 2 * 2),
        "wv": ((64 // 4, 32 // 2), 2 * 2),
        "wo": ((64 // 2, 64 // 4), 2 * 2),            # Spec(model, dp)
        "w_gate": ((64 // 4, 128 // 2), 2 * 2),
        "w_up": ((64 // 4, 128 // 2), 2 * 2),
        "w_down": ((128 // 2, 64 // 4), 2 * 2),
    }
    specs = param_specs(CFG, MESH8, params_shape(CFG))
    for name, (sh, _) in shard.items():
        spec = specs[name] if name in specs else specs["layers"][name]
        full = (params_shape(CFG)[name] if name in specs
                else params_shape(CFG)["layers"][name][0])
        assert shard_shape(spec[-2:], tuple(full.shape), MESH8) == sh
    gathers = sum(u for _, u in shard.values())
    gather_wire = sum(u * (G - 1) / G * G * np.prod(sh) * f32
                      for sh, u in shard.values())
    scatters = 2 + 7 * 2                  # embed, lm_head; 7 a layer
    scatter_wire = sum((G - 1) * np.prod(sh) * f32
                       * (1 if n in ("embed", "lm_head") else 2)
                       for n, (sh, _) in shard.items())
    fsdp = count8["collectives"]["pod,data"]
    assert fsdp["all-gather"] == {"calls": gathers, "wire_bytes": gather_wire}
    assert fsdp["reduce-scatter"] == {"calls": scatters,
                                      "wire_bytes": scatter_wire}
    assert (gathers, gather_wire, scatters, scatter_wire) == (
        30, 270336, 16, 159744)
    costs = count8["costs"]
    assert costs.coll["all-gather"] >= gather_wire
    assert costs.coll["reduce-scatter"] >= scatter_wire
    assert costs.bytes_by["collective"] > 0
    # the kernels ran on each rank's shards: 2 heads of 4, 2 of 8 sequences
    k = costs.kernels["flash_attention"]
    assert k["launches"] == 4 and k["flops"] == 4 * 4 * (
        2 * 2 * 16 * 128 * 129 // 2)


#: the port's per-device FLOPs over the reference's partitioned count of
#: the same step (PERF.md section 5): within 25 %
FLOPS_RATIO = (0.75, 1.25)


def test_flops_per_device_near_the_reference(count8, jobs):
    """The count's FLOPs per device within 25 % of the reference's step
    compiled for a (2, 2, 2) mesh of eight forced host devices and walked
    by its ``hlo_analysis`` (the port: 1.605e8, the reference: 1.778e8,
    ratio 0.90; GSPMD picks its own collectives and fusions)."""
    ref, = jobs["ref8"].lines("REF")
    ratio = count8["costs"].flops / ref["flops"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio


# ---------------------------------------------------------------------------
# (c) every counted cell's per-device record
# ---------------------------------------------------------------------------

DENSE = ("llama3.2-3b", "granite-8b", "mistral-nemo-12b", "qwen3-32b")
#: the archs whose train_4k and prefill_32k cells are counted per device:
#: the dense ones, the VL backbone and the MoE family
COUNTED = DENSE + ("qwen2-vl-72b", "olmoe-1b-7b", "grok-1-314b")
#: the subprocesses that count them side by side
CELL_PARTS = 5
#: per-device argument bytes of each cell on (16x16, 2x16x16), as the
#: specs' layout alone counts them (``dryrun.mesh_cell``; held against the
#: reference's specs by tests/test_torch_sharding_specs.py)
ARGUMENT_BYTES = {
    ("llama3.2-3b", "train_4k"): (127766532, 64758788),
    ("llama3.2-3b", "prefill_32k"): (25710592, 13030400),
    ("granite-8b", "train_4k"): (325951492, 164470788),
    ("granite-8b", "prefill_32k"): (65347584, 32972800),
    ("mistral-nemo-12b", "train_4k"): (483084292, 243615748),
    ("mistral-nemo-12b", "prefill_32k"): (96774144, 48801792),
    ("qwen3-32b", "train_4k"): (1287088132, 646928388),
    ("qwen3-32b", "prefill_32k"): (257574912, 129464320),
    ("qwen2-vl-72b", "train_4k"): (1712439300, 860176388),
    ("qwen2-vl-72b", "prefill_32k"): (570900480, 286769152),
    ("olmoe-1b-7b", "train_4k"): (272764932, 136740868),
    ("olmoe-1b-7b", "prefill_32k"): (54710272, 27426816),
    ("grok-1-314b", "train_4k"): (7424086020, 3714420740),
    ("grok-1-314b", "prefill_32k"): (2474782720, 1238183936),
}

CELLS_SCRIPT = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import params_shape
stand_ins = {}
for cell in json.loads(sys.argv[1]):
    if cell[0] not in stand_ins:
        stand_ins[cell[0]] = params_shape(get_config(cell[0]))
    r = dryrun.counted_mesh_cell(*cell, params=stand_ins[cell[0]])
    r.pop("unsharded")
    print("CELL", json.dumps(r), flush=True)
"""


#: (arch, shape) -> its count's seconds in one process on (16x16,
#: 2x16x16), the share of the work that cell_parts balances (``python -m
#: repro_torch.launch.dryrun --all --mesh both``, one thread)
CELL_SECONDS = {
    ("qwen3-32b", "train_4k"): (8.0, 19.8),
    ("qwen3-32b", "prefill_32k"): (3.9, 7.6),
    ("granite-8b", "train_4k"): (6.6, 14.5),
    ("granite-8b", "prefill_32k"): (2.2, 4.5),
    ("mistral-nemo-12b", "train_4k"): (6.2, 10.6),
    ("mistral-nemo-12b", "prefill_32k"): (1.9, 2.1),
    ("llama3.2-3b", "train_4k"): (5.4, 10.0),
    ("llama3.2-3b", "prefill_32k"): (1.3, 2.7),
    ("qwen2-vl-72b", "train_4k"): (13.1, 14.2),
    ("qwen2-vl-72b", "prefill_32k"): (3.5, 6.0),
    ("olmoe-1b-7b", "train_4k"): (4.7, 7.4),
    ("olmoe-1b-7b", "prefill_32k"): (1.5, 1.8),
    ("grok-1-314b", "train_4k"): (13.4, 20.7),
    ("grok-1-314b", "prefill_32k"): (4.5, 6.4),
}


def cell_parts(n):
    """The counted cells in ``n`` parts of about equal work
    (CELL_SECONDS), largest first."""
    cells = sorted(([a, s, mp] for a in COUNTED
                    for s in ("train_4k", "prefill_32k")
                    for mp in (False, True)),
                   key=lambda c: -CELL_SECONDS[tuple(c[:2])][c[2]])
    parts, load = [[] for _ in range(n)], [0.0] * n
    for c in cells:
        i = load.index(min(load))
        parts[i].append(c)
        load[i] += CELL_SECONDS[tuple(c[:2])][c[2]]
    return parts


@pytest.fixture(scope="module")
def mesh_cells(jobs):
    recs = [r for job in jobs["cells"] for r in job.lines("CELL")]
    assert len(recs) == 2 * 2 * len(COUNTED)
    return recs


def test_every_dense_cell_counts_its_partitioned_step(mesh_cells):
    """Each counted ``train_4k`` / ``prefill_32k`` record (the dense
    archs, the VL backbone and the MoE family) on both layouts: no
    per-device field ``null`` (FLOPs, bytes by category, temporaries,
    peak = argument + temp, wire bytes by kind), the FSDP and sequence
    collectives on their axes, the hand-written kernels launched on
    shards, and the argument bytes the layout's alone.  A MoE record
    counts its plan's groups (olmoe-1b-7b's 16) and says its dispatch is
    at its upper bound; where a group spans several data ranks (grok's
    one group; olmoe's 16 over 2x16x16's 32) its rows move by
    all-to-all."""
    for r in mesh_cells:
        mem = r["memory"]
        for v in (r["flops_per_device"], r["bytes_per_device"],
                  mem["temp_bytes"], mem["peak_bytes"],
                  r["collective_total"]):
            assert v is not None and v > 0, r["arch"]
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert set(r["collective_wire_bytes_per_device"]) == set(
            dryrun.COLL_KINDS)
        assert r["collective_wire_bytes_per_device"]["all-gather"] > 0
        assert all(v is not None for v in r["bytes_by_category"].values())
        data = "pod,data" if r["mesh"] == "2x16x16" else "data"
        assert r["collectives"][data]["all-gather"]["calls"] > 0
        assert r["collectives"]["model"]["all-gather"]["calls"] > 0
        assert r["kernels"]["flash_attention"]["launches"] > 0
        assert r["kernels"]["rmsnorm"]["launches"] > 0
        if r["shape"] == "train_4k":
            assert r["collectives"][data]["reduce-scatter"]["calls"] > 0
            assert r["kernels"]["flash_attention_bwd"]["launches"] > 0
        want = ARGUMENT_BYTES[(r["arch"], r["shape"])]
        assert mem["argument_bytes"] == want[r["mesh"] == "2x16x16"]
        assert mem["peak_bytes"] < dryrun.CARD_BYTES
        assert "partition" not in r["not_counted"]
        if get_config(r["arch"]).family == "moe":
            groups = r["moe_groups"]
            assert groups == (16 if r["arch"] == "olmoe-1b-7b" else 1)
            assert r["moe_gather"] == dryrun.MOE_COUNTED
            ranks = (32 if r["mesh"] == "2x16x16" else 16) // groups
            span = r["collectives"].get(f"moe span of {ranks}", {})
            assert (span.get("all-to-all", {}).get("calls", 0) > 0) == (
                ranks > 1), (r["arch"], r["mesh"], r["shape"])


def test_other_cells_say_why_they_are_not_counted():
    """An SSM, hybrid, enc-dec or decode cell keeps ``null`` with its
    family or kind named; the layout alone (``mesh_cell``) counts
    nothing."""
    for arch, shape, word in (("mamba2-2.7b", "train_4k", "ssm"),
                              ("zamba2-7b", "prefill_32k", "hybrid"),
                              ("whisper-small", "train_4k", "encdec"),
                              ("llama3.2-3b", "decode_32k", "decode")):
        r = dryrun.counted_mesh_cell(arch, shape, False)
        assert r["flops_per_device"] is None and word in r["not_counted"]
        assert "partition" in r["not_counted"]
    r = dryrun.mesh_cell("llama3.2-3b", "train_4k", False)
    assert r["flops_per_device"] is None
    assert r["memory"]["argument_bytes"] == ARGUMENT_BYTES[
        ("llama3.2-3b", "train_4k")][0]


#: the applicable (arch, shape) cells of the grid
APPLICABLE = [(a, s) for a in ARCH_NAMES for s in SHAPES
              if applicable(get_config(a), SHAPES[s])[0]]


def test_dryrun_all_mesh_both(tmp_path, monkeypatch, capsys, mesh_cells):
    """``--all --mesh both``: 80 records, 16x16 and 2x16x16 for each of
    the 40 cells, 64 counted (32 applicable cells on each mesh) and 16
    skipped, none with an error, every counted one's arguments within
    the card's 80 GB.  The 28 partitioned steps are the ``mesh_cells``
    records (each cell counted once a run): ``counted_mesh_cell`` looks
    them up, and lays out the rest, which count nothing.  Those 28 have
    no ``null`` per-device field; every other applicable record is
    ``null`` there and names why."""
    counted = {(r["arch"], r["shape"], r["mesh"]): r for r in mesh_cells}
    laid_out = dryrun.counted_mesh_cell

    def lookup(arch, shape, multi_pod, fsdp=True, params=None):
        key = (arch, shape, dryrun.mesh_name(multi_pod))
        if key in counted:
            return counted[key]
        r = laid_out(arch, shape, multi_pod, fsdp, params)
        assert r.get("flops_per_device") is None, key
        return r

    monkeypatch.setattr(dryrun, "counted_mesh_cell", lookup)
    out = tmp_path / "all.json"
    dryrun.main(["--all", "--mesh", "both", "--out", str(out)])
    capsys.readouterr()
    recs = json.loads(out.read_text())
    assert len(recs) == 80
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"] * 40
    assert not [r for r in recs if "error" in r]
    applied = [r for r in recs if "skipped" not in r]
    assert len(applied) == 64 and len(APPLICABLE) == 32
    assert all(r["arguments_fit_80gb"] for r in applied)
    full = [r for r in applied if r["flops_per_device"] is not None]
    assert len(full) == 28
    for r in full:
        assert None not in (r["bytes_per_device"],
                            r["memory"]["temp_bytes"],
                            r["memory"]["peak_bytes"],
                            r["collective_total"])
    for r in applied:
        if r["flops_per_device"] is None:
            assert r["bytes_per_device"] is None
            assert r["memory"]["peak_bytes"] is None
            assert "later slice of the port" in r["not_counted"], r["arch"]


# ---------------------------------------------------------------------------
# (d) regressions: no mesh, and a (1, 1) mesh
# ---------------------------------------------------------------------------

def test_wrappers_and_ctx_are_unchanged_without_a_mesh():
    """Plain CPU tensors: the kernels' wrappers give their plain versions'
    results bit for bit and count no launch; the ``ctx`` functions return
    their argument itself."""
    from repro_torch import kernels
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=g)
    k, v = torch.randn(2, 16, 2, 8, generator=g), torch.randn(
        2, 16, 2, 8, generator=g)
    x, w = torch.randn(3, 5, 8, generator=g), torch.randn(8, generator=g)
    kernels.reset_launch_counts()
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(rmsnorm(x, w), rmsnorm_ref(x, w))
    assert not any(kernels.launch_counts().values())
    for fn in (ctx.constrain_boundary, ctx.gather_weight, ctx.gather_model,
               ctx.replicate, ctx.constrain_tokens_grouped):
        assert fn(x) is x
    assert ctx.like(x, w) is x and ctx.kv_weight(x, 2, 4) is x
    assert ctx.constrain_expert_weights(x, "up") is x
    assert ctx.mesh() is None


def test_kernels_run_on_each_ranks_shards():
    """Rank 0 of a 2x2 fake group on the CPU: the flash wrappers on q, k,
    v split by batch (``data``) and heads (``model``) give, as rank 0's
    shard, the plain version of its slice (lse too, its heads on dim 1);
    rmsnorm on rows split both ways likewise; a sequence split or an
    unreplicated weight raises (no plain-version fallback)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention import (flash_attention_lse,
                                                     flash_attention_lse_ref)
    from repro_torch.launch.mesh import device_mesh, fake_world
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 16, 4, 8, generator=g)
    k, v = (torch.randn(4, 16, 2, 8, generator=g) for _ in range(2))
    x, w = torch.randn(4, 6, 8, generator=g), torch.randn(8, generator=g)
    with fake_world(4):
        mesh = device_mesh(AbstractMesh(("data", "model"), (2, 2)), "cpu")
        d = lambda t, pl: distribute_tensor(  # noqa: E731
            t, mesh, pl, src_data_rank=None)
        pl = [Shard(0), Shard(2)]
        o, lse = flash_attention_lse(d(q, pl), d(k, pl), d(v, pl))
        mine = (q[:2, :, :2], k[:2, :, :1], v[:2, :, :1])
        want_o = flash_attention_ref(*mine, causal=True)
        want_lse = flash_attention_lse_ref(*mine, causal=True)
        assert torch.equal(o.to_local(), want_o)
        assert lse.placements == (Shard(0), Shard(1))
        assert torch.equal(lse.to_local(), want_lse)
        assert torch.equal(flash_attention(d(q, pl), d(k, pl), d(v, pl))
                           .to_local(), want_o)
        rows = rmsnorm(d(x, [Shard(0), Shard(1)]), d(w, [Replicate()] * 2))
        assert torch.equal(rows.to_local(), rmsnorm_ref(x[:2, :3], w))
        seq = [Shard(0), Shard(1)]
        with pytest.raises(ValueError):
            flash_attention(d(q, seq), d(k, seq), d(v, seq))
        with pytest.raises(ValueError):
            rmsnorm(d(x, [Shard(0), Shard(1)]), d(w, [Shard(0), Replicate()]))


ONE_RANK = r"""
import dataclasses, json, sys, torch, torch.distributed as dist
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.distributed.sharding import (batch_specs, distribute, gather,
                                              opt_specs, param_specs)
from repro_torch.launch.mesh import AbstractMesh, device_mesh
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_items
cfg = ModelConfig(**json.loads(sys.argv[1]))
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
g = torch.Generator().manual_seed(1)
data = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                         dtype=torch.int32) for k in ("tokens", "labels")}

def run(mesh=None):
    p = init_params(cfg, 0, device="cpu")
    o = adamw_init(p, opt_cfg)
    b = dict(data)
    if mesh is not None:
        am = AbstractMesh(("data", "model"), (1, 1))
        ps = param_specs(cfg, am, p)
        p, o = distribute(p, ps, mesh), distribute(o, opt_specs(ps), mesh)
        b = distribute(b, dict(batch_specs(cfg, am)), mesh)
    losses = []
    with activation_sharding(mesh):
        for mb in (1, 2):
            p, o, met = make_train_step(cfg, opt_cfg, microbatches=mb)(p, o, b)
            losses.append(float(gather(met["loss"])))
        lg = make_prefill_step(cfg)(p, {"tokens": b["tokens"]})[0]
    return losses, dict(tree_items(gather(p))), gather(lg)

plain = run()
dist.init_process_group("gloo", init_method=f"tcp://localhost:{sys.argv[2]}",
                        rank=0, world_size=1)
mesh = device_mesh(AbstractMesh(("data", "model"), (1, 1)), "cpu")
sharded = run(mesh)
dist.destroy_process_group()
same = (plain[0] == sharded[0]
        and all(torch.equal(v, sharded[1][k]) for k, v in plain[1].items())
        and torch.equal(plain[2], sharded[2]))
print("ONE", json.dumps({
    "same": same, "losses": [plain[0], sharded[0]],
    "params_abs": max(float((v.float() - sharded[1][k].float()).abs().max())
                      for k, v in plain[1].items()),
    "logits_rel": float((plain[2] - sharded[2]).float().abs().max()
                        / plain[2].float().abs().max())}))
"""


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_mesh_matches_no_mesh(dtype, jobs):
    """Every leaf a DTensor on a (1, 1) ``data, model`` mesh of one gloo
    rank, tied embeddings (llama3.2-3b's): two train steps' losses (the
    second in two microbatches) equal the unsharded port's bit for bit.
    In bf16 the parameters and the prefill's logits are bit-equal too
    (chip_smoke [25a] holds the same at full size on the card).  In
    float32 the CPU's BLAS rounds the attention weights' gradients by
    their operands' layout, which
    DTensor's strategies change where they copy a transposed operand
    (measured: gradients within 3e-8); two AdamW steps then leave the
    parameters within PARAM_ABS and the logits within LOGITS_REL."""
    res, = jobs["one"][dtype].lines("ONE")
    assert res["losses"][0] == res["losses"][1]
    if dtype == "bfloat16":
        assert res["same"] and res["params_abs"] == 0.0, res
    else:
        assert res["params_abs"] <= PARAM_ABS, res
        assert res["logits_rel"] <= LOGITS_REL, res


def test_sharded_forward_refuses_what_it_does_not_cover():
    """The partitioned stack is the dense (VL too) and MoE families': the
    SSM or hybrid family or a prefill cache longer than the prompt raise;
    so do kv heads that neither divide nor are divided by the model axis,
    and query groups that do not split evenly are padded (3 -> 4 on a
    model axis of 4 with 2 kv heads)."""
    from repro_torch.launch.mesh import device_mesh, fake_world
    from repro_torch.models.model import _check_sharded
    with fake_world(4):
        mesh = device_mesh(AbstractMesh(("data", "model"), (1, 4)), "cpu")
        assert ctx.head_groups(CFG, mesh) == 2
        assert ctx.head_groups(dataclasses.replace(CFG, n_heads=6),
                               mesh) == 4
        with pytest.raises(ValueError):
            ctx.head_groups(dataclasses.replace(CFG, n_heads=6,
                                                n_kv_heads=3), mesh)
    with pytest.raises(NotImplementedError):
        _check_sharded(dataclasses.replace(CFG, family="ssm"), 8, None)
    with pytest.raises(NotImplementedError):
        _check_sharded(dataclasses.replace(CFG, family="hybrid"), 8, None)
    with pytest.raises(NotImplementedError):
        _check_sharded(CFG, 8, 16)
    _check_sharded(CFG, 8, 8)
    assert SHAPES["train_4k"].kind == "train"
