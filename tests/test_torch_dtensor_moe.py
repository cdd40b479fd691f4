"""The VL backbone and the MoE family partitioned over a torch
``DeviceMesh`` (DTensor in place of the reference's GSPMD), on the CPU.

(a) Numerics on meshes of 4 gloo ranks, each a process of its own: a tiny
    MoE config (4 experts, top-2, 2 layers, QK-norm, capacity factor 1,
    so that every group drops pairs) on a 2x2 ``data, model`` mesh with
    its dispatch in G = 2 groups (one a data rank), G = 4 (two a rank)
    and G = 1 (one group over both data ranks: the buffer split over
    them, rows moved by all-to-all), and on a (2, 2, 1) ``pod, data,
    model`` mesh at G = 2 (a group over two of the four data ranks); a
    tiny dense config with M-RoPE on 2x2.  Two train steps and the
    prefill from the reference's parameters (``repro_torch.convert``) and
    a numpy-seeded batch, gathered, against the port's unsharded steps at
    the same G and the reference's jitted steps, at the tolerances of the
    dense stack's tests (``test_torch_dtensor.py``).  ``expert_load`` of
    every step, each token's top-k choice and the kept (token, expert)
    pairs of the prefill are equal exactly; the spanning group's steps
    rerun bit for bit.
(b) The count: rank 0's share of the tiny MoE's train step on a (2, 2,
    2) ``pod, data, model`` mesh against the reference's partitioned
    compile of the same step with the same groups (``hlo_analysis``), and
    the dispatch's collectives on their axes.
(c) The regimes' edges: groups that neither divide nor are divided by
    the data ranks raise; ``constrain_tokens_grouped`` lays the groups
    over the data axes.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.distributed.ctx import (  # noqa: E402
    activation_sharding as j_activation_sharding)
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_train_step, value_and_grad)
from repro_torch.models.model import forward, loss_fn  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     tree_items)
from test_torch_dtensor import (FLOPS_RATIO, GRAD_FLOOR,  # noqa: E402
                                GRAD_REL, HELD_SHARE, LOGITS_REL, LOSS_REL,
                                MESH8, OPT, PARAM_ABS, REF_PARAM_ABS,
                                REF_REL, REF_SCRIPT, STEPS, TRAIN, Job, B, S,
                                free_port, max_param_diff, max_rel)

MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16, qk_norm=True,
           n_experts=4, experts_per_token=2, capacity_factor=1.0)
VL = dict(name="tiny-vl", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, mrope=True,
          rope_theta=1e6)
CONFIGS = {c["name"]: c for c in (MOE, VL)}
#: name -> (config, mesh axes, mesh sizes, dispatch groups G)
CASES = {
    "g2": (MOE, ("data", "model"), (2, 2), 2),
    "g4": (MOE, ("data", "model"), (2, 2), 4),
    "g1": (MOE, ("data", "model"), (2, 2), 1),
    "pod": (MOE, ("pod", "data", "model"), (2, 2, 1), 2),
    "vl": (VL, ("data", "model"), (2, 2), 1),
}
MOE_CASES = [n for n, c in CASES.items() if c[0] is MOE]
#: the tiny MoE's groups on (2, 2, 2): one a data rank (G = P, the
#: reference's groups laid over its data axes)
COUNT_GROUPS = 4
#: AdamW's second step moves a weight by lr * m / (sqrt(v) + eps), m the
#: bias-corrected first moment: where m is near 0 (the second gradient
#: near -0.9 times the first) rounding of the gradients moves it by any
#: fraction of lr, as eps does for the first step (GRAD_FLOOR).  The
#: gradients are held to GRAD_REL of each leaf's largest; so the
#: parameters are held where, besides the first gradient, the unsharded
#: port's final first moment is at least MOMENT_FLOOR times that bound
#: (measured: an lm_head entry of the G = 4 case with m = -3.0e-6, first
#: gradient 1.1e-5 and the leaf's bound 2.0e-7 moved 2.6e-5)
MOMENT_FLOOR = 20

#: the dispatch's records while open: each call's top-k (the router's
#: probabilities and choices) and kept pairs, with the global index of
#: its first token; ``base`` is the rank's first token, ``per_call`` the
#: tokens of a call, ``calls`` the calls of a layer
RECORDER = r"""
import contextlib, torch
from repro_torch.models import layers

@contextlib.contextmanager
def recording(base, per_call, calls):
    out = {"route": [], "kept": []}
    top_k, keep = layers.top_k, layers._keep

    def at(n):
        return base + (n % calls) * per_call, n // calls

    def rec_top_k(probs, k):
        vals, idx = top_k(probs, k)
        off, layer = at(len(out["route"]))
        out["route"].append((layer, off, probs.detach().clone(), idx.clone()))
        return vals, idx

    def rec_keep(order, e_sorted, k, E, C, below=None):
        rank, kp = keep(order, e_sorted, k, E, C, below)
        off, layer = at(len(out["kept"]))
        pairs = torch.stack([(order // k)[kp] + off, e_sorted[kp]], 1)
        out["kept"].append((layer, pairs.clone()))
        return rank, kp

    layers.top_k, layers._keep = rec_top_k, rec_keep
    try:
        yield out
    finally:
        layers.top_k, layers._keep = top_k, keep


def layout(records, T, L):
    # each layer's choices (T, k), probabilities (T, E), kept pairs sorted
    choice, probs, kept = [None] * L, [None] * L, [[] for _ in range(L)]
    for layer, off, p, idx in records["route"]:
        if choice[layer] is None:
            choice[layer] = torch.zeros((T, idx.shape[1]), dtype=idx.dtype)
            probs[layer] = torch.zeros((T, p.shape[1]), dtype=p.dtype)
        choice[layer][off:off + idx.shape[0]] = idx
        probs[layer][off:off + p.shape[0]] = p
    for layer, pairs in records["kept"]:
        kept[layer].append(pairs)
    kept = [torch.cat(k) for k in kept]
    kept = [k[torch.argsort(k[:, 0] * 1000 + k[:, 1])] for k in kept]
    return {"choice": choice, "probs": probs, "kept": kept}
"""

WORKER = RECORDER + r"""
import datetime, math, sys, torch.distributed as dist
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.distributed.sharding import (batch_specs, distribute, gather,
                                              opt_specs, param_specs)
from repro_torch.launch.mesh import AbstractMesh, device_mesh
from repro_torch.launch.steps import (make_prefill_step, make_train_step,
                                      value_and_grad)
from repro_torch.models.model import forward, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init
rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
for name in sys.argv[5:]:
    state = torch.load(f"{path}/{name.split('+')[0]}.pt")
    am = AbstractMesh(tuple(state["axes"]), tuple(state["sizes"]))
    mesh = device_mesh(am, "cpu")
    cfg, opt_cfg = ModelConfig(**state["cfg"]), AdamWConfig(**state["opt"])
    G = state["groups"]
    pspec = param_specs(cfg, am, state["params"])
    params = distribute(state["params"], pspec, mesh)
    opt = distribute(adamw_init(state["params"], opt_cfg), opt_specs(pspec),
                     mesh)
    bspec = batch_specs(cfg, am)
    data = distribute(state["batch"], {k: bspec[k] for k in state["batch"]},
                      mesh)
    # this rank's place among the data ranks and its first token
    dims = [i for i, n in enumerate(am.axis_names) if n != "model"]
    P = math.prod(am.axis_sizes[i] for i in dims)
    coord = mesh.get_coordinate()
    p = 0
    for i in dims:
        p = p * am.axis_sizes[i] + coord[i]
    T = data["tokens"].shape[0] * data["tokens"].shape[1]
    calls = G // P if G % P == 0 else 1
    per_call = T // G if G % P == 0 else T // P
    step = make_train_step(cfg, opt_cfg)
    losses, loads = [], []
    with activation_sharding(mesh, moe_groups=G):
        grads = value_and_grad(lambda p_, b: loss_fn(cfg, p_, b), params,
                               data)[1]
        with recording(p * (T // P), per_call, calls) as rec:
            first = make_prefill_step(cfg)(params, {"tokens": data["tokens"]})
        first = {"logits0": gather(first[0]), "k0": gather(first[1]["k"]),
                 "hidden0": gather(forward(cfg, params, data["tokens"])[0])}
        for _ in range(state["steps"]):
            params, opt, met = step(params, opt, data)
            losses.append(float(met["loss"].full_tensor()))
            if "expert_load" in met:
                loads.append(gather(met["expert_load"]))
        logits, cache = make_prefill_step(cfg)(params,
                                               {"tokens": data["tokens"]})
        hidden = forward(cfg, params, data["tokens"])[0]
    every = [None] * world
    dist.all_gather_object(every, (coord[-1], rec))
    merged = {"route": [], "kept": []}
    for model_rank, r in every:
        if model_rank == 0:
            for k in merged:
                merged[k] += r[k]
    out = {"losses": losses, "loads": loads, "params": gather(params),
           "logits": gather(logits), "k": gather(cache["k"]),
           "hidden": gather(hidden), "grads": gather(grads), **first,
           "routing": layout(merged, T, cfg.n_layers) if loads else None,
           "placements": {k: str(v.placements)
                          for k, v in params["layers"].items()}}
    if rank == 0:
        torch.save(out, f"{path}/{name}.out.pt")
dist.destroy_process_group()
"""

_NS = {}
exec(RECORDER, _NS)


def batch():
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, MOE["vocab_size"], (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def held_param_diff(got, plain):
    """The largest parameter difference where the first gradient is at
    least GRAD_FLOOR and the final first moment at least MOMENT_FLOOR
    times GRAD_REL of the leaf's largest first gradient, and the share of
    entries held so."""
    got, m = dict(tree_items(got)), dict(tree_items(plain["m"]))
    grads = dict(tree_items(plain["grads"]))
    bias = 1 - AdamWConfig(**OPT).b1 ** STEPS
    worst, held_n, n = 0.0, 0, 0
    for k, x in tree_items(plain["params"]):
        g = grads[k]
        floor = MOMENT_FLOOR * GRAD_REL * float(g.abs().max())
        held = (g.abs() >= GRAD_FLOOR) & (m[k].abs() / bias >= floor)
        worst = max(worst, float(((x - got[k]).abs() * held).max()))
        held_n, n = held_n + int(held.sum()), n + held.numel()
    return worst, held_n / n


def start_params(jparams):
    return model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def unsharded(params, cfg, groups):
    """The port's plain steps from ``params`` at ``groups``, as the mesh
    runs them."""
    step = make_train_step(cfg, AdamWConfig(**OPT))
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    T = B * S
    with ctx.activation_sharding(None, moe_groups=groups):
        grads = value_and_grad(lambda p, bb: loss_fn(cfg, p, bb), params,
                               b)[1]
        with _NS["recording"](0, T // groups, groups) as rec:
            logits0, cache0 = make_prefill_step(cfg)(params,
                                                     {"tokens": b["tokens"]})
        hidden0 = forward(cfg, params, b["tokens"])[0]
        opt = adamw_init(params, AdamWConfig(**OPT))
        losses, loads = [], []
        for _ in range(STEPS):
            params, opt, met = step(params, opt, b)
            losses.append(float(met["loss"]))
            if "expert_load" in met:
                loads.append(met["expert_load"])
        logits, cache = make_prefill_step(cfg)(params,
                                               {"tokens": b["tokens"]})
        hidden = forward(cfg, params, b["tokens"])[0]
    return {"losses": losses, "loads": loads, "params": params,
            "m": opt.m, "logits": logits, "k": cache["k"], "hidden": hidden,
            "grads": grads, "logits0": logits0, "k0": cache0["k"],
            "hidden0": hidden0,
            "routing": (_NS["layout"](rec, T, cfg.n_layers) if loads
                        else None)}


def reference(jparams, j_cfg, groups):
    j_opt_cfg = JAdamWConfig(**OPT)
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    with j_activation_sharding(None, None, 1, 1, moe_groups=groups):
        step = jax.jit(JS.make_train_step(j_cfg, j_opt_cfg))
        opt = j_adamw_init(jparams, j_opt_cfg)
        losses, loads = [], []
        for _ in range(STEPS):
            jparams, opt, met = step(jparams, opt, b)
            losses.append(float(met["loss"]))
            if "expert_load" in met:
                loads.append(torch.from_numpy(
                    np.asarray(met["expert_load"])))
        logits, cache = JS.make_prefill_step(j_cfg)(jparams,
                                                    {"tokens": b["tokens"]})
    return {"losses": losses, "loads": loads,
            "params": start_params(jparams),
            "logits": torch.from_numpy(np.asarray(logits)),
            "k": torch.from_numpy(np.asarray(cache["k"]))}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The four gloo ranks, which run every case of CASES in turn (and
    "g1" twice), and the reference's compile on eight host devices,
    started side by side; then this process's share: the unsharded port
    and the reference at each case's groups, and the count."""
    path = tmp_path_factory.mktemp("moe_mesh")
    jparams = {n: JM.init_params(JModelConfig(**c), jax.random.PRNGKey(0))
               for n, c in CONFIGS.items()}
    for name, (cfg, axes, sizes, groups) in CASES.items():
        torch.save({"cfg": cfg, "opt": OPT, "steps": STEPS, "axes": axes,
                    "sizes": sizes, "groups": groups,
                    "params": start_params(jparams[cfg["name"]]),
                    "batch": {k: torch.from_numpy(v)
                              for k, v in batch().items()}},
                   path / f"{name}.pt")
    port = str(free_port())
    names = list(CASES) + ["g1+rerun"]
    out = {"path": path,
           "ranks": [Job([WORKER, str(r), "4", port, str(path), *names],
                         nice=True) for r in range(4)],
           "ref8": Job([REF_SCRIPT, json.dumps(MOE),
                        json.dumps(list(dataclasses.astuple(TRAIN))),
                        str(COUNT_GROUPS)], nice=True,
                       XLA_FLAGS="--xla_force_host_platform_device_count=8")}
    runs = {}
    for name, (cfg, _, _, groups) in CASES.items():
        key = (cfg["name"], groups)
        if key not in runs:
            runs[key] = {
                "plain": unsharded(start_params(jparams[cfg["name"]]),
                                   ModelConfig(**cfg), groups),
                "ref": reference(jparams[cfg["name"]], JModelConfig(**cfg),
                                 groups)}
    out["runs"] = runs
    out["count8"] = dryrun.mesh_count(ModelConfig(**MOE), TRAIN, MESH8,
                                      moe_groups=COUNT_GROUPS)
    yield out
    for job in out["ranks"] + [out["ref8"]]:
        if job.proc.poll() is None:
            job.proc.kill()
            job.proc.wait()


def prefill_of(params, name):
    """The unsharded prefill and hidden states of ``params`` (gathered
    from a mesh) at CASES[name]'s config and groups."""
    cfg, _, _, groups = CASES[name]
    cfg = ModelConfig(**cfg)
    tokens = torch.from_numpy(batch()["tokens"])
    with ctx.activation_sharding(None, moe_groups=groups):
        logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
        hidden = forward(cfg, params, tokens)[0]
    return {"logits": logits, "k": cache["k"], "hidden": hidden}


def mesh_out(jobs, name):
    for job in jobs["ranks"]:
        job.lines("")
    return torch.load(jobs["path"] / f"{name}.out.pt")


def want(jobs, name, against):
    cfg, _, _, groups = CASES[name]
    return jobs["runs"][(cfg["name"], groups)][against]


# ---------------------------------------------------------------------------
# (a) numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["ref", "plain"])
def test_mesh_steps_match(jobs, name, against):
    """Two train steps and the prefill on the mesh, against the port's
    unsharded steps at the same groups: losses within LOSS_REL, the first
    gradients within GRAD_REL, the prefill's logits, k cache and the
    hidden states from the start parameters within LOGITS_REL, the
    gathered parameters within PARAM_ABS where the first gradient is at
    least GRAD_FLOOR (AdamW's first step moves a weight whose gradient is
    near eps by up to lr: ``test_torch_dtensor.py``) and the first moment
    clear of the gradients' rounding (MOMENT_FLOOR), and the prefill's
    logits, k cache and hidden states after the steps within LOGITS_REL
    of the unsharded prefill of the mesh's own parameters (the other
    entries' moves, up to lr, are in both: measured, a we_down entry
    whose first gradient is -7.0e-10 unsharded and 5.1e-9 on the G = 4
    mesh ends 1.5e-4 apart, and the k cache after the steps 1.2e-4);
    against the reference's
    jitted steps: losses, logits and k cache within REF_REL, every
    parameter within REF_PARAM_ABS.  The expert weights laid out as the
    specs say (F on ``model``, D on the data axes); every step's
    ``expert_load`` equal exactly to both."""
    got, exp = mesh_out(jobs, name), want(jobs, name, against)
    plain = want(jobs, name, "plain")
    rel, tol = ((LOSS_REL, PARAM_ABS) if against == "plain"
                else (REF_REL, REF_PARAM_ABS))
    np.testing.assert_allclose(got["losses"], exp["losses"], rtol=rel)
    assert len(got["loads"]) == len(exp["loads"])
    for a, b in zip(got["loads"], exp["loads"]):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64)), (a, b)
    if against == "plain":
        grads = dict(tree_items(got["grads"]))
        for k, g in tree_items(plain["grads"]):
            assert max_rel(grads[k], g) <= GRAD_REL, k
        for key in ("logits0", "k0", "hidden0"):
            assert max_rel(got[key], exp[key]) <= LOGITS_REL, key
        worst, share = held_param_diff(got["params"], plain)
        assert worst <= tol and share >= HELD_SHARE, (worst, share)
        again = prefill_of(got["params"], name)
        for key in ("logits", "k", "hidden"):
            assert got[key].shape == again[key].shape
            assert max_rel(got[key], again[key]) <= LOGITS_REL, key
    else:
        assert max_param_diff(got["params"], exp["params"]) <= tol
        for key in ("logits", "k"):
            assert got[key].shape == exp[key].shape
            assert max_rel(got[key], exp[key]) <= REF_REL, key
    if CASES[name][0] is MOE:
        pl = got["placements"]
        data = "Shard(dim=2), " * (len(CASES[name][1]) - 1)
        assert pl["we_gate"] == f"({data}Shard(dim=3))"
        assert pl["we_down"] == "(" + "Shard(dim=3), " * (
            len(CASES[name][1]) - 1) + "Shard(dim=2))"
        assert pl["router"].startswith("(Shard(dim=1)")


def margins(probs, k, tokens):
    """The router's margin of each token: its k-th largest probability
    less its (k+1)-th."""
    top = torch.sort(probs[tokens], dim=-1, descending=True).values
    return (top[:, k - 1] - top[:, k]).tolist()


@pytest.mark.parametrize("name", MOE_CASES)
def test_routing_and_kept_pairs_equal(jobs, name):
    """The prefill from the start parameters: every token's top-k experts
    (the choice, in order) and each layer's kept (token, expert) pairs
    equal exactly to the unsharded port's at the same groups; a choice
    that differs is reported with the router's margin of its token (a
    near-tie that rounding flips)."""
    got = mesh_out(jobs, name)["routing"]
    exp = want(jobs, name, "plain")["routing"]
    k = MOE["experts_per_token"]
    for layer, (a, b) in enumerate(zip(got["choice"], exp["choice"])):
        bad = torch.nonzero((a != b).any(-1))[:, 0]
        assert not len(bad), (
            f"layer {layer}: tokens {bad.tolist()} routed otherwise, "
            f"router margins {margins(exp['probs'][layer], k, bad)}")
    for layer, (a, b) in enumerate(zip(got["kept"], exp["kept"])):
        assert torch.equal(a, b), f"layer {layer}: kept pairs differ"
    # every group drops pairs at capacity factor 1: the capacity rule and
    # the spanning group's order are exercised
    assert all(len(k_) < B * S * k for k_ in exp["kept"])


def test_spanning_group_reruns_bit_equal(jobs):
    """The 2x2 mesh's G = 1 case (one group over both data ranks: its
    rows moved by all-to-all, the gradients back by the reverse one, the
    block checkpointed and recomputed) run twice: losses, gradients,
    parameters, logits and hidden states bit-equal."""
    a, b = mesh_out(jobs, "g1"), mesh_out(jobs, "g1+rerun")
    assert a["losses"] == b["losses"]
    for key in ("params", "grads"):
        y = dict(tree_items(b[key]))
        for k_, x in tree_items(a[key]):
            assert torch.equal(x, y[k_]), (key, k_)
    for key in ("logits", "k", "hidden", "logits0", "hidden0"):
        assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# (b) the count on a (2, 2, 2) mesh
# ---------------------------------------------------------------------------

def test_moe_flops_per_device_near_the_reference(jobs):
    """Rank 0's count of the tiny MoE's train step at COUNT_GROUPS groups
    on (2, 2, 2) within 25 % (``FLOPS_RATIO``) of the reference's step
    compiled for eight forced host devices with the same groups, walked by
    its ``hlo_analysis``; the experts' FSDP gathers and gradients'
    reduce-scatters on ``pod, data``, the expert_load's sums all-reduced
    there."""
    ref, = jobs["ref8"].lines("REF")
    count = jobs["count8"]
    ratio = count["costs"].flops / ref["flops"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], (ratio, ref["flops"])
    fsdp = count["collectives"]["pod,data"]
    assert fsdp["all-gather"]["calls"] > 0
    assert fsdp["reduce-scatter"]["calls"] > 0
    assert fsdp["all-reduce"]["calls"] > 0
    assert count["costs"].kernels["rmsnorm"]["launches"] > 0


def test_spanning_group_counts_its_all_to_all():
    """Rank 0's count of the tiny MoE's train step on (2, 2, 2) with one
    group (spanning the four data ranks): its rows move by all-to-all
    over a group of 4 at their upper bound, min(T_rank * k, E * ceil(C /
    4)) rows each way, twice in the forward, twice in the backward and
    twice in each block's recompute."""
    cfg = ModelConfig(**MOE)
    c = dryrun.mesh_count(cfg, TRAIN, MESH8, moe_groups=1)
    T_rank = TRAIN.global_batch * TRAIN.seq_len // 4
    k, E = cfg.experts_per_token, cfg.n_experts
    C = int(cfg.capacity_factor * k * T_rank * 4 / E)
    rows = min(T_rank * k, E * -(-C // 4))
    a2a = c["costs"].coll_groups
    calls = sum(v[0] for (kind, _), v in a2a.items() if kind == "all-to-all")
    result = sum(v[2] for (kind, _), v in a2a.items() if kind == "all-to-all")
    passes = 3 * cfg.n_layers                  # forward, recompute, backward
    assert calls == 2 * passes
    assert result == 2 * passes * rows * cfg.d_model * 4
    assert c["costs"].coll["all-to-all"] == 3 / 4 * result


# ---------------------------------------------------------------------------
# (c) the regimes' edges
# ---------------------------------------------------------------------------

def test_groups_that_neither_divide_raise_and_groups_are_laid_out():
    """Rank 0 of a 2x2 fake group: 3 groups over 2 data ranks raise
    ``NotImplementedError`` naming both; ``constrain_tokens_grouped`` lays
    4 groups over ``data`` (replicated over ``model``) and leaves 3 as
    they are; the stack's checks admit the MoE family and M-RoPE and
    still refuse the SSM, hybrid and enc-dec families."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import device_mesh, fake_world
    from repro_torch.models.layers import moe_block
    from repro_torch.models.model import _check_sharded
    with fake_world(4):
        mesh = device_mesh(AbstractMesh(("data", "model"), (2, 2)), "cpu")
        d = lambda t, pl: distribute_tensor(  # noqa: E731
            t, mesh, pl, src_data_rank=None)
        x = d(torch.zeros(12, 8, device="meta"), [Shard(0), Replicate()])
        w = [d(torch.zeros(s, device="meta"), [Replicate(), Replicate()])
             for s in ((8, 4), (4, 8, 6), (4, 8, 6), (4, 6, 8))]
        with pytest.raises(NotImplementedError, match="3 MoE groups over 2"):
            moe_block(x, *w, k=2, groups=3)
        g4 = ctx.constrain_tokens_grouped(
            d(torch.zeros(4, 3, 8, device="meta"), [Replicate(), Shard(1)]))
        assert g4.placements == (Shard(0), Replicate())
        g3 = d(torch.zeros(3, 4, 8, device="meta"), [Replicate(), Shard(1)])
        assert ctx.constrain_tokens_grouped(g3) is g3
    for cfg in (ModelConfig(**MOE), ModelConfig(**VL)):
        _check_sharded(cfg, 8, None)
    for family in ("ssm", "hybrid", "encdec"):
        with pytest.raises(NotImplementedError):
            _check_sharded(dataclasses.replace(ModelConfig(**MOE),
                                               family=family), 8, None)
