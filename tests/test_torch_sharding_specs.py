"""The model stack's sharding specs (``repro_torch.distributed.sharding``)
and the dry run's per-device records (``launch.dryrun.mesh_cell``)
against the reference's specs, on the CPU.

The reference's specs run on ``jax.sharding.AbstractMesh`` at the
production layouts, 16x16 ``data, model`` and 2x16x16 ``pod, data,
model``, with no devices.  Held against them: ``fit_spec`` on a grid of
divisible and indivisible dims and tuple entries; ``param_specs`` of all
ten archs on both meshes with and without FSDP, ``opt_specs``,
``batch_specs`` and ``cache_specs``, leaf by leaf by key path; and each
applicable cell's per-device argument and output bytes, equal to the sum
of ``NamedSharding(AbstractMesh, spec).shard_shape`` bytes over the
reference's trees with the shardings its dry run compiles with.
``shard_slices`` is held against ``NamedSharding.devices_indices_map``
on a (2, 2, 2) mesh of eight forced host devices, in a subprocess;
``named``'s placements against DTensor's own local shapes and offsets.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES,  # noqa: E402
                                 applicable, get_config)
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.mesh import production_mesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

MESHES = {False: "16x16", True: "2x16x16"}
J_MESHES = {False: JMesh((16, 16), ("data", "model")),
            True: JMesh((2, 16, 16), ("pod", "data", "model"))}
CELLS = [pytest.param(arch, name, id=f"{arch}-{name}")
         for arch in ARCH_NAMES for name in SHAPES
         if applicable(get_config(arch), SHAPES[name])[0]]
MESH_IDS = [pytest.param(mp, id=MESHES[mp]) for mp in MESHES]


@functools.lru_cache(maxsize=None)
def j_params(arch):
    return JS.params_shape(j_get_config(arch))


@functools.lru_cache(maxsize=None)
def t_params(arch):
    return TS.params_shape(get_config(arch))


def norm(spec):
    """A spec as a plain tuple, trailing ``None`` entries trimmed (they
    mean what no entry means)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def flat(tree, path=()):
    """{key path: leaf} of nested dicts and named tuples of specs or
    stand-ins (the reference's and the port's alike)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, path + (k,)))
    return out


def same_specs(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    bad = {k: (g[k], w[k]) for k in w if tuple(g[k]) != norm(w[k])}
    assert not bad
    assert all(isinstance(s, SH.Spec) for s in g.values())


# ---------------------------------------------------------------------------
# the meshes and fit_spec
# ---------------------------------------------------------------------------

def test_production_mesh_and_data_axes():
    """The two layouts' names and sizes (``make_production_mesh``'s), the
    data axes on each, and a campaign mesh's data axes unchanged."""
    for mp, want in J_MESHES.items():
        m = production_mesh(multi_pod=mp)
        assert m.axis_names == tuple(want.axis_names)
        assert dict(m.shape) == dict(want.shape)
        assert m.size == want.size == (512 if mp else 256)
        assert len(list(m.coords())) == m.size
        assert SH.data_axes(m) == JSH.data_axes(want)
        with pytest.raises(TypeError):
            m.shape["data"] = 1
    assert SH.data_axes([torch.device("cpu")] * 4) == ("data",)
    assert SH.lane_spec([torch.device("cpu")] * 2) == ("data",)
    with pytest.raises(ValueError):
        AbstractMesh(("data",), (2, 2))


FIT_CASES = [
    # (spec entries, shape); "pod" cases run on the pair of pods only
    (("data", "model"), (32, 48)),
    (("data", "model"), (8, 48)),
    (("model", "data"), (51865, 768)),
    (("data", None, "model"), (16, 3, 51865)),
    ((None, "data", "model", None, None), (12, 32, 1500, 12, 64)),
    ((None, "data", "model", None, None), (12, 1, 524288, 8, 128)),
    (("model",), (12,)),
    ((("data", "model"),), (256,)),
    ((("data", "model"),), (16,)),
    ((("data", "model"),), (24,)),
    ((None, None), (4, 4)),
    (("data", None, None), (64, 5, 7)),
    ((), (5, 7)),
    (("data", "model"), (1, 1)),
    ((("pod", "data"), "model"), (64, 32)),
    ((("pod", "data"), "model"), (16, 32)),
    ((("pod", "data"), None), (8, 32)),
    ((("pod", "data"),), (2,)),
    ((("pod", "data", "model"),), (512,)),
    ((("pod", "data", "model"),), (256,)),
    ((("pod", "data", "model"),), (16,)),
    ((("pod", "data", "model"),), (6,)),
    ((None, ("pod", "data"), "model", None, None), (64, 128, 32768, 8, 128)),
    ((None, ("pod", "data"), "model", None, None), (64, 16, 1500, 8, 128)),
]


def _names(entries):
    return {a for e in entries if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


@pytest.mark.parametrize("entries,shape,mp", [
    pytest.param(e, s, mp, id=f"{e}-{s}-{MESHES[mp]}")
    for e, s in FIT_CASES for mp in MESHES
    if mp or "pod" not in _names(e)])
def test_fit_spec_matches_reference(entries, shape, mp):
    """``fit_spec``: divisible dims kept, indivisible ones dropped, tuple
    entries reduced one axis at a time (the major axis first), trailing
    ``None``s trimmed; and the shard shape of the fitted spec, the
    reference's ``NamedSharding`` shard shape."""
    jm, m = J_MESHES[mp], production_mesh(multi_pod=mp)
    want = JSH.fit_spec(P(*entries), shape, jm)
    got = SH.fit_spec(SH.Spec(*entries), shape, m)
    assert isinstance(got, SH.Spec) and tuple(got) == norm(want)
    assert SH.shard_shape(got, shape, m) == tuple(
        NamedSharding(jm, want).shard_shape(shape))


def test_spec_type():
    """A spec trims trailing ``None``s, compares as a tuple, survives
    pickling, and ``shard_shape`` refuses an axis that does not divide its
    dim or a spec longer than the shape."""
    import pickle
    m = production_mesh()
    s = SH.Spec("data", None, ("data", "model"), None)
    assert tuple(s) == ("data", None, ("data", "model"))
    assert pickle.loads(pickle.dumps(s)) == s
    assert SH.Spec(None, None) == SH.Spec() == ()
    assert SH.shard_shape(SH.Spec("data"), (32, 3), m) == (2, 3)
    with pytest.raises(ValueError):
        SH.shard_shape(SH.Spec("data"), (24,), m)
    with pytest.raises(ValueError):
        SH.shard_shape(SH.Spec("data", "model"), (32,), m)


# ---------------------------------------------------------------------------
# the spec trees, leaf by leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mp", MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, mp, fsdp):
    """Every parameter leaf's spec, by key path: the name table, the stack
    dims' lift (none for ``embed`` and ``lm_head``), the expert tensors'
    (L, E, D, F) / (L, E, F, D) layout, and ``fit_spec``'s drops."""
    cfg = get_config(arch)
    got = SH.param_specs(cfg, production_mesh(multi_pod=mp), t_params(arch),
                         fsdp=fsdp)
    want = JSH.param_specs(j_get_config(arch), J_MESHES[mp], j_params(arch),
                           fsdp=fsdp)
    same_specs(got, want)
    raw = SH.param_specs(cfg, production_mesh(multi_pod=mp), t_params(arch),
                         fsdp=fsdp, fit=False)
    assert flat(raw).keys() == flat(got).keys()


@pytest.mark.parametrize("mp", MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_and_batch_specs_match_reference(arch, mp):
    """``opt_specs``: the port's ``AdamWState`` of the parameters' specs,
    the step replicated; ``batch_specs``, the audio frontend's embeds
    included."""
    jm, m = J_MESHES[mp], production_mesh(multi_pod=mp)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    pspec = SH.param_specs(cfg, m, t_params(arch))
    got = SH.opt_specs(pspec)
    want = JSH.opt_specs(JSH.param_specs(jcfg, jm, j_params(arch)))
    assert type(got).__name__ == "AdamWState" and got._fields == (
        "step", "m", "v")
    same_specs(got, want)
    same_specs(SH.batch_specs(cfg, m), JSH.batch_specs(jcfg, jm))


def ref_cache(arch, shape_name):
    """The reference's cache tree of a cell: the prefill step's output
    cache (``jax.eval_shape``), or the decode kind's input cache."""
    jcfg, shape = j_get_config(arch), J_SHAPES[shape_name]
    ispec = JS.input_specs(jcfg, shape)
    if shape.kind == "decode":
        return ispec["cache"]
    return jax.eval_shape(JS.make_prefill_step(jcfg), j_params(arch),
                          ispec)[1]


def port_cache(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if shape.kind == "decode":
        return TS.input_specs(cfg, shape)["cache"]
    return TS.decode_cache_specs(cfg, shape.global_batch, shape.seq_len)


SERVE_CELLS = [c for c in CELLS if c.values[1] in ("prefill_32k",
                                                    "decode_32k")]


@pytest.mark.parametrize("mp", MESH_IDS)
@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_cache_specs_match_reference(arch, shape, mp):
    """Every ``prefill_32k`` and ``decode_32k`` cell's caches: the shapes
    equal the reference's (the hybrid family's attention cache has
    ``n_layers // attn_every`` layers), and so do their specs: k, v, xk,
    xv sequence over ``model``, conv channels and state heads over
    ``model``, ``len`` replicated."""
    want_tree = ref_cache(arch, shape)
    got_tree = port_cache(arch, shape)
    assert {k: tuple(v.shape) for k, v in got_tree.items()} == {
        k: tuple(v.shape) for k, v in want_tree.items()}
    got = SH.cache_specs(get_config(arch), production_mesh(multi_pod=mp),
                         got_tree)
    want = JSH.cache_specs(j_get_config(arch), J_MESHES[mp], want_tree)
    same_specs(got, want)


# ---------------------------------------------------------------------------
# per-device bytes of every cell
# ---------------------------------------------------------------------------

def ref_bytes(tree, spec_tree, jm):
    """The bytes one device holds: the reference's shard shapes summed."""
    leaves = flat(tree)
    specs = flat(spec_tree)
    assert leaves.keys() == specs.keys()
    return sum(int(np.prod(NamedSharding(jm, specs[k]).shard_shape(
        tuple(leaves[k].shape)))) * np.dtype(leaves[k].dtype).itemsize
        for k in leaves)


def ref_cell_bytes(arch, shape_name, mp, fsdp=True):
    """Per-device argument and output bytes of the reference's dry run's
    shardings (``repro.launch.dryrun.run_cell``'s ``in_shardings`` and
    ``out_shardings``), by part, with no compile."""
    jcfg, shape, jm = j_get_config(arch), J_SHAPES[shape_name], J_MESHES[mp]
    pshape = j_params(arch)
    pspec = JSH.param_specs(jcfg, jm, pshape, fsdp=fsdp)
    dp = JSH.data_axes(jm)
    dp = dp if len(dp) > 1 else dp[0]
    ispec = JS.input_specs(jcfg, shape)
    args = {"params": ref_bytes(pshape, pspec, jm)}
    if shape.kind == "train":
        oshape = JS.opt_shape(jcfg, JAdamWConfig(moment_dtype=jcfg.moment_dtype))
        ospec = JSH.opt_specs(pspec)
        args["optimizer"] = ref_bytes(oshape, ospec, jm)
        args["inputs"] = ref_bytes(ispec, JSH.batch_specs(jcfg, jm), jm)
        return args, {"params": args["params"],
                      "optimizer": args["optimizer"]}
    B, V = shape.global_batch, jcfg.vocab_size
    if shape.kind == "prefill":
        bspec = {k: v for k, v in JSH.batch_specs(jcfg, jm).items()
                 if k != "labels"}
        args["inputs"] = ref_bytes(ispec, bspec, jm)
        logits, cache = jax.eval_shape(JS.make_prefill_step(jcfg), pshape,
                                       ispec)
        lg_spec = JSH.fit_spec(P(dp, "model"), (B, V), jm)
    else:
        cspec = JSH.cache_specs(jcfg, jm, ispec["cache"])
        tok_spec = JSH.fit_spec(P(dp), (B,), jm)
        args["inputs"] = ref_bytes(ispec, {"cache": cspec,
                                           "token": tok_spec}, jm)
        logits, cache = jax.eval_shape(JS.make_serve_step(jcfg), pshape,
                                       ispec["cache"], ispec["token"])
        lg_spec = JSH.fit_spec(
            P(tok_spec[0] if len(tok_spec) else None, "model"), (B, V), jm)
    cspec = JSH.cache_specs(jcfg, jm, cache)
    return args, {"logits": ref_bytes({"x": logits}, {"x": lg_spec}, jm),
                  "cache": ref_bytes(cache, cspec, jm)}


@pytest.mark.parametrize("mp", MESH_IDS)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_mesh_cell_bytes_match_reference(arch, shape, mp):
    """Each applicable cell's per-device argument bytes (parameters,
    optimizer state, inputs) and output bytes (parameters and optimizer
    state; or logits and caches) equal the reference's, part by part."""
    rec = dryrun.mesh_cell(arch, shape, mp, params=t_params(arch))
    want_args, want_outs = ref_cell_bytes(arch, shape, mp)
    mem = rec["memory"]
    assert mem["argument_bytes_by"] == want_args
    assert mem["output_bytes_by"] == want_outs
    assert mem["argument_bytes"] == sum(want_args.values())
    assert mem["output_bytes"] == sum(want_outs.values())
    assert rec["arguments_fit_80gb"] == (mem["argument_bytes"] <= 80e9)
    assert rec["devices"] == (512 if mp else 256)


@pytest.mark.parametrize("mp", MESH_IDS)
def test_no_fsdp_bytes_match_reference(mp):
    """Without FSDP the weights and moments stay whole on the data axes:
    grok-1-314b's ``train_4k`` against the reference's, and above the
    card."""
    rec = dryrun.mesh_cell("grok-1-314b", "train_4k", mp, fsdp=False,
                           params=t_params("grok-1-314b"))
    want_args, _ = ref_cell_bytes("grok-1-314b", "train_4k", mp, fsdp=False)
    assert rec["memory"]["argument_bytes_by"] == want_args
    assert not rec["fsdp"] and not rec["arguments_fit_80gb"]


def test_grok_train_per_device_gb():
    """grok-1-314b ``train_4k``: 1,898.9 GB of state on one device (the
    one-card count), 7.424 GB a device on 16x16 (2.475 parameters, 4.949
    bf16 moments, 0.0005 batch) and 3.714 GB on 2x16x16."""
    got = {mp: dryrun.mesh_cell("grok-1-314b", "train_4k", mp,
                                params=t_params("grok-1-314b"))["memory"]
           for mp in MESHES}
    assert round(got[False]["argument_bytes"] / 1e9, 3) == 7.424
    assert round(got[True]["argument_bytes"] / 1e9, 3) == 3.714
    by = {k: round(v / 1e9, 4) for k, v in
          got[False]["argument_bytes_by"].items()}
    assert by == {"params": 2.4745, "optimizer": 4.949, "inputs": 0.0005}


# ---------------------------------------------------------------------------
# placements, slices and the dry run's records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_named_placements_give_shard_shapes(arch, mp):
    """``named``: each leaf's ``torch.distributed.tensor`` placements give,
    by DTensor's own rule on a device's coordinate, the local shape
    ``shard_shape`` gives and the offset where ``shard_slices`` starts."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset as local_shape_and_offset)
    m = production_mesh(multi_pod=mp)
    params = t_params(arch)
    pspec = SH.param_specs(get_config(arch), m, params)
    placed = SH.named(m, pspec)
    rng = np.random.default_rng(0)
    coords = [(0,) * len(m.axis_sizes), tuple(n - 1 for n in m.axis_sizes),
              tuple(int(rng.integers(n)) for n in m.axis_sizes)]
    leaves, specs, pl = flat(params), flat(pspec), flat(placed)
    for k, leaf in leaves.items():
        assert len(pl[k]) == len(m.axis_names)
        assert all(isinstance(p, (Shard, Replicate)) for p in pl[k])
        shape = tuple(leaf.shape)
        for c in coords:
            local, offset = local_shape_and_offset(shape, m.axis_sizes,
                                                   list(c), pl[k])
            assert tuple(local) == SH.shard_shape(specs[k], shape, m), k
            assert tuple(offset) == tuple(
                s.start for s in SH.shard_slices(specs[k], shape, m, c)), k


def test_named_refuses_an_order_dtensor_cannot_give():
    """A dim split over axes listed against the mesh's order, or one axis
    named twice, has no plain ``Shard`` placements."""
    m = production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        SH.placements(SH.Spec(("data", "pod")), m)
    with pytest.raises(ValueError):
        SH.placements(SH.Spec("data", "data"), m)


SLICES_SCRIPT = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro_torch.distributed.sharding import Spec, shard_slices
from repro_torch.launch.mesh import AbstractMesh

devs = np.asarray(jax.devices()[:8], dtype=object).reshape(2, 2, 2)
mesh = Mesh(devs, ("pod", "data", "model"))
am = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
cases = json.loads(sys.argv[1])
bad, n = [], 0
for entries, shape in cases:
    entries = [tuple(e) if isinstance(e, list) else e for e in entries]
    want = NamedSharding(mesh, P(*entries)).devices_indices_map(tuple(shape))
    for coord in am.coords():
        idx = want[devs[coord]]
        w = [s.indices(d)[:2] for s, d in zip(idx, shape)]
        got = shard_slices(Spec(*entries), tuple(shape), am, coord)
        g = [(s.start, s.stop) for s in got]
        n += 1
        if g != w:
            bad.append((entries, shape, coord, g, w))
print("SLICES", n, json.dumps(bad))
"""

SLICE_CASES = [
    [[["pod", "data"], "model"], [8, 6]],
    [["model", ["pod", "data"]], [4, 12]],
    [[None, ["pod", "data", "model"]], [3, 16]],
    [[["data", "model"]], [8]],
    [[["pod", "model"], None, "data"], [4, 5, 6]],
    [["pod"], [6, 2]],
    [[], [3, 5]],
    [[None, "data", "model", None, None], [2, 4, 8, 3, 2]],
]


def test_shard_slices_match_devices_indices_map():
    """On a (2, 2, 2) ``pod, data, model`` mesh of eight forced host
    devices, every device's index ranges for tuple entries (major to
    minor in the tuple's order), single axes and replicated dims equal
    ``NamedSharding(...).devices_indices_map``'s."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", SLICES_SCRIPT, json.dumps(SLICE_CASES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SLICES")]
    assert line, proc.stdout + proc.stderr
    _, n, bad = line[0].split(" ", 2)
    assert int(n) == 8 * len(SLICE_CASES)
    assert json.loads(bad) == []


def test_shard_slices_tile_a_leaf():
    """The distinct shards of a leaf tile it once: reassembled from every
    device's slices of 2x16x16 they give the leaf back, and devices that
    differ only on a replicated axis hold the same slices."""
    m = production_mesh(multi_pod=True)
    spec, shape = SH.Spec(None, ("pod", "data"), "model"), (3, 64, 32)
    x = torch.arange(np.prod(shape)).reshape(shape)
    out = torch.full(shape, -1)
    seen = {}
    for c in m.coords():
        sl = SH.shard_slices(spec, shape, m, c)
        assert x[sl].shape == SH.shard_shape(spec, shape, m)
        seen.setdefault(sl, []).append(c)
        out[sl] = x[sl]
    assert torch.equal(out, x)
    assert len(seen) == 32 * 16
    assert all(len(cs) == 1 for cs in seen.values())
    spec = SH.Spec(None, "data")
    groups = {}
    for c in m.coords():
        groups.setdefault(SH.shard_slices(spec, shape, m, c), set()).add(c[1])
    assert len(groups) == 16 and all(len(v) == 1 for v in groups.values())
    with pytest.raises(ValueError):
        SH.shard_slices(spec, shape, m, (2, 0, 0))


RECORD_KEYS = {"arch", "shape", "mesh", "devices", "fsdp", "moe_groups",
               "flops_per_device", "bytes_per_device", "memory",
               "arguments_fit_80gb", "unsharded", "not_counted", "n_params",
               "active_params", "tree_params"}


@pytest.mark.parametrize("arch,shape", [
    ("grok-1-314b", "decode_32k"), ("qwen3-32b", "decode_32k"),
    ("whisper-small", "prefill_32k"), ("zamba2-7b", "long_500k"),
    ("olmoe-1b-7b", "decode_32k"), ("llama3.2-3b", "long_500k")])
def test_dryrun_main_mesh_both(arch, shape, tmp_path, capsys):
    """``dryrun.main --mesh both`` writes two records, 16x16 then
    2x16x16, with the reference's keys and the port's; what is not
    counted is ``null``; an inapplicable cell is ``skipped`` on both.
    The cells are ones whose partitioned step is not counted (the MoE
    family's train and prefill are, once a run, in
    ``tests/test_torch_dtensor.py``)."""
    out = tmp_path / "d.json"
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                 "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == recs
    if not applicable(get_config(arch), SHAPES[shape])[0]:
        assert all("skipped" in r for r in recs)
        return
    for r, n in zip(recs, (256, 512)):
        assert set(r) == RECORD_KEYS
        assert r["devices"] == n and r["fsdp"] is True
        assert r["flops_per_device"] is None and r["bytes_per_device"] is None
        mem = r["memory"]
        assert mem["temp_bytes"] is None and mem["peak_bytes"] is None
        assert set(mem["argument_bytes_by"]) == (
            {"params", "optimizer", "inputs"} if shape == "train_4k"
            else {"params", "inputs"})
        assert "partition" in r["not_counted"]
        assert r["tree_params"] == sum(
            t.numel() for t in flat(t_params(arch)).values())
        assert all(set(u) == {"leaf", "dim", "axis"} for u in r["unsharded"])
    assert recs[1]["memory"]["argument_bytes"] < recs[0]["memory"][
        "argument_bytes"]
    assert recs[0]["moe_groups"] == dryrun.TUNED_PLANS.get(
        (arch, shape), {}).get("moe_groups", 1)
    if (arch, shape) == ("zamba2-7b", "long_500k"):
        # batch 1: the data axes are dropped from the token, caches, logits
        dropped = {(u["leaf"], u["axis"]) for u in recs[1]["unsharded"]}
        assert {("token", "pod"), ("token", "data"), ("cache/k", "pod"),
                ("logits", "data")} <= dropped


def test_whisper_drops_model_on_its_odd_dims():
    """whisper-small's 1,500 encoder frames and vocabulary of 51,865 do
    not split over 16: ``unsharded`` names the cross caches' sequence
    and the logits' vocabulary."""
    rec = dryrun.mesh_cell("whisper-small", "decode_32k", False,
                           params=t_params("whisper-small"))
    assert {(u["leaf"], u["dim"], u["axis"]) for u in rec["unsharded"]} == {
        ("cache/xk", 2, "model"), ("cache/xv", 2, "model"),
        ("logits", 1, "model")}
