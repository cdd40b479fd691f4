"""The shape stand-ins of ``repro_torch.launch.steps`` against the
reference's, on the CPU: ``params_shape``, ``opt_shape`` and
``input_specs`` of every arch (and every applicable input-shape cell)
have the keys, shapes and dtypes of the reference's ``jax.eval_shape``
trees, and hold no memory: the parameter and AdamW trees are tensors on
the ``meta`` device, the inputs and the decode cache ``TensorSpec``
records.  The port's parameter names are the reference's
(``repro_torch.convert`` carries them over unchanged)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES,  # noqa: E402
                                 ShapeConfig, applicable)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.optim import AdamWConfig, tree_items  # noqa: E402

CELLS = [pytest.param(arch, name, id=f"{arch}-{name}")
         for arch in ARCH_NAMES for name in SHAPES
         if applicable(get_config(arch), SHAPES[name])[0]]


def _ref_leaves(tree):
    """{key path: (shape, dtype name)} of a reference stand-in tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "name", None))
                    for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree, meta=True):
    """{key path: (shape, dtype name)} of a port stand-in tree: tensors
    on the meta device (``meta``) or TensorSpec records, nested in dicts."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
            return
        if meta:
            assert isinstance(node, torch.Tensor) and node.is_meta, prefix
        else:
            assert isinstance(node, TS.TensorSpec), prefix
        out[prefix] = (tuple(node.shape), str(node.dtype).split(".")[-1])
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_and_opt_shape_match_eval_shape(arch):
    """The parameter tree and the AdamW state (step, m, v in the config's
    moment dtype) of the full config, leaf for leaf, on ``meta``."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    ps = TS.params_shape(cfg)
    assert _port_leaves(ps) == _ref_leaves(JS.params_shape(jcfg))
    jopt = JS.opt_shape(jcfg, JAdamWConfig(moment_dtype=jcfg.moment_dtype))
    opt = TS.opt_shape(cfg, AdamWConfig(moment_dtype=cfg.moment_dtype))
    for field in ("m", "v"):
        assert (_port_leaves(getattr(opt, field))
                == _ref_leaves(getattr(jopt, field)))
    assert _port_leaves({"step": opt.step}) == _ref_leaves(
        {"step": jopt.step})
    assert sum(t.numel() for _, t in tree_items(ps)) > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_eval_shape(arch, shape):
    """Every applicable (arch x shape) cell's model inputs: train and
    prefill tokens (and labels), the enc-dec family's embeds in the
    parameters' dtype, decode's token and its cache."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    want = _ref_leaves(JS.input_specs(jcfg, J_SHAPES[shape]))
    got = _port_leaves(TS.input_specs(cfg, SHAPES[shape]), meta=False)
    assert got == want
    assert (("embeds",) in got) == (cfg.family == "encdec"
                                    and SHAPES[shape].kind != "decode")


def test_stand_ins_hold_no_memory():
    """The largest arch's stand-ins (grok-1-314b: 316e9 parameters, 633
    GB in bf16, and 2.5 TB of float32 moments) take no storage: every
    leaf is on ``meta``, whose tensors have no data, and an unknown cell
    kind raises."""
    cfg = get_config("grok-1-314b")
    opt = TS.opt_shape(cfg, AdamWConfig(moment_dtype=cfg.moment_dtype))
    leaves = [t for tree in (TS.params_shape(cfg), opt.m, opt.v)
              for _, t in tree_items(tree)] + [opt.step]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 3 * 316e9
    with pytest.raises(ValueError):
        TS.input_specs(cfg, ShapeConfig("x", "score", 8, 1))
